#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (triton_dist_tpu_torch) on one
NVIDIA card: the quickest proof that the port still starts on the GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from kernels/csrc/ (one
   torch.utils.cpp_extension.load of every source and the binding, into
   build/torch_ext/) and prints the build seconds.
3. Kernel phase: at the shapes of the main path (Qwen3-1.7B, B=128,
   S=128; the serving tick's B=128 slots with seeded mixed lengths in
   [1, 264] for flash_decode_paged and flash_decode with per-row
   kv_lens), holds each kernel against its plain PyTorch version on the
   same inputs, with the tolerance stated, and times the kernel, the
   plain version and one PyTorch library call of the same function
   (where there is one) with CUDA events. bound_ms is the larger of
   bytes / HBM rate and flops / bf16 peak, from the H100 SXM data
   sheet, counting the bytes this run's lengths need. The q_lens window
   forms of flash_decode and flash_decode_paged (speculative verify and
   chunked prefill), bf16 and int8: B=16 slots with 5-position windows
   and q_lens in [0, 5], and B=7 with one 32-token prompt chunk and six
   decode rows, kv_lens up to 400; paged bf16 at the mixed ticks of the
   serving workload at prefill_budget 64 (B=64, S=64) and of the MoE arm
   (B=4, S=32, 32 query and 4 kv heads), kv_lens up to the serving
   capacity; keys past each row's length at 100x, valid positions held
   to the plain version, padding positions finite; the library time is
   SDPA with each position's boolean mask.
4. Engine phases, bf16 then int8 (quantize_int8 weights and an int8 KV
   cache): Qwen3-1.7B at full width (28 layers, random weights from a
   seeded torch.Generator), Engine(backend="flash") prefill and decode.
   Launch counts are reset just before prefill and before decode and
   read just after each; every kernel of that path (flash_decode,
   kv_update, swiglu) must have run in both. The logits
   are then checked, teacher-forced, against the plain ("xla") backend.
   The same on Engine(backend="dist") at one rank, bf16 and int8, where
   every projection is the one-rank ag_gemm/gemm_rs (the GEMM kernel,
   with int8 QuantW panels in int8): exactly four gemm launches a layer
   and forward; its kernel rows 14c-14d and 15e-15f (gemm at the decode
   step's four projections, bf16 and int8 panels) come with the kernel
   phase.
5. Serving phases: the same model through ContinuousScheduler
   (Engine(backend="flash")), 128 seeded requests over 64 slots, chunk
   16: four 96-token system prompts, each shared by 32 requests, with
   distinct 16-48-token tails and 32-64-token budgets. The paged
   scheduler with the radix prefix cache (page 16) in bf16 and int8,
   then the contiguous scheduler in bf16. Launch counts are reset just
   before each run and read just after; every kernel of the path must
   have run, and the paged runs must hit the prefix cache. Tokens of 8
   seeded-chosen requests are held, teacher-forced, against the plain
   ("xla") contiguous engine. A tick probe then runs one bare tick under
   torch.cuda.set_sync_debug_mode("error") (a tick that synchronises
   with the host fails) and one of PROFILE_STEPS (4) steps under
   torch.profiler (the idle share).
6. Megakernel phases (backend="mega", one persistent CUDA kernel per
   decode layer): rows 5a (mega_decode, B=128, pos=200, T=264), 5c (its
   tensor-parallel form, mega_decode_tp: 5a's inputs split over four ranks
   emulated on the card, D=2048, F/4=1536, Hq/4=4, Hkv/4=2; within
   tools/tp_check.py MEGA_TP_LIMIT of its plain version, every rank's y
   bitwise equal, timed beside the per-op "gemm_ar" layer on the same
   shards; its launches are the tp=4 mega engine's of 11.) and 6a/6b
   (mega_paged_decode, 64 slots at lengths in [1, 224], page 16, bf16 and
   int8 pools, two retired slots on the trash page), each held against
   its plain version with the cache past each length, unmapped pages and
   the trash page poisoned with 100x values, and timed beside the port's
   per-op flash layer (layers/tp_attn.py + tp_mlp.py) on the same inputs;
   the engine phase on "mega" (bf16: prefill on flash, 32 decode steps of
   28 megakernel launches each, teacher-forced against the plain backend,
   profiled); the paged serving phases on "mega" (bf16 and int8 KV, the
   same 128 requests), with their tick probes. Launch checks: exactly 28
   megakernel launches per decode step and per tick step, no
   flash_decode_paged or swiglu launch inside a mega tick, flash_decode
   and kv_update launched only by the admissions.
7. Window phases (Qwen3-1.7B, bf16 unless named). Speculative decoding
   (bench.py:396-430): 16 requests, each prompt its own seeded 4-token
   pattern tiled 16 times plus 2, 64 tokens each (96 in bench.py), ContinuousScheduler
   with spec=4 and chunk 4, contiguous and paged, with the n-gram
   drafter, one that proposes the spec=0 run's tokens and one that is
   always wrong, beside spec=0: exact launch counts, tokens per verify
   forward, accept rate, tok/s, ms per verify tick. Then the verify
   program itself, teacher-forced along the served streams of each form:
   windows of the streams' own tokens (seeded lengths, about half with
   one draft replaced so that it is rejected and rolled back) through
   slot_verify_chunk / paged_slot_verify_chunk, the window logits at
   every position held to the plain engine at 5e-2 of its largest logit,
   the kept counts and next seeds to the plain engine's where their
   margins decide them. Chunked prefill
   (bench.py:498-560): 6 live requests (16-token prompts, 96 tokens; 192
   in bench.py) decoding at chunk 2 when a 384-token prompt (8 tokens
   asked) arrives:
   its TTFT and the live streams' inter-token gaps until then,
   prefill_budget 32 against monolithic admissions, paged and contiguous
   in bf16 and int8 (int8 weights and KV; contiguous int8 chunked only),
   exact launch counts of the chunked runs. Then the serving workload of
   5. on the paged pool with prefill_budget 64: the first wave's first
   poll beside the monolithic one, and the whole run with exact launch
   counts. Every distinct served stream of these phases is held,
   teacher-forced, to the plain contiguous engine by the margin rule of
   4, with at least one token checked in each phase.
8. Training phases (Qwen3-1.7B, bf16). Kernel rows 1i
   (flash_decode_partial, the training forward), 8 (dq) and 9 (dk/dv) at
   B=4, S=T=1024, lse and D from the plain forward, and 14/15 (gemm, the
   one-rank ag_gemm/gemm_rs) at the step's M=4096 projections and one
   transposed-weight backward product, each held against its plain
   version and timed beside its library call (SDPA forward, SDPA
   backward, torch.matmul); dq and dk/dv also with queries after the
   first key (q_off > 0), keys cut short (valid_len < T) and at head dim
   64 in f32, and gemm's f32 path with ragged M and N. Then full width and depth (28 layers, random
   weights), B=4, S=1024, mean next-token cross-entropy through
   DenseLLM.forward_train: one step through mode "train" with the launch
   counts reset just before and read just after, exactly 28
   flash_decode_partial, 28 dq, 28 dk/dv and 224 gemm launches and no
   other; its loss and every parameter's gradient held against mode
   "xla" (TRAIN_LOSS_LIMIT, TRAIN_GRAD_LIMIT); forward and backward ms,
   tokens/s, the share of the bf16 peak, peak memory, a profiled step
   (idle share, top device ops); then TRAIN_STEPS SGD steps on the same
   batch, the loss falling at every step.
9. GDN, sequence-parallel partial and registry phase. Rows 10a-10e
   (gdn_fwd, the Gated DeltaNet forward kernel): the JAX report's on-chip
   shape (B=8, H=16, T=2048, dk=dv=128, C=64, bf16), one
   Qwen3-Next-80B-A3B GDN layer's prefill (B=1, 32 value heads with the
   16 q/k heads repeated to them, T=8192, bf16), the registry's shape
   with S0 (f32), a ragged T=200 with S0 (dk=dv=64, C=32, f32) and the
   deep-decay span (g in [-3.5, -2.5) a token, f32), each held to its
   plain version within GDN_LIMIT (tools/fault_margin.py --gdn) and the
   f32 rows also to the f64 recurrence. Rows 4h-4i
   (flash_decode_paged_partial): the sequence-parallel paged attend
   emulated at sp=4 on the serving cell's shape (64 slots, Hq=16, Hkv=8,
   page 16, kv_lens up to 224), decode and the mixed tick's window
   (S=64), bf16 and int8 pools: rank r holds pool pages [r*pps,
   (r+1)*pps), walks them through its local redirected table with its
   ownership mask, and the four partials, each held to its plain
   version, LSE-combine to flash_decode_paged over the whole pool; a
   batch row whose pages all lie on rank 0 is bitwise (0, -1e30, 0) on
   the other ranks. Then the main path of this slice, its entry points:
   every single-card kernel_registry() spec built on the card at its canonical shape
   and run (exact launch counts), each held to the same spec run on the
   CPU, then perf_report.run_report() (ag_gemm and gemm_rs at world size
   1, flash_decode, flash_decode_paged, gdn_fwd), each row's op first
   held to its plain version on the very inputs it times, then timed at
   a SOL fraction at or below 1.
10. MoE phases (Qwen3-30B-A3B, TP-MoE at tensor-parallel size 1, bf16,
   after every dense model is freed). Kernel rows 7a-7d (grouped_gemm at
   the decode and prefill capacities of the main path) and a ragged case,
   each x padded past C with 100x rows; flash_decode and
   flash_decode_paged at the model's 8 query heads per kv head. The layer
   phase: one full-width TP_MoE (E=128, top-8, D=2048, I=768) at M=128
   and M=16384, capacity 2.0, fwd_local against the plain composition of
   the port's own pieces (grouped_gemm_ref) and, at M=128, the dense
   oracle fwd_xla. The engine phase: the whole model (48 layers, random
   weights) through Engine(backend="flash"), B=128 x S=128 prefill and 32
   decode steps at capacity 2.0, with exactly 96 grouped_gemm, 48
   flash_decode and 96 kv_update launches per forward and no swiglu, and
   the capacity drops of 8 slot-chunk decode steps (the port's own
   routing load); then, on the same model switched to capacity
   "dropless", a teacher-forced check against the plain backend at B=4,
   S=64 with the plain backend's expert selection pinned to the flash
   path's (tools/fault_margin.py RouteTape), and no drop in a slot chunk.
   The serving phase: the first 16 of the 128 requests (a quarter of a
   wave of the slots) through ContinuousScheduler(paged=True) at capacity 2.0
   (exact launch counts, the MoE counters, the tick probe), then a
   dropless arm (8 requests, 4 slots, no drop) whose first
   MOE_DL_TF_REQS served streams are held to the contiguous flash engine
   teacher-forced along them,
   and that engine to the plain one with the routing pinned; the same
   arm with prefill_budget 32 (a mixed tick routes its whole window,
   padding too; exact launch counts; MOE_TF_REQS of its streams held so).
11. Tensor-parallel phase (tools/tp_check.py `run`, Qwen3-1.7B at full
   width, cut to TP_LAYERS = 14 of its 28 layers since the
   expert-parallel phase came), over four ranks emulated on the one card
   (`make_mesh(4, devices=["cuda:0"] * 4)`: the same device code as on
   four cards, every rank's CTAs resident on this one, peers reached by
   plain pointers; it proves the collectives' arithmetic, signalling and
   epochs, not NVLink peer access nor the ordering of stores across
   cards, which `python3 -m triton_dist_tpu_torch.tools.tp_check --cards
   4` checks). The registry's comm specs on the mesh, held bitwise (their
   gemm_ar, ag_gemm and gemm_rs within their tp_check limits) to the
   same specs on a CPU mesh, with all_gather and reduce_scatter launched
   by them; the kernel rows of all_reduce, all_gather, reduce_scatter
   (bitwise to their plain versions, every rank equal, CALLS calls on
   fresh inputs), gemm_allreduce (bf16 and int8 panels, within
   GEMM_AR_LIMIT) and the ag_gemm and gemm_rs rings (the "dist"
   projections at 128, 64 and 16384 rows, bf16 and int8 panels, and the
   registry's f32 shapes, within AG_GEMM_LIMIT / GEMM_RS_LIMIT); Engine
   "ar", "gemm_ar", "dist" and "mega" over the mesh, B=128 after a
   128-token prompt (on "mega" prefill on "flash" launching flash_decode,
   kv_update and swiglu alone and decode exactly one TP megakernel launch
   per layer per step and nothing else; on "ar"/"gemm_ar" prefill on
   "xla" launching no kernel and
   decode launching the per-layer kernels and the comm kernel,
   all_reduce two-shot at 128 rows and no one-shot; on "dist" prefill
   and decode launching the per-layer kernels and exactly 2 ag_gemm and
   2 gemm_rs a layer and forward, no other comm kernel and no gemm),
   teacher-forced against the one-rank "xla" engine by the margin rule
   of 4., each backend's decode ms/step and idle share printed side by
   side; paged serving at 64 slots on "gemm_ar", "ar" (the all_reduce
   one-shot at 64 rows and no two-shot) and "dist" over the serving
   traffic's first tp_check.N_REQ (16) requests, admissions launching no
   comm kernel on the first two and the rings alone on "dist", ticks
   launching the backend's comm kernels alone, every served stream of
   the three backends held to the one-rank plain engine.
12. Expert-parallel phase (tools/tp_check.py `run_ep`), on the MoE
   phases' model cut to its first MOE_MESH_LAYERS = 16 of 48 layers (a
   Qwen3MoE over layers[:16], the same storage; 48 until the
   tensor-parallel MoE phase came, 24 until the sequence-parallel phase
   came; the checks do not depend on depth), its experts split over four ranks
   emulated on the card (Qwen3MoE.to_mesh(mesh, "ep"): the expert panels
   views of the one-rank model's, 32 experts a rank; full width). Kernel
   rows 18-20: all_to_all (the combine) and dispatch_a2a (payload and
   metadata) at the decode step's and the prefill's capacities, bf16 and
   the int8 wire, and the registry's f32 shapes (low_latency_all_to_all's
   too), bitwise to their plain versions on every rank;
   ep_moe_fused_device at the serving layer's shape (bf16, int8 panels)
   and the registry's f32 shape within tp_check.EP_FUSED_LIMIT
   (tools/fault_margin.py --ep). Per backend "ep" and "ep_flash":
   Engine prefill B=128 x S=128 and 16 decode steps at capacity 2.0 (one
   dispatch_a2a, one all_to_all and two grouped_gemm over the four ranks'
   experts a layer and forward, on "ep" one ag_gemm and one gemm_rs a
   layer and forward, nothing outside the EP path), paged serving of the traffic's
   first 16 requests, at most 32 tokens each, at 64 slots (admissions
   and ticks each launching
   both exchanges; the ticks' routed entries counted in full); then
   dropless: the teacher-forced gate against the one-rank plain engine
   with the routing pinned (B=4 x S=64, 8 steps, MOE_LIMIT, and a slot
   chunk's routing load equal to the plain engine's with no drop), and a
   dropless serving wave (4 requests on 4 slots, 16 tokens each) whose
   streams are teacher-forced through the EP forward against the plain
   engine (MOE_SERVE_LIMIT, MOE_LIMIT).
   Then row 20 through EP_MoE(mode="ep_fused") at the serving layer (bf16
   and int8 panels) against fwd_ep, dropless, timed beside the fwd_ep
   chain.
13. Tensor-parallel MoE phase (tools/tp_check.py `run_tp_moe`), on the
   same 16 layers, each expert's intermediate columns split over four
   ranks emulated on the card (Qwen3MoE.to_mesh(mesh, "tp"): rank r's
   [gate_r | up_r] two column blocks of the one-rank [gate | up] panel and
   its w_down rows, views, 192 columns a rank). Kernel rows 21-23:
   ag_group_gemm and moe_reduce_rs at the fused form's capacities of the
   decode step (B=128 rows) and the prefill (B*S), moe_reduce_ar at
   fused_ar's of the decode step and of tp_check.TP_MOE_AR_ROWS rows, each
   on the rank panels' views in bf16 and at the registry's f32 shape,
   within tp_check.TP_MOE_LIMIT of its plain version
   (tools/fault_margin.py --tp-moe). Engine "dist" (prefill through
   itself) and "gemm_ar" (prefill on "flash"): B=128 x S=128 and 16 decode
   steps at capacity 2.0, exactly two grouped_gemm a rank and, on "dist",
   one ag_gemm, gemm_rs, all_gather and reduce_scatter, on "gemm_ar" one
   gemm_allreduce, a layer and forward; paged serving on "dist" of the
   traffic's first 16 requests, at most 32 tokens each, at 64 slots; then
   dropless, per backend: the gate against the one-rank plain engine with
   the routing pinned (MOE_LIMIT; a slot chunk's load equal) and a serving
   wave of 8 requests on 4 slots, 16 tokens each, whose streams are
   teacher-forced against the plain engine (MOE_SERVE_LIMIT, MOE_LIMIT).
   Then TP_MoE(mode="fused") and mode="fused_ar" at the serving layer (128
   rows), each within TP_MOE_LIMIT of the same form on the plain kernels,
   timed beside the fwd_dist and fwd_local chains.
14. Sequence-parallel phase (tools/sp_check.py `run_sp`; it runs right
   after the tensor-parallel phase, before the MoE phases take the card's
   memory), over four ranks emulated on the card. Kernel rows 24-26:
   lse_combine (the serving tick's 8 slots and the SPAttn decode, f32
   partials, rows that own no key giving 0), kv_scatter (the SPAttn
   prefill's 4096-position blocks into 8192-position windows, bf16,
   bitwise) and ring_attn (B=1 x S=16384, Hq=16, Hkv=8, d=128, bf16,
   causal), each within sp_check.SP_KERNEL_LIMIT of its plain version
   (tools/fault_margin.py --sp) and timed beside its plain version, the
   library call (kv_scatter: one copy_ of the block; ring_attn:
   scaled_dot_product_attention over the whole sequence, is_causal,
   enable_gqa) and its bound; the registry's three SP specs (f32) held to
   the same specs on a CPU mesh. SPAttn at Qwen3-1.7B's attention widths
   (D=2048, Hq=16, Hkv=8, hd=128, QK-norms, bf16): B=1 x S=16384 over the
   ranks into a T=32768 cache, prefill(mode="ring_shmem") against
   prefill(mode="ring") (one ring_attn and two kv_scatter, nothing else),
   then 16 decode steps with combine "dist" against "xla". Serving:
   Qwen3-1.7B at all 28 layers, bf16, sp_combine "dist",
   Engine(backend="flash"), ContinuousScheduler(paged=True, page=16) at 8
   slots: 8 requests sharing a 1024-token system prompt (prompts of
   3072-4096 tokens), 32 tokens each, the prefix cache hitting across the
   shards, only the SP path's kernels launched; every served stream held
   to the one-rank plain engine by the margin rule at sp_check.SP_GATE;
   every shard's residency 0 once the radix tree is dropped; the same
   prompts admitted by hand and 4 decode steps whose "dist" logits are
   held to "xla"; one bare tick with no host sync, then profiled (tok/s,
   TTFT, ms per step, launches per step, idle share).
15. Ulysses and pipeline phase (tools/sp_check.py `ulysses_rows` and
   `ulysses_check`, tools/pp_check.py `run_pp`), over four ranks emulated
   on the card. Rows 27-28 (o_a2a_gemm, gemm_a2a) at the Ulysses prefill's
   shapes (bf16) and a small f32 shape, within
   sp_check.ULYSSES_KERNEL_LIMIT of their plain versions
   (tools/fault_margin.py --ulysses), timed beside the plain version, one
   rank's product in torch.matmul and the bound. UlyssesAttn at the SPAttn
   widths, B=1 x S=16384: prefill(mode="fused") launching one gemm_a2a and
   one o_a2a_gemm a device, one flash_decode a rank and no all_to_all;
   "unfused" two all_to_all and no fused kernel; fused against unfused
   and both against "xla" within sp_check.ULYSSES_GATE; dispatch then
   combine bitwise; the three timed beside SPAttn's ring_shmem and ring
   (from the SP phase). Row 17 (p2p_shift) at the pipeline's handoff, a
   push hop's payload and the registry's shape, bitwise, timed beside one
   copy_; the registry's p2p_shift spec bitwise its CPU run. PPipeline
   over Qwen3-1.7B's 28 MLP blocks (four stages of 7; RMSNorm, gate/up,
   the swiglu kernel, down, residual), 8 microbatches of [128, 2048] bf16
   (11 ticks), replicate_out both ways: bitwise the 28 blocks in order on
   one rank, one p2p_shift a tick. p2p_push_pages of one 1024-token
   prompt's k and v ([28, 512, 16, 128] bf16) to rank 1 and rank 2,
   bitwise, timed beside one copy_.
16. Prints one JSON line of per-kernel results, then, last, the device
   line {"ok": true, "device": {...}}.

Exits non-zero, printing no result, if there is no CUDA device, if the
package is not beside this script, or if any phase fails.
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

try:
    from triton_dist_tpu_torch.tools.checks import (
        check, distinct, margin_gate, only_launched, serving_requests, set_capacity, tf_gate)
except ImportError as e:          # main() reports it
    PACKAGE_MISSING = e
else:
    PACKAGE_MISSING = None

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores, same source
B, S, GEN, T_KERNEL, KV_DECODE = 128, 128, 32, 264, 200
N_LAYERS = 28                  # Qwen3-1.7B: one megakernel launch per layer per step
TF_STEPS = 8                   # teacher-forced decode steps checked per phase
PAGE = 16
# window kernel rows: the cache's positions and the longest row length
WIN_T, WIN_KV = 416, 400
# speculative decoding (bench.py:396-430): requests, budget (bench.py's 96
# cut to 64 since the expert-parallel phase came), draft length, the
# prompt's pattern and its repeats
SPEC_B, SPEC_GEN, SPEC_K, SPEC_PERIOD, SPEC_REPS = 16, 64, 4, 4, 16
# chunked prefill (bench.py:498-560): live requests, their prompt and
# budget (bench.py's 192 cut to 96 since the expert-parallel phase came:
# the long prompt's first token comes within the first 40), the long
# prompt, the prefill budget; the serving workload's budget
CL_LIVE, CL_PLEN, CL_GEN, CL_LONG, CL_BUDGET = 6, 16, 96, 384, 32
SERVE_BUDGET = 64
# the first-poll ms of each serving phase's tick probe, by label
FIRST_POLL_MS = {}
# serving (its traffic: tools/checks.py serving_requests): slots, chunk,
# slot capacity (prompt <= 144 + gen <= 64 plus the paged pool's chunk
# margin of 15), requests teacher-forced against the plain engine
SERVE_B, SERVE_CHUNK, SERVE_MAX_SEQ = 64, 16, 224
TF_REQS = 8
# the tick probe's profiled tick: its steps (the profiler's own cost
# grows with the launches it records: 6017 a step on MoE)
PROFILE_STEPS = 4
# MoE: the teacher-forced arm's batch and prompt, the dropless serving
# arm's requests and slots, the logit limit of flash against the plain
# backend with the routing pinned, and the margin limit of served tokens
# against the contiguous flash engine
# (triton_dist_tpu_torch/tools/fault_margin.py --moe)
MOE_TF_B, MOE_TF_S = 4, 64
# the capacity-2.0 arm's requests: a quarter of a wave of the serving
# slots (its tokens are not teacher-forced; the tick probe admits them all
# in its first poll); 64 until the "dist" phases took its time
MOE_REQS = SERVE_B // 4
MOE_DL_REQS, MOE_DL_SLOTS = 8, 4
# served streams held, teacher-forced, to the contiguous flash engine with
# the routing pinned (about 12-16 s a request): of the monolithic dropless
# arm MOE_DL_TF_REQS (all 8 before the tensor-parallel phase came), of the
# prefill_budget arm MOE_TF_REQS (4 before)
MOE_DL_TF_REQS, MOE_TF_REQS = 4, 2
MOE_LIMIT = 3e-2
MOE_SERVE_LIMIT = 2e-2
MOE_BUDGET = 32                # the MoE arm's prefill_budget
# window kernel rows: (case, slots, window, query heads, kv heads, cache
# positions, longest kv length, forms, KV types, the key of the serving
# run whose launches the row reports, by KV type and form): the spec
# verify window, the chunked tick, and the mixed ticks of the serving
# workload at prefill_budget SERVE_BUDGET and of the MoE arm
WIN_CASES = (
    ("spec", SPEC_B, SPEC_K + 1, 16, 8, WIN_T, WIN_KV, ("contiguous", "paged"),
     ("bf16", "int8"),
     # int8: the chunked int8 runs, the only int8 window phases
     lambda kvt, form: (kvt, f"{'spec' if kvt == 'bf16' else 'chunked'} {form}")),
    ("chunked", CL_LIVE + 1, CL_BUDGET, 16, 8, WIN_T, WIN_KV, ("contiguous", "paged"),
     ("bf16", "int8"), lambda kvt, form: (kvt, f"chunked {form}")),
    ("serving", SERVE_B, SERVE_BUDGET, 16, 8, SERVE_MAX_SEQ, SERVE_MAX_SEQ, ("paged",),
     ("bf16",), lambda kvt, form: ("bf16", "chunked serving")),
    ("moe", MOE_DL_SLOTS, MOE_BUDGET, 32, 4, SERVE_MAX_SEQ, SERVE_MAX_SEQ, ("paged",),
     ("bf16",), lambda kvt, form: ("moe", "chunked")))
# training: batch and sequence of the step, SGD steps and rate (at 0.05
# most bf16 updates round away and the loss need not fall at every
# step), and the limits of the kernel path against the plain one on the
# loss (relative) and on each parameter's gradient error as a share of
# that gradient's largest value (triton_dist_tpu_torch/tools/fault_margin.py
# --train)
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_LR = 4, 1024, 4, 0.5
TRAIN_LOSS_LIMIT, TRAIN_GRAD_LIMIT = 1e-4, 0.15
# GDN: the kernel's limit against its plain version, as the larger of
# max|d o| / max|o| and max|d S_T| / max|S_T|
# (triton_dist_tpu_torch/tools/fault_margin.py --gdn), and the f32 rows'
# tolerance (atol, rtol) against the f64 recurrence (the JAX package's
# tests/test_gdn_ll.py: 2e-4, and rtol 2e-3 on the deep-decay span)
GDN_LIMIT = 1e-2
GDN_F64_TOL = {"10c": (2e-4, 2e-4), "10d": (2e-4, 2e-4), "10e": (2e-4, 2e-3)}
# the sequence-parallel degree of the paged partial's emulation
SP_RANKS = 4
# the tensor-parallel phase's depth: Qwen3-1.7B cut from 28 layers to make
# room for the expert-parallel phase (its checks do not depend on depth)
TP_LAYERS = 14
# the expert-parallel and tensor-parallel MoE phases' depth: Qwen3-30B-A3B
# cut from 48 layers (the same storage) to make room for the second, then
# from 24 to make room for the sequence-parallel phase
MOE_MESH_LAYERS = 16


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card, one CUDA event pair each."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS_PER_S):
    """The least ms the card could take: bytes over the HBM rate or
    operations over the peak rate of their type (bf16 unless given)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(out, ref) -> float:
    return (out.float() - ref.float()).abs().max().item()


def kernel_phase(k, gen):
    """Each kernel against its plain version at the main path's shapes."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    Hq, Hkv, d, I = 16, 8, 128, 6144
    rows = []

    def row(name, case, source, replaces, out, ref, tol, kernel_fn, plain_fn,
            library_fn, nbytes, flops, launch_key):
        err = max_err(out, ref)
        check(err <= tol, f"{name} {case}: max_abs_err {err} > tol {tol}")
        b_ms, b_by = bound(nbytes, flops)
        r = dict(name=name, case=case, route="cuda", source=source,
                 replaces=replaces, launches=None, max_abs_err=err, tol=tol,
                 ms=cuda_ms(kernel_fn), plain_ms=cuda_ms(plain_fn, reps=5),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=None if library_fn is None else cuda_ms(library_fn))
        rows.append((r, launch_key))
        print(f"kernel {name} [{case}]: max_abs_err {err:.3g} (tol {tol:.3g}) "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"bound_ms {b_ms:.4f} ({b_by})", flush=True)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    fd_src = "triton_dist_tpu_torch/kernels/csrc/flash_decode.cu"
    fd_rep = "triton_dist_tpu/kernels/flash_attn.py:406"
    for phase, Sq, kv_len in (("prefill", S, S), ("decode", 1, KV_DECODE)):
        q = randn(B, Sq, Hq, d)
        # the cache tail past kv_len holds large values (and, once
        # quantized, large scales): a kernel that reads one key past
        # kv_len puts nearly all its weight there and fails the check
        kc = randn(B, Hkv, T_KERNEL, d)
        vc = randn(B, Hkv, T_KERNEL, d)
        kc[:, :, kv_len:] *= 100
        vc[:, :, kv_len:] *= 100
        # causal work: row s sees kv_len - Sq + s + 1 keys; QK and PV 2*d each
        keys = sum(kv_len - Sq + s + 1 for s in range(Sq)) * B * Hq
        flops = 4 * d * keys
        qo_bytes = 2 * q.numel() * 2
        kv_bytes = 2 * B * Hkv * kv_len * d
        for kvt in ("bf16", "int8"):
            if kvt == "bf16":
                kw = {}
                kk, vv = kc, vc
                nbytes = qo_bytes + 2 * kv_bytes
                qT = q.transpose(1, 2)
                kT, vT = kc[:, :, :kv_len], vc[:, :, :kv_len]
                library = (lambda qT=qT, kT=kT, vT=vT, c=Sq > 1:
                           F.scaled_dot_product_attention(qT, kT, vT, is_causal=c,
                                                          enable_gqa=True))
            else:
                kk, ks = k.quantize_kv_int8(kc)
                vv, vs = k.quantize_kv_int8(vc)
                kw = dict(k_scale=ks, v_scale=vs)
                nbytes = qo_bytes + kv_bytes + 2 * B * Hkv * kv_len * 4
                library = None      # no one PyTorch call takes an int8 cache
            out = k.flash_decode(q, kk, vv, kv_len, **kw)
            ref = k.flash_decode_ref(q, kk, vv, kv_len, **kw)
            torch.cuda.synchronize()
            row("flash_decode", f"{phase} S={Sq} kv_len={kv_len} T={T_KERNEL} {kvt}",
                fd_src, fd_rep, out, ref, 1e-2 * (1 + ref.float().abs().max().item()),
                lambda: k.flash_decode(q, kk, vv, kv_len, **kw),
                lambda: k.flash_decode_ref(q, kk, vv, kv_len, **kw),
                library, nbytes, flops, (kvt, phase))

    # the serving tick: B slots at seeded mixed lengths, one query each;
    # one length ends mid-page, one on a page boundary, one at 1
    lens = torch.randint(1, T_KERNEL + 1, (B,), generator=gen, device=dev,
                         dtype=torch.int32)
    lens[:3] = torch.tensor([T_KERNEL, 16 * PAGE, 1], dtype=torch.int32)
    n_keys = int(lens.sum())
    q1 = randn(B, 1, Hq, d)
    flops = 4 * d * Hq * n_keys
    q_bytes = 2 * q1.numel() * 2
    t_idx = torch.arange(T_KERNEL, device=dev)
    valid = t_idx[None, :] < lens[:, None]                      # [B, T]

    # flash_decode with per-row kv_lens over the contiguous cache, the
    # cache past each row's length filled with 100x values
    kc = randn(B, Hkv, T_KERNEL, d)
    vc = randn(B, Hkv, T_KERNEL, d)
    kc[~valid[:, None, :, None].expand_as(kc)] *= 100
    vc[~valid[:, None, :, None].expand_as(vc)] *= 100
    sdpa_mask = valid[:, None, None, :]
    for kvt in ("bf16", "int8"):
        if kvt == "bf16":
            kw, kk, vv = {}, kc, vc
            nbytes = q_bytes + 2 * Hkv * n_keys * d * 2 + B * 4
            library = (lambda: F.scaled_dot_product_attention(
                q1.transpose(1, 2), kc, vc, attn_mask=sdpa_mask, enable_gqa=True))
        else:
            kk, ks = k.quantize_kv_int8(kc)
            vv, vs = k.quantize_kv_int8(vc)
            kw = dict(k_scale=ks, v_scale=vs)
            nbytes = q_bytes + 2 * Hkv * n_keys * (d + 4) + B * 4
            library = None      # no one PyTorch call takes an int8 cache
        out = k.flash_decode(q1, kk, vv, kv_lens=lens, **kw)
        ref = k.flash_decode_ref(q1, kk, vv, kv_lens=lens, **kw)
        torch.cuda.synchronize()
        row("flash_decode", f"slots S=1 kv_lens in [1, {T_KERNEL}] T={T_KERNEL} {kvt}",
            fd_src, fd_rep, out, ref, 1e-2 * (1 + ref.float().abs().max().item()),
            lambda: k.flash_decode(q1, kk, vv, kv_lens=lens, **kw),
            lambda: k.flash_decode_ref(q1, kk, vv, kv_lens=lens, **kw),
            library, nbytes, flops,
            # launches: those of the contiguous serving run (bf16); int8
            # serves paged only, so its row counts flash_decode's
            # launches in the paged int8 run (its admissions)
            (kvt, "contiguous" if kvt == "bf16" else "paged"))

    # flash_decode_paged: the table maps each stream's tiles to a random
    # permutation of the pool; entries past a stream's pages point at
    # random pages, and every row no stream uses (the trash page 0, pages
    # no table maps, rows past each stream's length) holds 100x values,
    # and so, once quantized, 100x scales
    maxp = -(-T_KERNEL // PAGE)
    X = B * Hkv
    NP = 1 + X * maxp
    table = (1 + torch.randperm(NP - 1, generator=gen, device=dev)[:X * maxp]
             ).reshape(X, maxp).to(torch.int32)
    lens_x = lens.repeat_interleave(Hkv)
    n_pages = (lens_x + PAGE - 1) // PAGE
    past = torch.arange(maxp, device=dev)[None, :] >= n_pages[:, None]
    table[past] = torch.randint(0, NP, (int(past.sum()),), generator=gen, device=dev,
                                dtype=torch.int32)
    used = torch.zeros(NP * PAGE, dtype=torch.bool, device=dev)
    pos = torch.arange(maxp * PAGE, device=dev)
    live = pos[None, :] < lens_x[:, None]
    used[(table.long()[:, pos // PAGE] * PAGE + pos % PAGE)[live]] = True
    used = used.reshape(NP, PAGE)
    pk = randn(NP, PAGE, d)
    pv = randn(NP, PAGE, d)
    pk[~used] *= 100
    pv[~used] *= 100
    fdp_src = "triton_dist_tpu_torch/kernels/csrc/flash_decode_paged.cu"
    fdp_rep = "triton_dist_tpu/kernels/paged_kv.py:411"
    table_bytes = int(n_pages.sum()) * 4
    for kvt in ("bf16", "int8"):
        if kvt == "bf16":
            kw, kk, vv = {}, pk, pv
            nbytes = q_bytes + 2 * Hkv * n_keys * d * 2 + table_bytes + B * 4
        else:
            kk, ks = k.quantize_kv_int8(pk)
            vv, vs = k.quantize_kv_int8(pv)
            kw = dict(k_scale=ks, v_scale=vs)
            nbytes = q_bytes + 2 * Hkv * n_keys * (d + 4) + table_bytes + B * 4
        out = k.flash_decode_paged(q1, kk, vv, table, kv_lens=lens, **kw)
        ref = k.flash_decode_paged_ref(q1, kk, vv, table, kv_lens=lens, **kw)
        torch.cuda.synchronize()
        # no one PyTorch call reads K/V through a page table: library null
        row("flash_decode_paged", f"slots S=1 kv_lens in [1, {T_KERNEL}] page={PAGE} "
            f"{kvt}", fdp_src, fdp_rep, out, ref,
            1e-2 * (1 + ref.float().abs().max().item()),
            lambda: k.flash_decode_paged(q1, kk, vv, table, kv_lens=lens, **kw),
            lambda: k.flash_decode_paged_ref(q1, kk, vv, table, kv_lens=lens, **kw),
            None, nbytes, flops, (kvt, "paged"))
    del kc, vc, pk, pv, kk, vv, kw
    torch.cuda.empty_cache()

    kv_src = "triton_dist_tpu_torch/kernels/csrc/kv_update.cu"
    kv_rep = "triton_dist_tpu/kernels/flash_attn.py:448"
    for phase, Sn, pos in (("prefill", S, 0), ("decode", 1, KV_DECODE - 1)):
        for kvt, dt in (("bf16", torch.bfloat16), ("int8", torch.int8)):
            # new rows as the layer hands them over: a [B, Hkv, S, d] view
            # of [B, S, Hkv, d]
            src = randn(B, Sn, Hkv, d).mul(20).to(dt)
            new = src.transpose(1, 2)
            cache = torch.zeros(B, Hkv, T_KERNEL, d, device=dev, dtype=dt)
            out = k.kv_update(cache.clone(), new, pos)
            ref = k.kv_update_ref(cache.clone(), new, pos)
            torch.cuda.synchronize()
            idx = torch.arange(pos, pos + Sn, device=dev)
            row("kv_update", f"{phase} S={Sn} pos={pos} T={T_KERNEL} {kvt}", kv_src,
                kv_rep, out, ref, 0.0, lambda: k.kv_update(cache, new, pos),
                lambda: k.kv_update_ref(cache, new, pos),
                lambda: cache.index_copy_(2, idx, new),
                2 * new.numel() * new.element_size(), 0, (kvt, phase))

    sw_src = "triton_dist_tpu_torch/kernels/csrc/swiglu.cu"
    sw_rep = "triton_dist_tpu/kernels/swiglu.py:51"
    for phase, M in (("prefill", B * S), ("decode", B)):
        x = randn(M, 2 * I) * 3
        out = k.swiglu(x)
        ref = k.swiglu_ref(x)
        torch.cuda.synchronize()
        g, u = x.chunk(2, dim=-1)
        # bitwise: the plain version rounds in the kernel's order (sigmoid
        # in f32 rounded to bf16, then two rounded products), so a kernel
        # that drops a rounding step differs from it in the last bit
        differ = int((out.view(torch.int16) != ref.view(torch.int16)).sum())
        check(differ == 0, f"swiglu M={M}: {differ} elements differ from the "
                           "plain version in their bits")
        row("swiglu", f"{phase} M={M} I={I} bf16", sw_src, sw_rep, out, ref,
            0.0, lambda: k.swiglu(x),
            lambda: k.swiglu_ref(x), lambda: F.silu(g) * u,
            3 * M * I * 2, 0, ("bf16", phase))
    return rows


def window_kernel_phase(k, gen):
    """flash_decode and flash_decode_paged in their q_lens window forms at
    the shapes the window paths give them (WIN_CASES): Qwen3-1.7B's heads
    (Hq=16, Hkv=8, hd=128) with B=16 slots of S=5 windows and q_lens in
    [0, 5] (the spec K=4 verify window) and B=7 with S=32, one 32-token
    prompt chunk and six decode rows of q_len 1 (the chunked tick), bf16
    and int8, kv_lens up to WIN_KV in a cache of WIN_T positions; the
    serving workload's mixed tick at prefill_budget SERVE_BUDGET (B=64,
    S=64, the serving capacity) and the MoE arm's at MOE_BUDGET (B=4,
    S=32, Qwen3-30B-A3B's Hq=32, Hkv=4: 256 folded rows per stream), paged
    bf16. Every key past a row's length holds 100x values; valid window
    positions are held to the plain version, padding positions must be
    finite."""
    import torch.nn.functional as F
    dev = torch.device("cuda")
    d = 128
    rows = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    fd_src = "triton_dist_tpu_torch/kernels/csrc/flash_decode.cu"
    fd_rep = "triton_dist_tpu/kernels/flash_attn.py:406"
    fdp_src = "triton_dist_tpu_torch/kernels/csrc/flash_decode_paged.cu"
    fdp_rep = "triton_dist_tpu/kernels/paged_kv.py:411"
    for case, Bw, Sw, Hq, Hkv, T, kv_max, forms, kvts, keys in WIN_CASES:
        rep = Hq // Hkv
        if case == "chunked":
            ql = torch.ones(Bw, dtype=torch.int32, device=dev)
            ql[0] = Sw
        else:
            ql = torch.randint(0, Sw + 1, (Bw,), generator=gen, device=dev, dtype=torch.int32)
            ql[:3] = torch.tensor([0, 1, Sw], dtype=torch.int32)
        kl = (ql + torch.randint(0, kv_max - Sw + 1, (Bw,), generator=gen, device=dev,
                                 dtype=torch.int32)).to(torch.int32)
        if case == "chunked":
            kl[0] = kv_max                  # the prompt chunk ends at the longest length
        else:
            kl[0] = 0                       # a row with no key at all
            if case != "spec":
                kl[2] = kv_max              # a full window at the capacity
        s_idx = torch.arange(Sw, device=dev)
        live_q = s_idx[None, :] < ql[:, None]                       # [B, S] valid
        front = kl[:, None] - ql[:, None] + torch.minimum(s_idx[None], ql[:, None] - 1)
        n_pairs = int(((front + 1) * live_q).sum())                # (query, key) pairs
        n_keys = int(kl.sum())
        q = randn(Bw, Sw, Hq, d)
        flops = 4 * d * rep * Hkv * n_pairs
        qo_bytes = 2 * 2 * q.numel()
        t_idx = torch.arange(T, device=dev)
        valid_kv = t_idx[None, :] < kl[:, None]                     # [B, T]
        kc, vc = randn(Bw, Hkv, T, d), randn(Bw, Hkv, T, d)
        kc[~valid_kv[:, None, :, None].expand_as(kc)] *= 100
        vc[~valid_kv[:, None, :, None].expand_as(vc)] *= 100
        sdpa_mask = (t_idx[None, None, :] <= front[:, :, None])[:, None]    # [B, 1, S, T]

        def held(name, out, ref, label):
            err = max_err(out[live_q], ref[live_q])
            tol = 1e-2 * (1 + ref[live_q].float().abs().max().item())
            check(bool(torch.isfinite(out).all()), f"{name} {label}: non-finite output")
            return err, tol

        # the paged pool: a random permutation of pages per stream, every
        # pool row that no stream reads (past its length, unmapped, the
        # trash page 0) at 100x
        maxp = T // PAGE
        X = Bw * Hkv
        NP = 1 + X * maxp
        table = (1 + torch.randperm(NP - 1, generator=gen, device=dev)[:X * maxp]
                 ).reshape(X, maxp).to(torch.int32)
        kl_x = kl.repeat_interleave(Hkv)
        tpos = torch.arange(maxp * PAGE, device=dev)
        used = torch.zeros(NP * PAGE, dtype=torch.bool, device=dev)
        used[(table.long()[:, tpos // PAGE] * PAGE + tpos % PAGE)[
            tpos[None, :] < kl_x[:, None]]] = True
        pk, pv = randn(NP, PAGE, d), randn(NP, PAGE, d)
        pk[~used.reshape(NP, PAGE)] *= 100
        pv[~used.reshape(NP, PAGE)] *= 100
        table_bytes = int(((kl_x + PAGE - 1) // PAGE).sum()) * 4
        for kvt in kvts:
            if kvt == "bf16":
                kw, kk, vv, qk, qv = {}, kc, vc, pk, pv
                kv_bytes = 2 * Hkv * n_keys * d * 2
            else:
                kk, ks = k.quantize_kv_int8(kc)
                vv, vs = k.quantize_kv_int8(vc)
                qk, pks = k.quantize_kv_int8(pk)
                qv, pvs = k.quantize_kv_int8(pv)
                kv_bytes = 2 * Hkv * n_keys * (d + 4)
            ckw = {} if kvt == "bf16" else dict(k_scale=ks, v_scale=vs)
            pkw = {} if kvt == "bf16" else dict(k_scale=pks, v_scale=pvs)
            label = f"{case} B={Bw} S={Sw} q_lens in [{int(ql.min())}, {int(ql.max())}] " \
                    f"kv_lens <= {int(kl.max())} T={T} Hq={Hq} Hkv={Hkv} {kvt}"
            for name, src, rep_at, fn, plain, lib, extra in (
                    ("flash_decode", fd_src, fd_rep,
                     lambda: k.flash_decode(q, kk, vv, kv_lens=kl, q_lens=ql, **ckw),
                     lambda: k.flash_decode_ref(q, kk, vv, kv_lens=kl, q_lens=ql, **ckw),
                     # SDPA with each query position's boolean mask (rows
                     # with no key give NaN there; only timed)
                     None if kvt == "int8" else (
                         lambda: F.scaled_dot_product_attention(
                             q.transpose(1, 2), kc, vc, attn_mask=sdpa_mask,
                             enable_gqa=True)), 2 * Bw * 4),
                    ("flash_decode_paged", fdp_src, fdp_rep,
                     lambda: k.flash_decode_paged(q, qk, qv, table, kv_lens=kl, q_lens=ql,
                                                  **pkw),
                     lambda: k.flash_decode_paged_ref(q, qk, qv, table, kv_lens=kl,
                                                      q_lens=ql, **pkw),
                     None, 2 * Bw * 4 + table_bytes)):
                form = "paged" if name == "flash_decode_paged" else "contiguous"
                if form not in forms:
                    continue
                out, ref = fn(), plain()
                torch.cuda.synchronize()
                err, tol = held(name, out, ref, label)
                check(err <= tol, f"{name} window {label}: max_abs_err {err} > tol {tol}")
                b_ms, b_by = bound(qo_bytes + kv_bytes + extra, flops)
                r = dict(name=name, case=f"window {label}", route="cuda", source=src,
                         replaces=rep_at, launches=None, max_abs_err=err, tol=tol,
                         ms=cuda_ms(fn), plain_ms=cuda_ms(plain, reps=5), bound_ms=b_ms,
                         bound_by=b_by, library_ms=None if lib is None else cuda_ms(lib))
                rows.append((r, keys(kvt, form)))
                print(f"kernel {name} [window {label}]: max_abs_err {err:.3g} (tol "
                      f"{tol:.3g}) ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                      f"{r['library_ms'] if lib is None else round(r['library_ms'], 4)} "
                      f"bound_ms {b_ms:.4f} ({b_by})", flush=True)
        del kc, vc, pk, pv, kk, vv, qk, qv
    torch.cuda.empty_cache()
    return rows


def mega_kernel_phase(gen):
    """Rows 5a, 6a, 6b: each megakernel layer against its plain version at
    Qwen3-1.7B's width (D=2048, F=6144, Hq=16, Hkv=8, hd=128), timed
    beside the port's per-op flash layer on the same inputs."""
    from triton_dist_tpu_torch.kernels.quant import quantize_kv_int8
    from triton_dist_tpu_torch.layers import TP_Attn, TP_MLP, precompute_rope, rms_norm
    from triton_dist_tpu_torch.mega import (MegaDecodeLayer, MegaPagedDecodeLayer,
                                            mega_decode_layer_ref,
                                            mega_paged_decode_layer_ref)
    dev = torch.device("cuda")
    D, F, Hq, Hkv, hd = 2048, 6144, 16, 8, 128
    rows = []

    def rn(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev) * sc

    w = dict(w_ln1=1 + 0.1 * rn(1, D), q_norm=1 + 0.1 * rn(1, hd),
             k_norm=1 + 0.1 * rn(1, hd), w_ln2=1 + 0.1 * rn(1, D),
             w_qkv=rn(D, (Hq + 2 * Hkv) * hd, sc=D ** -0.5).bfloat16(),
             w_o=rn(Hq * hd, D, sc=(Hq * hd) ** -0.5).bfloat16(),
             w_gu=rn(D, 2 * F, sc=D ** -0.5).bfloat16(),
             w_d=rn(F, D, sc=F ** -0.5).bfloat16())
    n_params = D * (Hq + 2 * Hkv) * hd + Hq * hd * D + D * 2 * F + F * D
    cos, sin = precompute_rope(hd, 4096, device=dev)
    # the port's per-op flash layer over the same weights (the yardstick)
    attn = TP_Attn(w_qkv=w["w_qkv"], w_o=w["w_o"], q_norm=w["q_norm"].reshape(-1),
                   k_norm=w["k_norm"].reshape(-1), n_heads=Hq, n_kv_heads=Hkv, head_dim=hd)
    mlp = TP_MLP(w_gate_up=w["w_gu"], w_down=w["w_d"])

    def per_op(x, attend):
        xb = x.bfloat16()
        a, _ = attend(rms_norm(xb, w["w_ln1"].reshape(-1)))
        x2 = xb + a
        return x2 + mlp(rms_norm(x2, w["w_ln2"].reshape(-1)), "flash")

    def row(name, case, source, replaces, y, y_ref, live, pool_errs, kernel_fn, plain_fn,
            per_op_fn, nbytes, flops, launch_key):
        # the residual stream is O(1-10): f32 sums in another order over
        # K = 2048-6144 and the bf16 roundings of xn, q, P, attn, on and h
        # flipping by one ulp where the two land on a rounding boundary
        err = max_err(y[live], y_ref[live])
        tol = 1e-2 * (1 + y_ref[live].abs().max().item())
        check(err <= tol, f"{name} {case}: y max_abs_err {err} > tol {tol}")
        for what, e, t in pool_errs:
            check(e <= t, f"{name} {case}: {what} {e} > {t}")
        b_ms, b_by = bound(nbytes, flops)
        r = dict(name=name, case=case, route="cuda", source=source, replaces=replaces,
                 launches=None, max_abs_err=err, tol=tol, ms=cuda_ms(kernel_fn),
                 plain_ms=cuda_ms(plain_fn, reps=5), bound_ms=b_ms, bound_by=b_by,
                 library_ms=None, per_op_layer_ms=cuda_ms(per_op_fn),
                 pool_checks={what: e for what, e, _ in pool_errs})
        rows.append((r, launch_key))
        print(f"kernel {name} [{case}]: max_abs_err {err:.3g} (tol {tol:.3g}) ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} per-op flash layer ms "
              f"{r['per_op_layer_ms']:.4f} bound_ms {b_ms:.4f} ({b_by}); pools "
              f"{r['pool_checks']}", flush=True)

    # 5a: contiguous, every row at pos; the cache past pos holds 100x values
    pos = KV_DECODE
    x = rn(B, D)
    wd = dict(w, cos_row=cos[pos:pos + 1], sin_row=sin[pos:pos + 1])
    ck = rn(B, Hkv, T_KERNEL, hd).bfloat16()
    cv = rn(B, Hkv, T_KERNEL, hd).bfloat16()
    ck[:, :, pos + 1:] *= 100
    cv[:, :, pos + 1:] *= 100
    layer = MegaDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=hd, ffn=F,
                            T=T_KERNEL)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    y, _, _ = layer(x, pos, wd, k1, v1)
    y_ref, _, _ = mega_decode_layer_ref(x, pos, wd, k2, v2, n_heads=Hq, n_kv_heads=Hkv,
                                        head_dim=hd)
    torch.cuda.synchronize()
    other = torch.arange(T_KERNEL, device=dev) != pos
    pool_errs = [
        # the new row: one bf16 ulp of the largest value, where the f32
        # row's rounding lands on the other side of a boundary
        ("new K/V rows max|d|", max(max_err(k1[:, :, pos], k2[:, :, pos]),
                                    max_err(v1[:, :, pos], v2[:, :, pos])),
         2 ** -7 * max(k2[:, :, pos].float().abs().max().item(),
                       v2[:, :, pos].float().abs().max().item())),
        ("other cache rows changed", float(((k1 != ck) | (v1 != cv))[:, :, other].sum()),
         0.0)]
    n_keys = B * Hkv * (pos + 1)
    kb, vb = k1.clone(), v1.clone()
    row("mega_decode", f"B={B} pos={pos} T={T_KERNEL} bf16",
        "triton_dist_tpu_torch/kernels/csrc/mega_decode.cu",
        "triton_dist_tpu/mega/decode_layer.py:462", y, y_ref, slice(None), pool_errs,
        lambda: layer(x, pos, wd, kb, vb),
        lambda: mega_decode_layer_ref(x, pos, wd, kb, vb, n_heads=Hq, n_kv_heads=Hkv,
                                      head_dim=hd),
        lambda: per_op(x, lambda h: attn.fwd_cached(h, cos, sin, B, (kb, vb), pos,
                                                    "flash")),
        2 * n_params + 2 * B * D * 4 + 2 * n_keys * hd * 2,
        2 * B * n_params + 4 * hd * Hq * B * (pos + 1), ("bf16", "mega decode"))

    # 5c: the TP form, 5a's inputs split over four ranks emulated on the
    # card (as Engine(backend="mega") splits a model), timed beside the
    # per-op "gemm_ar" layer on the same shards; every rank's y bitwise
    # equal, the new rows within one bf16 ulp, the other rows unchanged
    from triton_dist_tpu_torch.runtime import make_mesh, symm_mem
    from triton_dist_tpu_torch.tools import tp_check
    r = tp_check.mega_tp_row(make_mesh(4, devices=["cuda:0"] * 4),
                             inputs=(wd, x, ck, cv, (cos, sin)), pos=pos)
    r["case"] = "5c " + r["case"]
    rows.append((r, ("tp", "mega engine")))
    del ck, cv, k1, v1, k2, v2, kb, vb
    symm_mem.clear_registry()
    torch.cuda.empty_cache()

    # 6a/6b: 64 slots at lengths in [1, 224]; slot b's new token sits at
    # lens[b] - 1. Two retired slots map only the trash page (their rows
    # are not compared: their writes race there). Entries past a stream's
    # pages point at random pages; every row no live stream reads or
    # writes (the trash page, unmapped pages, rows past each length)
    # holds 100x values.
    Bp, cap = SERVE_B, SERVE_MAX_SEQ
    maxp = cap // PAGE
    X = Bp * Hkv
    NP = 1 + X * maxp
    lens = torch.randint(1, cap + 1, (Bp,), generator=gen, device=dev, dtype=torch.int32)
    lens[:3] = torch.tensor([cap, 8 * PAGE, 1], dtype=torch.int32)
    posd = (lens - 1).to(torch.int32)
    table = (1 + torch.randperm(NP - 1, generator=gen, device=dev)[:X * maxp]
             ).reshape(X, maxp).to(torch.int32)
    lens_x = lens.repeat_interleave(Hkv)
    n_pages = (lens_x + PAGE - 1) // PAGE
    past = torch.arange(maxp, device=dev)[None, :] >= n_pages[:, None]
    table[past] = torch.randint(0, NP, (int(past.sum()),), generator=gen, device=dev,
                                dtype=torch.int32)
    retired = torch.zeros(Bp, dtype=torch.bool, device=dev)
    retired[-2:] = True
    table[retired.repeat_interleave(Hkv)] = 0
    live = ~retired
    tpos = torch.arange(maxp * PAGE, device=dev)
    used = torch.zeros(NP * PAGE, dtype=torch.bool, device=dev)
    reads = (tpos[None, :] < lens_x[:, None]) & live.repeat_interleave(Hkv)[:, None]
    used[(table.long()[:, tpos // PAGE] * PAGE + tpos % PAGE)[reads]] = True
    used = used.reshape(NP, PAGE)
    pk = rn(NP, 1, PAGE, hd)
    pv = rn(NP, 1, PAGE, hd)
    pk[:, 0][~used] *= 100
    pv[:, 0][~used] *= 100
    xp = rn(Bp, D)
    wp = dict(w, cos_row=cos[posd.long()], sin_row=sin[posd.long()])
    player = MegaPagedDecodeLayer(d_model=D, n_heads=Hq, n_kv_heads=Hkv, head_dim=hd,
                                  ffn=F, page=PAGE, maxp=maxp)
    n_keys = int(lens[live].sum()) * Hkv
    written = torch.zeros((NP, PAGE), dtype=torch.bool, device=dev)
    wpage = table.long()[torch.arange(X, device=dev), (lens_x - 1) // PAGE]
    written[wpage[live.repeat_interleave(Hkv)],
            ((lens_x - 1) % PAGE)[live.repeat_interleave(Hkv)]] = True
    keep = ~written
    keep[0] = False                      # the trash page: retired slots race there
    for kvt in ("bf16", "int8"):
        if kvt == "bf16":
            pools = (pk.bfloat16(), pv.bfloat16())
            kv_row = hd * 2
        else:
            qk, sk = quantize_kv_int8(pk)
            qv, sv = quantize_kv_int8(pv)
            pools = (qk, qv, sk, sv)
            kv_row = hd + 4
        a = [t.clone() for t in pools]
        b_ = [t.clone() for t in pools]
        out = player(xp, posd, wp, a[0], a[1], table, *a[2:])
        ref = mega_paged_decode_layer_ref(xp, posd, wp, b_[0], b_[1], table, *b_[2:],
                                          n_heads=Hq, n_kv_heads=Hkv, head_dim=hd)
        torch.cuda.synchronize()
        pool_errs = [("unwritten pool rows changed",
                      float(sum(int((o[:, 0][keep] != t[:, 0][keep]).sum())
                                for o, t in zip(out[1:], pools))), 0.0)]
        if kvt == "bf16":
            top = max(r_[:, 0][written].float().abs().max().item() for r_ in ref[1:3])
            pool_errs.append(("new rows max|d|", max(max_err(o[:, 0][written],
                                                             r_[:, 0][written])
                                                     for o, r_ in zip(out[1:3], ref[1:3])),
                              2 ** -7 * top))
        else:
            # an int8 level where the f32 row lands within a rounding
            # boundary of the plain version's; the scales to f32 rounding
            pool_errs.append(("new rows max|d int8|", max(max_err(o[:, 0][written],
                                                                  r_[:, 0][written])
                                                          for o, r_ in zip(out[1:3],
                                                                           ref[1:3])),
                              1.0))
            pool_errs.append(("new scales max rel|d|", max(
                ((o[:, 0][written] - r_[:, 0][written]).abs()
                 / r_[:, 0][written]).max().item() for o, r_ in zip(out[3:], ref[3:])),
                1e-2))
        c = [t.clone() for t in pools]
        attend_pools = (c[0], c[1]) + tuple(c[2:])
        row("mega_paged_decode", f"{Bp} slots lens in [1, {cap}] page={PAGE} {kvt}",
            "triton_dist_tpu_torch/kernels/csrc/mega_paged_decode.cu",
            "triton_dist_tpu/mega/decode_layer.py:919", out[0], ref[0], live, pool_errs,
            lambda: player(xp, posd, wp, c[0], c[1], table, *c[2:]),
            lambda: mega_paged_decode_layer_ref(xp, posd, wp, c[0], c[1], table, *c[2:],
                                                n_heads=Hq, n_kv_heads=Hkv, head_dim=hd),
            lambda: per_op(xp, lambda h: attn.fwd_cached_slots_paged(
                h, cos, sin, Bp, attend_pools, table, posd, "flash")),
            2 * n_params + 2 * Bp * D * 4 + 2 * n_keys * kv_row + int(
                n_pages[live.repeat_interleave(Hkv)].sum()) * 4,
            2 * Bp * n_params + 4 * hd * Hq * int(lens[live].sum()),
            (kvt, "mega paged"))
    return rows


def moe_kernel_phase(k, gen):
    """Rows 7a-7d and a ragged case of grouped_gemm at Qwen3-30B-A3B's
    expert shapes (E=128, D=2048, I=768) and the capacities of the main
    path (decode B=128 at capacity 2.0: C=24; prefill 128 x 128: C=2056),
    then flash_decode and flash_decode_paged at its 32 query and 4 kv
    heads (8 query heads per kv head)."""
    dev = torch.device("cuda")
    rows = []

    def randn(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16) * sc

    gg_src = "triton_dist_tpu_torch/kernels/csrc/grouped_gemm.cu"
    gg_rep = "triton_dist_tpu/kernels/group_gemm.py:74"
    for case, E, C, D, F, key in (
            ("7a decode gate_up", 128, 24, 2048, 1536, ("moe", "decode")),
            ("7b decode down", 128, 24, 768, 2048, ("moe", "decode")),
            ("7c prefill gate_up", 128, 2056, 2048, 1536, ("moe", "prefill")),
            ("7d prefill down", 128, 2056, 768, 2048, ("moe", "prefill")),
            ("ragged", 3, 200, 512, 320, ("moe", "paged"))):
        # x is a view of [E, C + 8, D] whose rows past C hold 100x values:
        # a kernel that reads past an expert's C rows fails the check
        xs = randn(E, C + 8, D)
        xs[:, C:] *= 100
        x = xs[:, :C]
        w = randn(E, D, F, sc=D ** -0.5)
        out = k.grouped_gemm(x, w)
        ref = k.grouped_gemm_ref(x, w)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        # both accumulate in f32 and round once to bf16: one bf16 ulp of
        # the largest output where the two sums straddle a rounding
        # boundary (a skipped 32-deep K panel moves outputs by about 10%)
        tol = 2 ** -7 * ref.float().abs().max().item()
        check(err <= tol, f"grouped_gemm {case}: max_abs_err {err} > tol {tol}")
        b_ms, b_by = bound(2 * (E * C * D + E * D * F + E * C * F), 2 * E * C * D * F)
        r = dict(name="grouped_gemm", case=f"{case} E={E} C={C} D={D} F={F} bf16",
                 route="cuda", source=gg_src, replaces=gg_rep, launches=None,
                 max_abs_err=err, tol=tol, ms=cuda_ms(lambda: k.grouped_gemm(x, w)),
                 plain_ms=cuda_ms(lambda: k.grouped_gemm_ref(x, w), reps=5),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=cuda_ms(lambda: torch.bmm(x, w)))
        rows.append((r, key))
        print(f"kernel grouped_gemm [{r['case']}]: max_abs_err {err:.3g} (tol {tol:.3g}) "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms (torch.bmm) "
              f"{r['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})", flush=True)
        del xs, x, w, out, ref
    torch.cuda.empty_cache()

    # flash kernels at 8 query heads per kv head: prefill S=128 over 128
    # keys and decode over 200, the cache tail poisoned as in the dense rows
    Hq, Hkv, d = 32, 4, 128
    fd_src = "triton_dist_tpu_torch/kernels/csrc/flash_decode.cu"
    fd_rep = "triton_dist_tpu/kernels/flash_attn.py:406"
    for phase, Sq, kv_len in (("prefill", S, S), ("decode", 1, KV_DECODE)):
        q = randn(B, Sq, Hq, d)
        kc = randn(B, Hkv, T_KERNEL, d)
        vc = randn(B, Hkv, T_KERNEL, d)
        kc[:, :, kv_len:] *= 100
        vc[:, :, kv_len:] *= 100
        keys = sum(kv_len - Sq + s + 1 for s in range(Sq)) * B * Hq
        out = k.flash_decode(q, kc, vc, kv_len)
        ref = k.flash_decode_ref(q, kc, vc, kv_len)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        tol = 1e-2 * (1 + ref.float().abs().max().item())
        check(err <= tol, f"flash_decode rep 8 {phase}: max_abs_err {err} > tol {tol}")
        b_ms, b_by = bound(2 * q.numel() * 2 + 2 * 2 * B * Hkv * kv_len * d, 4 * d * keys)
        qT, kT, vT = q.transpose(1, 2), kc[:, :, :kv_len], vc[:, :, :kv_len]
        r = dict(name="flash_decode",
                 case=f"{phase} S={Sq} kv_len={kv_len} T={T_KERNEL} Hq={Hq} Hkv={Hkv} bf16",
                 route="cuda", source=fd_src, replaces=fd_rep, launches=None,
                 max_abs_err=err, tol=tol, ms=cuda_ms(lambda: k.flash_decode(q, kc, vc, kv_len)),
                 plain_ms=cuda_ms(lambda: k.flash_decode_ref(q, kc, vc, kv_len), reps=5),
                 bound_ms=b_ms, bound_by=b_by,
                 library_ms=cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                     qT, kT, vT, is_causal=Sq > 1, enable_gqa=True)))
        rows.append((r, ("moe", phase)))
        print(f"kernel flash_decode [{r['case']}]: max_abs_err {err:.3g} (tol {tol:.3g}) "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})", flush=True)
        del q, kc, vc, out, ref

    # flash_decode_paged: 64 slots (the serving tick) at lengths in [1, 224];
    # every pool row no stream reads holds 100x values
    Bp, cap = SERVE_B, SERVE_MAX_SEQ
    maxp = cap // PAGE
    X = Bp * Hkv
    NP = 1 + X * maxp
    lens = torch.randint(1, cap + 1, (Bp,), generator=gen, device=dev, dtype=torch.int32)
    lens[:3] = torch.tensor([cap, 8 * PAGE, 1], dtype=torch.int32)
    table = (1 + torch.randperm(NP - 1, generator=gen, device=dev)[:X * maxp]
             ).reshape(X, maxp).to(torch.int32)
    lens_x = lens.repeat_interleave(Hkv)
    n_pages = (lens_x + PAGE - 1) // PAGE
    tpos = torch.arange(maxp * PAGE, device=dev)
    used = torch.zeros(NP * PAGE, dtype=torch.bool, device=dev)
    used[(table.long()[:, tpos // PAGE] * PAGE + tpos % PAGE)[
        tpos[None, :] < lens_x[:, None]]] = True
    pk = randn(NP, PAGE, d)
    pv = randn(NP, PAGE, d)
    pk[~used.reshape(NP, PAGE)] *= 100
    pv[~used.reshape(NP, PAGE)] *= 100
    q1 = randn(Bp, 1, Hq, d)
    out = k.flash_decode_paged(q1, pk, pv, table, kv_lens=lens)
    ref = k.flash_decode_paged_ref(q1, pk, pv, table, kv_lens=lens)
    torch.cuda.synchronize()
    err = max_err(out, ref)
    tol = 1e-2 * (1 + ref.float().abs().max().item())
    check(err <= tol, f"flash_decode_paged rep 8: max_abs_err {err} > tol {tol}")
    n_keys = int(lens.sum())
    b_ms, b_by = bound(2 * q1.numel() * 2 + 2 * Hkv * n_keys * d * 2
                       + int(n_pages.sum()) * 4 + Bp * 4, 4 * d * Hq * n_keys)
    r = dict(name="flash_decode_paged",
             case=f"slots={Bp} kv_lens in [1, {cap}] page={PAGE} Hq={Hq} Hkv={Hkv} bf16",
             route="cuda", source="triton_dist_tpu_torch/kernels/csrc/flash_decode_paged.cu",
             replaces="triton_dist_tpu/kernels/paged_kv.py:411", launches=None,
             max_abs_err=err, tol=tol,
             ms=cuda_ms(lambda: k.flash_decode_paged(q1, pk, pv, table, kv_lens=lens)),
             plain_ms=cuda_ms(lambda: k.flash_decode_paged_ref(q1, pk, pv, table,
                                                                kv_lens=lens), reps=5),
             bound_ms=b_ms, bound_by=b_by, library_ms=None)
    rows.append((r, ("moe", "paged")))
    print(f"kernel flash_decode_paged [{r['case']}]: max_abs_err {err:.3g} (tol {tol:.3g}) "
          f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})",
          flush=True)
    del pk, pv, out, ref
    torch.cuda.empty_cache()
    return rows


def moe_layer_phase(k, gen):
    """One full-width TP_MoE layer of Qwen3-30B-A3B (E=128, top-8,
    D=2048, I=768, bf16, capacity 2.0) at M=128 and M=16384 tokens:
    fwd_local (the grouped_gemm kernel) against the plain composition of
    the port's own pieces on the same input (hence the same routing), and
    at M=128 against the dense oracle fwd_xla."""
    from triton_dist_tpu_torch.kernels.ep_a2a import (group_tokens_by_expert, route,
                                                     scatter_weighted)
    from triton_dist_tpu_torch.layers import TP_MoE
    dev = torch.device("cuda")
    E, topk, D, I = 128, 8, 2048, 768

    def randn(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16) * sc

    layer = TP_MoE.init(randn(D, E, sc=0.02), randn(E, D, I, sc=D ** -0.5),
                        randn(E, D, I, sc=D ** -0.5), randn(E, I, D, sc=I ** -0.5),
                        top_k=topk, capacity_factor=2.0)

    def plain(x, kept=False):
        """The layer's plain composition; with kept, also which tokens
        kept all their entries."""
        M = x.shape[0]
        cap = layer._cap(M)
        topk_w, topk_idx = route(x @ layer.w_router, topk)
        x_e, inv, tok = group_tokens_by_expert(x, topk_idx, E, cap)
        y_e = layer._expert_mlp_sharded(x_e, gemm=k.grouped_gemm_ref)[0]
        y = scatter_weighted(y_e, inv, tok, topk_w, M).to(x.dtype)
        return (y, (inv < E * cap).reshape(M, topk).all(1)) if kept else y

    for M in (B, B * S):
        x = randn(M, D)
        k.reset_launch_counts()
        y, st = layer.fwd_local(x, return_stats=True)
        torch.cuda.synchronize()
        launches = k.launch_counts()["grouped_gemm"]
        check(launches == 2, f"moe layer M={M}: {launches} grouped_gemm launches, want 2")
        y_ref, kept = plain(x, kept=True)
        torch.cuda.synchronize()
        # the same routing and grouping; the products differ by a bf16 ulp
        # where f32 sums straddle a rounding boundary, then pass the SwiGLU
        # and the down product: 1e-2 of the largest output
        err = max_err(y, y_ref)
        tol = 1e-2 * y_ref.float().abs().max().item()
        check(err <= tol, f"moe layer M={M}: fwd_local vs plain max|d| {err} > {tol}")
        line = (f"moe layer M={M} cap={layer._cap(M)}: fwd_local vs plain composition "
                f"max|d| {err:.4g} (tol {tol:.4g}); drops {int(st['dropped'])} of "
                f"{M * topk} entries; ms fwd_local {cuda_ms(lambda: layer.fwd_local(x)):.4f} "
                f"plain {cuda_ms(lambda: plain(x), reps=5):.4f}")
        if M == B:
            y_x = layer.fwd_xla(x)
            torch.cuda.synchronize()
            # the oracle never drops: held on the tokens that kept all
            # their entries (every token when nothing dropped); 2e-2, as
            # its expert products run as bf16 einsums summed otherwise
            check(int(kept.sum()) > 0, f"moe layer M={M}: every token lost an entry")
            err_x = max_err(y[kept], y_x[kept])
            tol_x = 2e-2 * y_x[kept].float().abs().max().item()
            check(err_x <= tol_x,
                  f"moe layer M={M}: fwd_local vs fwd_xla max|d| {err_x} > {tol_x}")
            line += (f"; vs dense oracle fwd_xla on {int(kept.sum())} tokens max|d| "
                     f"{err_x:.4g} (tol {tol_x:.4g}), ms "
                     f"{cuda_ms(lambda: layer.fwd_xla(x), reps=5):.4f}")
        print(line, flush=True)
        del x, y, y_ref
    del layer
    torch.cuda.empty_cache()


def chunk_load(eng, logits, cache, pos, steps):
    """The routing load of `steps` slot-chunk decode steps from (logits,
    cache) with every row at position pos: the port's own [E+1] vector
    (per-expert routed entries, then the capacity drops), on the host."""
    B = logits.shape[0]
    pos = torch.full((B,), pos, dtype=torch.int32, device=logits.device)
    active = torch.ones(B, dtype=torch.bool, device=logits.device)
    return eng.slot_chunk(logits, cache, pos, active, chunk=steps)[4].cpu().numpy()


def moe_engine_phase(m, k, model, ids, card):
    """Qwen3-30B-A3B through Engine(backend="flash") at capacity 2.0:
    prefill B x S and GEN decode steps, timed, with exact launch counts,
    and the capacity drops of TF_STEPS decode steps from a fresh prefill
    (the slot chunk's routing load); then the dropless teacher-forced
    check against the plain backend with the routing pinned."""
    from triton_dist_tpu_torch.tools.fault_margin import RouteTape
    L, topk = model.config.num_layers, model.config.num_experts_per_tok
    eng = m.Engine(model, max_seq=S + GEN + 8, backend="flash")
    eng.decode(*eng.prefill(ids), 2)                    # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    c_prefill = k.launch_counts()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    toks = eng.decode(logits, cache, GEN)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    c_decode = k.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for label, c, fw in (("prefill", c_prefill, 1), ("decode", c_decode, GEN)):
        want = dict.fromkeys(c, 0)          # every other kernel: no launch
        want.update(grouped_gemm=2 * L * fw, flash_decode=L * fw, kv_update=2 * L * fw)
        check(c == want, f"moe engine {label}: launches {c}, want {want}")
    check(tuple(toks.shape) == (B, GEN), f"moe engine: tokens {tuple(toks.shape)}")
    check(bool(torch.isfinite(logits).all()), "moe engine: non-finite logits")
    profile_decode(eng, cache, toks[:, :2], "moe bf16", decode_s / GEN)
    del cache, logits
    load = chunk_load(eng, *eng.prefill(ids), S, TF_STEPS)
    check(int(load[:-1].sum()) == B * topk * L * TF_STEPS,
          f"moe engine: routed entries {int(load[:-1].sum())} over {TF_STEPS} steps")
    print(f"engine moe bf16 on {card}: prefill {prefill_s * 1e3:.1f} ms (B={B}, S={S}), "
          f"decode {GEN} steps {decode_s * 1e3:.1f} ms ({decode_s * 1e3 / GEN:.2f} ms/step) = "
          f"{B * GEN / decode_s:.1f} tok/s, peak memory {peak / 2**30:.2f} GiB; capacity "
          f"drops {int(load[-1])} of {int(load[:-1].sum())} routed entries over "
          f"{TF_STEPS} decode steps; launches prefill {c_prefill} decode {c_decode} "
          f"(per step {sum(c_decode.values()) // GEN})", flush=True)

    # teacher-forced, dropless: flash against the plain backend on the same
    # model, each step's plain forward replaying the flash forward's expert
    # selection (RouteTape). Left free, the two route 30% of (token, layer)
    # choices differently (near ties at rank 8/9 flip on bf16 noise) and
    # their logits part by 4.5-7.2%, more than a zeroed expert moves them.
    # Pinned, the clean gap is 1.3-1.8% of the largest logit on the H100,
    # and MOE_LIMIT 3e-2 sits below the planted grouped_gemm faults: one
    # expert zeroed 3.9-4.8%, a skipped K panel 12-15%
    # (tools/fault_margin.py --moe). Greedy tokens must agree wherever the
    # plain top-2 margin exceeds twice the limit.
    set_capacity(model, "dropless")
    try:
        ids_tf = ids[:MOE_TF_B, :MOE_TF_S]
        ref_eng = m.Engine(model, max_seq=MOE_TF_S + TF_STEPS + 8, backend="xla")
        eng_tf = m.Engine(model, max_seq=MOE_TF_S + TF_STEPS + 8, backend="flash")
        errs, forced, tape = [], 0, RouteTape()
        with tape.record():
            lf, cf = eng_tf.prefill(ids_tf)
        with tape.replay():
            lr, cr = ref_eng.prefill(ids_tf)
        for t in range(TF_STEPS + 1):
            check(tape.done(), f"moe dropless: step {t} replayed {tape.used} of "
                               f"{len(tape.calls)} routing calls")
            err, _, n_sure = margin_gate(lf, lr, f"moe dropless: step {t}", MOE_LIMIT)
            errs.append(round(err / lr.abs().max().item(), 5))
            forced += n_sure
            if t < TF_STEPS:
                tok = torch.argmax(lr, -1)
                with tape.record():
                    lf = eng_tf.decode_step(tok, cf)
                with tape.replay():
                    lr = ref_eng.decode_step(tok, cr)
        check(forced > 0, "moe dropless: no token passed the margin rule")
        # the dropless capacity on the tick path: four slot-chunk steps on
        # from the teacher-forced cache, with the chunk's own drop count
        load = chunk_load(eng_tf, lf, cf, MOE_TF_S + TF_STEPS, 4)
        check(int(load[-1]) == 0 and int(load[:-1].sum()) == MOE_TF_B * topk * L * 4,
              f"moe dropless: {int(load[-1])} entries dropped of {int(load[:-1].sum())}")
        print(f"engine moe dropless: teacher-forced vs plain backend, routing pinned, "
              f"B={MOE_TF_B} S={MOE_TF_S} and {TF_STEPS} steps: max|d logits| / "
              f"max|logit| per step {errs} (limit {MOE_LIMIT}), {forced} greedy tokens "
              f"checked; a 4-step slot chunk dropped {int(load[-1])} of "
              f"{int(load[:-1].sum())} routed entries", flush=True)
    finally:
        set_capacity(model, 2.0)
    return dict(prefill=c_prefill, decode=c_decode)


def profile_decode(eng, cache, toks, label, step_s):
    """Device time of two decode steps by kernel (torch.profiler), beside the
    step's wall time from the timed run: what share of a step the card
    is busy, and with what."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in range(toks.shape[1]):
            eng.decode_step(toks[:, t], cache)
        torch.cuda.synchronize()
    # device-side events only (kernels, copies, fills); the operator rows
    # on the host carry their kernels' device time too
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    steps = toks.shape[1]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / steps
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label} decode: device busy {busy_ms:.3f} ms per step of "
          f"{step_s * 1e3:.3f} ms wall ({1 - busy_ms / (step_s * 1e3):.1%} idle); "
          f"device launches per step {sum(e.count for e in ev) // steps}; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f} ms"
                      for e in top), flush=True)


def engine_phase(m, k, model, kv_dtype, label, ids, card, backend="flash"):
    """Drive Engine(backend) prefill + decode through the entry points,
    with the launch counts read around each; then hold the logits against
    the plain backend, teacher-forced."""
    eng = m.Engine(model, max_seq=S + GEN + 8, backend=backend, kv_dtype=kv_dtype)
    # warm-up (cuBLAS handles and heuristics, allocator), not counted
    eng.decode(*eng.prefill(ids), 2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = eng.prefill(ids)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    c_prefill = k.launch_counts()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    toks = eng.decode(logits, cache, GEN)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    c_decode = k.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # "dist" at one rank: every projection through the GEMM kernel (the
    # one-rank ag_gemm and gemm_rs), four a layer and forward
    per_op = ("flash_decode", "kv_update", "swiglu") + (("gemm",) if backend == "dist" else ())
    if backend == "dist":
        check(c_prefill["gemm"] == 4 * N_LAYERS and c_decode["gemm"] == 4 * N_LAYERS * GEN,
              f"{label}: gemm launched {c_prefill['gemm']} times in prefill and "
              f"{c_decode['gemm']} in decode, want {4 * N_LAYERS} and {4 * N_LAYERS * GEN}")
    for name in per_op:
        check(c_prefill[name] > 0 and (backend == "mega" or c_decode[name] > 0),
              f"{label}: kernel {name} did not run on the main path "
              f"(prefill {c_prefill[name]}, decode {c_decode[name]})")
    only_launched(c_prefill, per_op, f"{label} prefill")
    only_launched(c_decode, ("mega_decode",) if backend == "mega" else per_op,
                  f"{label} decode")
    if backend == "mega":
        # decode is the megakernel alone: one launch per layer per step
        check(c_decode["mega_decode"] == N_LAYERS * GEN,
              f"{label}: decode launches {c_decode}, want mega_decode == "
              f"{N_LAYERS * GEN}")
    check(tuple(toks.shape) == (B, GEN), f"{label}: tokens {tuple(toks.shape)}")
    check(bool(torch.isfinite(logits).all()), f"{label}: non-finite logits")
    print(f"engine {label} on {card}: prefill {prefill_s * 1e3:.1f} ms (B={B}, S={S}), "
          f"decode {GEN} steps {decode_s * 1e3:.1f} ms "
          f"({decode_s * 1e3 / GEN:.2f} ms/step) = "
          f"{B * GEN / decode_s:.1f} tok/s, peak memory {peak / 2**30:.2f} GiB; "
          f"launches prefill {c_prefill} decode {c_decode}", flush=True)

    # teacher-forced check: feed both backends the flash tokens and hold
    # the logits together at every step; greedy tokens must agree
    # wherever the plain backend's top-2 margin exceeds the tolerance
    ref_eng = m.Engine(model, max_seq=S + GEN + 8, backend="xla", kv_dtype=kv_dtype)
    lf, cf = eng.prefill(ids)
    lr, cr = ref_eng.prefill(ids)
    errs, tols, forced = [], [], 0
    for t in range(TF_STEPS + 1):
        # 5e-2 of the largest logit. The clean gap is about 2% (bf16
        # activations through 28 layers; the kernel rounds P to bf16
        # before the PV product, as the TPU kernel does, and the plain
        # attention keeps it in f32). Planted attention faults (a causal
        # leak, a dropped newest key, a missing softmax or V scale) give
        # 25% or more at their worst step
        # (triton_dist_tpu_torch/tools/fault_margin.py); a
        # read one key past kv_len stays within the clean gap here and is
        # caught by the kernel phase's cache-tail check instead.
        err, tol, n_sure = margin_gate(lf, lr, f"{label}: step {t}")
        errs.append(err)
        tols.append(tol)
        forced += n_sure
        if t == TF_STEPS:
            break
        lf = eng.decode_step(toks[:, t], cf)
        lr = ref_eng.decode_step(toks[:, t], cr)
    profile_decode(eng, cf, toks[:, TF_STEPS:TF_STEPS + 2], label, decode_s / GEN)
    print(f"engine {label}: teacher-forced vs plain backend, prefill and "
          f"{TF_STEPS} steps: max|d logits| per step "
          f"{[round(e, 4) for e in errs]} (tol {[round(x, 4) for x in tols]}), "
          f"{forced} greedy tokens checked", flush=True)
    return dict(prefill=c_prefill, decode=c_decode)


def serving_phase(m, k, model, kv_dtype, label, paged, reqs, card, backend="flash",
                  batch=SERVE_B, tf_reqs=TF_REQS, probe=True, prefill_budget=None):
    """Drive ContinuousScheduler through its entry points with the launch
    counts read around the run, then hold the tokens of tf_reqs seeded
    requests (0: none), teacher-forced, against the plain contiguous
    engine. With prefill_budget the admissions are chunked: they run no
    forward, and every prompt token goes through the mixed ticks."""
    eng = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend=backend, kv_dtype=kv_dtype)
    L = model.config.num_layers
    moe = model.config.is_moe

    def scheduler():
        return m.ContinuousScheduler(eng, batch=batch, chunk=SERVE_CHUNK,
                                     paged=paged, page=PAGE, prefill_budget=prefill_budget)

    # warm-up (cuBLAS handles and heuristics, allocator), not counted: two
    # requests cut to one chunk still admit, tick and retire
    scheduler().run([m.Request(r.rid, r.ids, SERVE_CHUNK) for r in reqs[:2]])
    sched = scheduler()
    ticks, mixed = count_ticks(sched)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    out = sched.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = k.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # drop the tick counters: they and the slots referred to each other
    del sched.slots.step_chunk, sched.slots.step_mixed
    st = sched.stats()
    # monolithic admissions run one batch-1 forward each; chunked ones none
    admits = 0 if prefill_budget else len(reqs) + st["preemptions"]
    steps = sum(ticks)
    fwd = steps + len(mixed)              # tick forwards: decode steps and mixed ticks
    if prefill_budget:
        check(st["max_prefill_tokens_per_poll"] <= prefill_budget,
              f"{label}: {st['max_prefill_tokens_per_poll']} prefill tokens in one poll, "
              f"budget {prefill_budget}")
    if moe:
        # admissions: one batch-1 flash forward each; ticks: the paged
        # attention per layer and forward; two grouped GEMMs per layer in all
        want = dict.fromkeys(counts, 0)     # every other kernel: no launch
        want.update(grouped_gemm=2 * L * (admits + fwd), flash_decode=L * admits,
                    kv_update=2 * L * admits, flash_decode_paged=L * fwd)
        check(paged and counts == want, f"{label}: launches {counts} for {steps} tick steps, "
                              f"{len(mixed)} mixed ticks and {admits} admissions, "
                              f"want {want}")
    elif prefill_budget:
        # chunked dense: every forward is a tick's (attention per layer and
        # forward, through the table when paged); no admission forward
        want = dict.fromkeys(counts, 0)
        want.update({"flash_decode_paged" if paged else "flash_decode": L * fwd,
                     "swiglu": L * fwd})
        check(counts == want, f"{label}: launches {counts} for {steps} tick steps and "
                              f"{len(mixed)} mixed ticks, want {want}")
    elif backend == "mega":
        # ticks: 28 megakernel launches per step and nothing else of the
        # per-op decode; admissions: one batch-1 flash forward each
        check(counts["mega_paged_decode"] == N_LAYERS * steps
              and counts["flash_decode"] == N_LAYERS * admits
              and counts["kv_update"] == 2 * N_LAYERS * admits
              and counts["swiglu"] == N_LAYERS * admits,
              f"{label}: launches {counts} for {steps} tick steps and {admits} "
              "admissions")
        only_launched(counts, ("mega_paged_decode", "flash_decode", "kv_update", "swiglu"),
                      label)
    else:
        path = (("flash_decode_paged",) if paged else ()) + ("flash_decode",
                                                             "kv_update", "swiglu")
        for name in path:
            check(counts[name] > 0, f"{label}: kernel {name} did not run on the "
                                    f"serving path ({counts})")
        only_launched(counts, path, label)
    check(not sched.rejected, f"{label}: rejected {sched.rejected}")
    check(all(len(out[r.rid]) == r.gen_len for r in reqs),
          f"{label}: a request did not get its budget")
    if paged:
        check(st["hits"] > 0, f"{label}: no prefix-cache hit")
    tokens = sum(r.gen_len for r in reqs)
    ttft, itl = st["ttft_ms"], st["inter_token_ms"]
    summary = dict(tok_per_s=tokens / wall, wall_s=wall, tokens=tokens,
                   ttft_p50_ms=ttft["p50"], ttft_p99_ms=ttft["p99"],
                   itl_p50_ms=itl["p50"], itl_p99_ms=itl["p99"],
                   prefill_skip_frac=st.get("prefill_skip_frac"), hits=st.get("hits"),
                   preemptions=st["preemptions"], peak_gib=peak / 2**30,
                   tick_steps=sum(ticks), mixed_ticks=len(mixed),
                   max_prefill_tokens_per_poll=st["max_prefill_tokens_per_poll"],
                   launches=counts)
    if moe:
        summary.update(moe_capacity_drops=st["moe_capacity_drops"],
                       expert_load_imbalance=st["expert_load_imbalance"],
                       expert_tokens=sum(st[f"expert_tokens{{expert={e}}}"]
                                         for e in range(model.config.num_experts)))
        # a mixed tick routes its whole [batch, budget] window, padding too
        rows = batch * steps + sum(batch * w for w in mixed)
        check(summary["expert_tokens"] == model.config.num_experts_per_tok * L * rows,
              f"{label}: expert_tokens {summary['expert_tokens']} for {steps} tick steps "
              f"and {len(mixed)} mixed ticks of {batch} slots")
    print(f"serving {label} on {card}: {json.dumps(summary)}", flush=True)
    if probe:
        tick_probe(m, k, eng, paged, reqs, label)
    if moe and model.layers[0].moe.capacity_factor == "dropless":
        check(st["moe_capacity_drops"] == 0, f"{label}: capacity drops while dropless")

    if moe:
        forced, worst = moe_served_check(m, model, reqs, out, tf_reqs, label)
    else:
        # teacher-forced: the plain engine over prompt + emitted tokens of
        # tf_reqs seeded requests, by the engine phase's margin rule
        held = np.random.RandomState(2).choice(len(reqs), tf_reqs, replace=False)
        forced, _ = tf_gate(m, model, kv_dtype, [(reqs[i].ids, out[reqs[i].rid]) for i in held],
                            label, SERVE_MAX_SEQ)
    check(forced > 0 or not tf_reqs, f"{label}: no token passed the margin rule")
    print(f"serving {label}: teacher-forced vs plain contiguous engine, "
          f"{tf_reqs} requests, {forced} tokens checked"
          + ("" if not (moe and tf_reqs) else f" against the contiguous flash engine (limit "
                                f"{MOE_SERVE_LIMIT}), whose logits on the served tokens "
                                f"are within {worst:.5f} of the largest plain logit with "
                                f"the routing pinned (limit {MOE_LIMIT})"),
          flush=True)
    del sched, eng
    torch.cuda.empty_cache()
    return counts


def spec_requests(m, vocab: int):
    """bench.py's speculative-decoding row (its budget cut): SPEC_B
    requests, each prompt its own seeded SPEC_PERIOD-token pattern tiled
    SPEC_REPS times plus its first two tokens, SPEC_GEN tokens each."""
    rng = np.random.RandomState(3)
    reqs = []
    for i in range(SPEC_B):
        pat = np.tile(rng.randint(0, vocab, SPEC_PERIOD), SPEC_REPS)
        reqs.append(m.Request(rid=i, ids=np.concatenate([pat, pat[:2]]).astype(np.int32),
                              gen_len=SPEC_GEN))
    return reqs


class OracleDrafter:
    """Proposes the tokens a spec=0 run emitted after the history (its
    drafts are accepted wherever the verify agrees with that run)."""

    def __init__(self, reqs, streams):
        self.by_prompt = {tuple(r.ids.tolist()): np.asarray(streams[r.rid]) for r in reqs}

    def propose(self, history, k):
        h = np.asarray(history)
        for p, s in self.by_prompt.items():
            if len(h) >= len(p) and tuple(h[:len(p)].tolist()) == p:
                done = len(h) - len(p)
                return [int(t) for t in s[done:done + k]]
        return []


class WrongDrafter:
    """Always wrong: every draft is rejected and every window rolls back."""

    def __init__(self, vocab):
        self.vocab = vocab

    def propose(self, history, k):
        return [(int(history[-1]) + 1) % self.vocab] * k


def spec_phase(m, k, model, card):
    """Speculative decoding at full width (bench.py:396-430): the spec
    requests through ContinuousScheduler(spec=SPEC_K, chunk 4), contiguous
    and paged, with the n-gram drafter, one that proposes the spec=0 run's
    tokens and one that is always wrong; exact launch counts, tokens per
    verify forward, accept rate, tok/s and ms per verify tick beside the
    spec=0 run. Every distinct served stream is held to the plain
    contiguous engine by the margin rule, and the verify program of each
    form is teacher-forced along the streams served in that form
    (verify_gate). Returns the launch counts of the n-gram runs."""
    cfg = model.config
    L = cfg.num_layers
    reqs = spec_requests(m, cfg.vocab_size)
    max_seq = len(reqs[0].ids) + SPEC_GEN + 8
    eng = m.Engine(model, max_seq=max_seq)
    counts = {}
    served = []                         # (prompt, stream) of every run

    def run(paged, spec, drafter=None):
        sched = m.ContinuousScheduler(eng, batch=SPEC_B, chunk=4, paged=paged, page=PAGE,
                                      spec=spec, drafter=drafter)
        torch.cuda.synchronize()
        k.reset_launch_counts()
        t0 = time.perf_counter()
        out = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return out, wall, k.launch_counts(), sched.stats()

    run(False, SPEC_K)                  # warm-up (cuBLAS heuristics of the windows)
    for paged in (False, True):
        form = "paged" if paged else "contiguous"
        base, b_wall, _, _ = run(paged, 0)
        streams = [(r.ids, base[r.rid]) for r in reqs]
        tokens = SPEC_B * SPEC_GEN
        print(f"spec {form} bf16 on {card}: spec=0: {tokens / b_wall:.1f} tok/s "
              f"({b_wall * 1e3:.1f} ms)", flush=True)
        for dname, drafter in (("ngram", None), ("oracle", OracleDrafter(reqs, base)),
                               ("wrong", WrongDrafter(cfg.vocab_size))):
            out, wall, c, st = run(paged, SPEC_K, drafter)
            verifies = st["spec_steps"]
            # admissions: one batch-1 forward each; verify ticks: one window
            # forward each (through the table when paged)
            want = dict.fromkeys(c, 0)
            want.update(flash_decode=L * SPEC_B + (0 if paged else L * verifies),
                        kv_update=2 * L * SPEC_B, swiglu=L * (SPEC_B + verifies))
            if paged:
                want["flash_decode_paged"] = L * verifies
            check(c == want, f"spec {form} {dname}: launches {c} for {verifies} verify "
                             f"ticks, want {want}")
            check(st["drafter_errors"] == 0, f"spec {form} {dname}: drafter errors")
            check(all(len(out[r.rid]) == SPEC_GEN for r in reqs),
                  f"spec {form} {dname}: a request did not get its budget")
            if dname == "ngram":
                counts[form] = c
            if dname == "wrong":
                check(st["spec_accepted"] == 0, f"spec wrong drafter: "
                                                f"{st['spec_accepted']} drafts accepted")
            streams += [(r.ids, out[r.rid]) for r in reqs]
            print(f"spec {form} bf16 K={SPEC_K} {dname} drafter: tokens per step "
                  f"{st['tokens_per_step']:.4f}, accept rate {st['spec_accept_rate']:.4f}, "
                  f"{tokens / wall:.1f} tok/s ({wall * 1e3:.1f} ms), {verifies} verify ticks "
                  f"at {wall * 1e3 / verifies:.3f} ms each; streams equal to spec=0: "
                  f"{sum(np.array_equal(out[r.rid], base[r.rid]) for r in reqs)}/{SPEC_B}",
                  flush=True)
        verify_gate(m, model, streams, paged, f"spec {form}", max_seq)
        served += streams
    forced, n = tf_gate(m, model, None, served, "spec", max_seq)
    print(f"spec: teacher-forced vs plain engine, {n} distinct streams of both forms and "
          f"every drafter, {forced} tokens checked", flush=True)
    del eng
    torch.cuda.empty_cache()
    return counts


def verify_gate(m, model, pairs, paged, label, max_seq, limit=5e-2):
    """The spec verify program (Engine.slot_verify_chunk, or
    paged_slot_verify_chunk through a shuffled page table) teacher-forced
    along the distinct served streams `pairs` [(prompt, stream)], one slot
    each: every call's window holds the stream's next q_len tokens at the
    slot's position (q_len seeded in [1, SPEC_K + 1]; in about half the
    rows one draft replaced by another token, so the verify rejects it and
    rolls back), the next call starting where that call's n_emit left the
    slot. The window forward's logits at every position whose inputs are
    all stream tokens must stay within `limit` of the largest logit of the
    plain engine ("xla") along the stream; the kept count, the next seed
    and the position must be the plain engine's wherever every comparison
    that decides them has a top-2 margin over twice that. Prints and
    returns (positions held, acceptances held)."""
    pairs = distinct(pairs)
    ids = np.stack([p for p, _ in pairs])
    streams = np.stack([s for _, s in pairs])
    Bv, plen = ids.shape
    gen = streams.shape[1]
    V = model.config.vocab_size
    S = SPEC_K + 1
    dev = model.device
    # the plain engine along every stream: lref[:, t] is the logits that
    # predict streams[:, t]
    ref = m.Engine(model, max_seq=max_seq, backend="xla")
    toks = torch.tensor(streams, device=dev)
    logits, cache = ref.prefill(ids)
    lref = [logits.float()]
    for t in range(gen - 1):
        lref.append(ref.decode_step(toks[:, t], cache).float())
    lref = torch.stack(lref, 1)                                 # [B, gen, V]
    del ref, cache, logits
    top2 = lref.topk(2, dim=-1).values
    sure = ((top2[..., 0] - top2[..., 1]) > 2 * limit * lref.abs().amax(-1)).cpu().numpy()
    nxt = lref.argmax(-1).cpu().numpy()

    eng = m.Engine(model, max_seq=max_seq)
    if paged:
        cache = eng.make_paged_slot_cache(Bv, page=PAGE)
        Hkv, maxp = model.config.num_kv_heads, cache.table.shape[1]
        pages = 1 + np.random.RandomState(8).permutation(cache.num_pages - 1)
        blocks = pages[:Bv * Hkv * maxp].reshape(Bv, Hkv, maxp).astype(np.int32)
        none = np.zeros(Hkv, np.int64)
        for b in range(Bv):
            eng.admit_slot_paged(cache, b, ids[b], blocks[b], 0, none, none, 0)
        verify, fwd_name = eng.paged_slot_verify_chunk, "forward_tokens_slots_paged_verify"
    else:
        cache = eng.make_slot_cache(Bv)
        for b in range(Bv):
            eng.prefill_into_slot(cache, b, ids[b])
        verify, fwd_name = eng.slot_verify_chunk, "forward_tokens_slots_verify"
    # the window forward's per-position logits, as the verify program sees them
    captured = []
    forward = getattr(model, fwd_name)

    def capture(*a, **kw):
        out = forward(*a, **kw)
        captured.append(out[0])
        return out

    rng = np.random.RandomState(7)
    t = np.zeros(Bv, np.int64)          # slot b's seed: streams[b, t[b]] at plen + t[b]
    n_pos = n_acc = n_seed = calls = 0
    worst = 0.0
    setattr(model, fwd_name, capture)
    try:
        while True:
            # column i predicts streams[b, t + 1 + i], so q_len <= gen - 1 - t
            ql = np.minimum(rng.randint(1, S + 1, Bv), gen - 1 - t).astype(np.int32)
            active = ql > 0
            if not active.any():
                break
            tokens = np.zeros((Bv, S), np.int64)
            bad = np.full(Bv, S)        # the replaced draft's column (S: none)
            for b in np.nonzero(active)[0]:
                tokens[b, :ql[b]] = streams[b, t[b]:t[b] + ql[b]]
                if ql[b] > 1 and rng.rand() < 0.5:
                    bad[b] = rng.randint(1, ql[b])
                    tokens[b, bad[b]] = (tokens[b, bad[b]] + 1) % V
            captured.clear()
            n_emit, t0n, cache, pos = verify(
                cache, torch.tensor(plen + t, dtype=torch.int32, device=dev),
                torch.tensor(active, device=dev), tokens, ql)
            calls += 1
            lf = captured[0].float()                            # [B, S, V]
            col = np.arange(S)[None]
            clean = torch.tensor(col < np.minimum(ql, bad)[:, None], device=dev)
            at = torch.tensor(np.minimum(t[:, None] + 1 + col, gen - 1), device=dev)
            lr = lref[torch.arange(Bv, device=dev)[:, None], at]    # [B, S, V]
            gap = ((lf - lr).abs().amax(-1) / lr.abs().amax(-1))[clean]
            if gap.numel():
                worst = max(worst, gap.max().item())
            check(worst <= limit, f"{label} verify: window logits max|d| / max|logit| "
                                  f"{worst} > {limit} at call {calls}")
            n_pos += int(clean.sum())
            ne, t0, po = (x.cpu().numpy() for x in (n_emit, t0n, pos))
            check(not ne[~active].any(), f"{label} verify: an idle slot emitted {ne}")
            for b in np.nonzero(active)[0]:
                acc, known = 0, True
                for j in range(1, ql[b]):
                    i = t[b] + j        # column j - 1's stream index
                    if j - 1 >= bad[b] or not sure[b, i]:
                        known = False
                        break
                    if tokens[b, j] != nxt[b, i]:
                        break
                    acc = j
                if known and ql[b] > 1:
                    check(ne[b] == 1 + acc, f"{label} verify: slot {b} at stream index "
                                            f"{t[b]} kept {ne[b]}, the plain engine {1 + acc}")
                    n_acc += 1
                if known and sure[b, t[b] + 1 + acc]:
                    check(t0[b] == nxt[b, t[b] + 1 + acc],
                          f"{label} verify: slot {b} next seed {t0[b]}, the plain engine "
                          f"{nxt[b, t[b] + 1 + acc]}")
                    n_seed += 1
                check(po[b] == plen + t[b] + ne[b], f"{label} verify: slot {b} position "
                                                    f"{po[b]}, want {plen + t[b] + ne[b]}")
                t[b] += ne[b]
    finally:
        delattr(model, fwd_name)
    check(n_pos > 0 and n_acc > 0, f"{label} verify: {n_pos} positions and {n_acc} "
                                   "acceptances held")
    print(f"{label} verify program teacher-forced along {Bv} distinct streams: {calls} "
          f"calls, {n_pos} window positions within {worst:.5f} of the largest plain logit "
          f"(limit {limit}); kept counts of {n_acc} draft windows and {n_seed} next seeds "
          "equal to the plain engine's", flush=True)
    del eng, cache, lref
    torch.cuda.empty_cache()
    return n_pos, n_acc


def chunked_requests(m, vocab: int):
    """bench.py's chunked-prefill row (its live requests' length cut):
    CL_LIVE live requests of CL_PLEN prompt tokens and CL_GEN tokens each,
    and one long CL_LONG-token prompt asking for 8."""
    rng = np.random.RandomState(6)
    live = [m.Request(rid=f"l{i}", ids=rng.randint(0, vocab, CL_PLEN).astype(np.int32),
                      gen_len=CL_GEN) for i in range(CL_LIVE)]
    return live, m.Request(rid="long", ids=rng.randint(0, vocab, CL_LONG).astype(np.int32),
                           gen_len=8)


def chunked_phase(m, k, model, kv_dtype, label, paged, card, compare=True):
    """Chunked prefill under decode load (bench.py:498-560): the live
    requests decode (chunk 2) when the long prompt arrives; its TTFT and
    the live streams' inter-token gaps until its first token, with
    prefill_budget CL_BUDGET and (compare) monolithic, in this run. The
    chunked run's launches are exact; every stream of both is held to the
    plain contiguous engine by the margin rule. Returns the chunked run's
    launch counts."""
    L = model.config.num_layers
    max_seq = CL_LONG + CL_GEN + 16
    eng = m.Engine(model, max_seq=max_seq, kv_dtype=kv_dtype)
    live, long_req = chunked_requests(m, model.config.vocab_size)
    res, served = {}, []

    def run(budget):
        sched = m.ContinuousScheduler(eng, batch=CL_LIVE + 1, chunk=2, paged=paged,
                                      page=PAGE, prefill_budget=budget)
        ticks, mixed = count_ticks(sched)
        acc = {r.rid: [] for r in live + [long_req]}

        def poll():
            out, _ = sched.poll()
            for rid, t in out.items():
                acc[rid].extend(t.tolist())
            return out

        torch.cuda.synchronize()
        k.reset_launch_counts()
        for r in live:
            sched.submit(r)
        for _ in range(4):                  # live slots armed and decoding
            poll()
        last = {r.rid: time.perf_counter() for r in live}
        gaps, ttft = [], None
        t_submit = time.perf_counter()
        sched.submit(long_req)
        while ttft is None:
            out = poll()
            now = time.perf_counter()
            for r in live:
                if len(out.get(r.rid, ())):
                    gaps.append(now - last[r.rid])
                    last[r.rid] = now
            if len(out.get("long", ())):
                ttft = now - t_submit
        while not sched.idle:
            poll()
        torch.cuda.synchronize()
        c = k.launch_counts()
        st = sched.stats()
        del sched.slots.step_chunk, sched.slots.step_mixed
        check(not sched.rejected, f"chunked {label}: rejected {sched.rejected}")
        return acc, ttft, gaps, c, st, sum(ticks), len(mixed)

    for budget in (CL_BUDGET, None) if compare else (CL_BUDGET,):
        name = "chunked" if budget else "monolithic"
        if label == "paged bf16":
            run(budget)                     # warm-up (the first arm of the phase)
        acc, ttft, gaps, c, st, steps, n_mixed = run(budget)
        if budget:
            check(st["max_prefill_tokens_per_poll"] <= budget,
                  f"chunked {label}: {st['max_prefill_tokens_per_poll']} prefill tokens in "
                  f"one poll, budget {budget}")
            fwd = steps + n_mixed
            want = dict.fromkeys(c, 0)
            want.update({"flash_decode_paged" if paged else "flash_decode": L * fwd,
                         "swiglu": L * fwd})
            check(c == want, f"chunked {label}: launches {c} for {steps} tick steps and "
                             f"{n_mixed} mixed ticks, want {want}")
            res["counts"] = c
        check(all(len(acc[r.rid]) == r.gen_len for r in live + [long_req]),
              f"chunked {label} {name}: a request did not get its budget")
        served += [(r.ids, acc[r.rid]) for r in live + [long_req]]
        g = np.asarray(gaps) * 1e3
        res[name] = ttft
        print(f"chunked {label} on {card}, {name}"
              + (f" (prefill_budget {budget})" if budget else "")
              + f": long request ({CL_LONG} tokens) TTFT {ttft * 1e3:.2f} ms under "
              f"{CL_LIVE} live streams; their inter-token gaps until then p50 "
              f"{np.percentile(g, 50):.3f} ms p99 {np.percentile(g, 99):.3f} ms max "
              f"{g.max():.3f} ms ({len(g)} gaps); max prefill tokens per poll "
              f"{st['max_prefill_tokens_per_poll']}; {steps} decode steps + {n_mixed} mixed "
              f"ticks; launches {c}", flush=True)
    forced, n = tf_gate(m, model, kv_dtype, served, f"chunked {label}", max_seq)
    print(f"chunked {label}: teacher-forced vs plain engine, {n} distinct streams, "
          f"{forced} tokens checked", flush=True)
    del eng
    torch.cuda.empty_cache()
    return res["counts"]


def chunked_first_poll(m, model, reqs, card):
    """The serving workload's first wave (SERVE_B requests) on the paged pool
    with prefill_budget SERVE_BUDGET: the first poll (SERVE_B chunked
    admissions, no forward, and one mixed tick), and the time until every
    request of the wave emitted its first token, beside the monolithic
    first poll of this run's paged bf16 serving phase."""
    eng = m.Engine(model, max_seq=SERVE_MAX_SEQ)
    sched = m.ContinuousScheduler(eng, batch=SERVE_B, chunk=SERVE_CHUNK, paged=True,
                                  page=PAGE, prefill_budget=SERVE_BUDGET)
    wave = reqs[:SERVE_B]
    for r in wave:
        sched.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seen = set()
    out, _ = sched.poll()
    first_s = time.perf_counter() - t0
    polls = 1
    while True:
        seen |= {rid for rid, t in out.items() if len(t)}
        if len(seen) == len(wave):
            break
        out, _ = sched.poll()
        polls += 1
    all_s = time.perf_counter() - t0
    print(f"tick paged bf16 prefill_budget {SERVE_BUDGET}: first poll ({SERVE_B} chunked "
          f"admissions + one mixed tick) {first_s * 1e3:.1f} ms (monolithic first poll of "
          f"this run: {FIRST_POLL_MS.get('paged bf16', float('nan')):.1f} ms; "
          f"4119.6 ms in the runs PERF.md records); every request of the wave streaming "
          f"after {polls} polls, {all_s * 1e3:.1f} ms", flush=True)
    del sched, eng
    torch.cuda.empty_cache()


def count_ticks(sched):
    """Count a scheduler's ticks: returns (the chunk lengths of its decode
    ticks, the window widths of its mixed ticks), lists filled as it
    runs. The caller deletes the wrappers afterwards (slots.step_chunk,
    slots.step_mixed), which refer to the slots."""
    ticks, mixed = [], []
    slots = sched.slots
    step_chunk, step_mixed = slots.step_chunk, slots.step_mixed
    slots.step_chunk = lambda chunk: ticks.append(chunk) or step_chunk(chunk)

    def counted_mixed(budget):
        mixed.append(max(budget, slots.spec + 1))
        return step_mixed(budget)

    slots.step_mixed = counted_mixed
    return ticks, mixed


def moe_served_check(m, model, reqs, out, n, label):
    """The first n requests of a MoE serving run, teacher-forced: the
    contiguous flash engine along prompt + served tokens, and the plain
    engine replaying its expert selection (RouteTape). Each served token
    must be the flash engine's argmax wherever that engine's top-2 margin
    exceeds twice MOE_SERVE_LIMIT of its largest logit. The served tick
    runs the same kernels, batched and through the page table, and still
    routes some tokens differently: on the H100 the clean served tokens
    that differ from that argmax do so at margins up to 2.9%, those of a
    planted grouped_gemm fault up to 6.7-6.9% (tools/fault_margin.py
    --moe). The flash logits must stay within MOE_LIMIT of the plain
    engine's. The n streams step together, each in a contiguous slot of
    its own. Returns (tokens checked, the largest relative logit gap)."""
    from triton_dist_tpu_torch.tools.fault_margin import RouteTape
    if not n:
        return 0, 0.0
    dev = model.device
    fl = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend="flash", device=dev)
    ref = m.Engine(model, max_seq=SERVE_MAX_SEQ, backend="xla", device=dev)
    rs = reqs[:n]
    # every request in a slot of its own, stepped together (dropless: a
    # row's routing does not depend on the others)
    cf, cr, tape = fl.make_slot_cache(n), ref.make_slot_cache(n), RouteTape()
    lf, lr = [], []
    for b, r in enumerate(rs):
        with tape.record():
            lf.append(fl.prefill_into_slot(cf, b, r.ids)[0])
        with tape.replay():
            lr.append(ref.prefill_into_slot(cr, b, r.ids)[0])
        check(tape.done(), f"{label}: request {r.rid}'s prefill replayed {tape.used} of "
                           f"{len(tape.calls)} routing calls")
    lf, lr = torch.stack(lf), torch.stack(lr)
    lens = torch.tensor([r.gen_len for r in rs], device=dev)
    gen = max(r.gen_len for r in rs)
    toks = torch.zeros((n, gen), dtype=torch.int64, device=dev)
    for b, r in enumerate(rs):
        toks[b, :r.gen_len] = torch.as_tensor(np.asarray(out[r.rid]), device=dev)
    pos = torch.tensor([len(r.ids) for r in rs], dtype=torch.int32, device=dev)
    forced, worst = 0, 0.0
    for t in range(gen):
        live = t < lens
        gap = ((lf - lr).abs().amax(-1) / lr.abs().amax(-1))[live].max().item()
        check(tape.done() and gap <= MOE_LIMIT,
              f"{label}: step {t} flash logits max|d| / max|logit| {gap} > {MOE_LIMIT} "
              "(routing pinned)")
        worst = max(worst, gap)
        top2 = lf.topk(2, dim=-1).values
        sure = ((top2[:, 0] - top2[:, 1]) > 2 * MOE_SERVE_LIMIT * lf.abs().amax(-1)) & live
        check(bool((torch.argmax(lf, -1) == toks[:, t])[sure].all()),
              f"{label}: step {t}: a served token differs from the contiguous flash engine "
              "where the margin exceeds the tolerance")
        forced += int(sure.sum())
        if t + 1 < gen:
            # a row past its stream's end steps on, its logits unread
            with tape.record():
                lf, cf = model.forward_tokens_slots(toks[:, t:t + 1], cf, pos, mode="flash")
            with tape.replay():
                lr, cr = model.forward_tokens_slots(toks[:, t:t + 1], cr, pos, mode="xla")
            pos = torch.clamp(pos + 1, max=SERVE_MAX_SEQ - 1)
    del fl, ref, cf, cr
    return forced, worst


def tick_probe(m, k, eng, paged, reqs, label):
    """One wave of SERVE_B requests admitted by one poll (timed), then two
    bare decode ticks on the resulting slots: the first, of SERVE_CHUNK
    steps, under torch.cuda.set_sync_debug_mode("error"), so a tick that
    synchronises with the host fails the run, and timed with no profiler;
    the second, of PROFILE_STEPS steps, under torch.profiler for the
    device's busy time per step by kernel, hence the tick's idle share."""
    from torch.profiler import ProfilerActivity, profile
    sched = m.ContinuousScheduler(eng, batch=SERVE_B, chunk=SERVE_CHUNK, paged=paged,
                                  page=PAGE)
    for r in reqs[:SERVE_B]:
        sched.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched.poll()                         # SERVE_B admissions + one tick
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    FIRST_POLL_MS[label] = first_s * 1e3
    slots = sched.slots
    tick = eng.paged_slot_chunk if paged else eng.slot_chunk

    def run_tick(steps=SERVE_CHUNK):
        slots.logits, slots.cache, slots.pos = tick(
            slots.logits, slots.cache, slots.pos, slots.active, chunk=steps)[1:4]

    k.reset_launch_counts()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run_tick()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    tick_s = time.perf_counter() - t0
    counts = k.launch_counts()
    if eng.backend == "mega":
        check(counts["mega_paged_decode"] == N_LAYERS * SERVE_CHUNK
              and sum(counts.values()) == counts["mega_paged_decode"],
              f"tick {label}: launches {counts}, want only mega_paged_decode == "
              f"{N_LAYERS * SERVE_CHUNK}")
    if eng.moe_family:
        L = eng.model.config.num_layers
        attn = "flash_decode_paged" if paged else "flash_decode"
        check(counts["grouped_gemm"] == 2 * L * SERVE_CHUNK
              and counts[attn] == L * SERVE_CHUNK
              and sum(counts.values()) == 3 * L * SERVE_CHUNK,
              f"tick {label}: launches {counts}, want grouped_gemm == "
              f"{2 * L * SERVE_CHUNK} and {attn} == {L * SERVE_CHUNK} only")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_tick(PROFILE_STEPS)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3 / PROFILE_STEPS
    step_ms = tick_s * 1e3 / SERVE_CHUNK
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    print(f"tick {label}: first poll ({SERVE_B} admissions + one tick) "
          f"{first_s * 1e3:.1f} ms; a bare tick of {SERVE_CHUNK} steps with no "
          f"host sync (sync debug mode 'error'): {step_ms:.3f} ms/step wall, device "
          f"busy {busy_ms:.3f} ms/step ({1 - busy_ms / step_ms:.1%} idle), "
          f"device launches per step {sum(e.count for e in ev) // PROFILE_STEPS}, "
          f"kernel launches {counts}; top: "
          + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3 / PROFILE_STEPS:.3f} ms"
                      for e in top), flush=True)
    del sched, slots


def train_kernel_phase(k, gen):
    """Rows 1i (flash_decode_partial), 8 (dq), 9 (dk/dv) and 14/15 (gemm)
    at the shapes of the training step (Qwen3-1.7B, B=4, S=T=1024,
    M = B*S = 4096), each held against its plain version."""
    import torch.nn.functional as F
    from triton_dist_tpu_torch.kernels import flash_attn as fa
    from triton_dist_tpu_torch.kernels import flash_attn_train as fat
    dev = torch.device("cuda")
    rows = []
    key = ("train", "step")

    def row(name, case, source, replaces, err, tol, kernel_fn, plain_fn, library_fn,
            nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
        check(err <= tol, f"{name} {case}: max_abs_err {err} > tol {tol}")
        b_ms, b_by = bound(nbytes, flops, flops_per_s)
        r = dict(name=name, case=case, route="cuda", source=source, replaces=replaces,
                 launches=None, max_abs_err=err, tol=tol, ms=cuda_ms(kernel_fn),
                 plain_ms=cuda_ms(plain_fn, reps=5), bound_ms=b_ms, bound_by=b_by,
                 library_ms=None if library_fn is None else cuda_ms(library_fn))
        rows.append((r, key))
        print(f"kernel {name} [{case}]: max_abs_err {err:.3g} (tol {tol:.3g}) "
              f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
              f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)} "
              f"bound_ms {b_ms:.4f} ({b_by})", flush=True)

    def randn(*shape, sc=1.0):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16) * sc

    Bt, St, Hq, Hkv, d = TRAIN_B, TRAIN_S, 16, 8, 128
    rep, X, T = Hq // Hkv, TRAIN_B * Hkv, TRAIN_S
    scale = d ** -0.5
    q, kk, vv = randn(Bt, St, Hq, d), randn(Bt, Hkv, T, d), randn(Bt, Hkv, T, d)
    pairs = Bt * Hq * St * (St + 1) // 2          # causal (query, key) pairs
    fd_src = "triton_dist_tpu_torch/kernels/csrc/flash_decode.cu"
    acc, m_, l_ = fa._partial(q, kk, vv, T, 0, scale)
    acc_r, m_r, l_r = fa._partial_ref(q, kk, vv, T, 0, scale)
    torch.cuda.synchronize()
    # m and l: f32 logits on both sides, l summed in another order; acc:
    # the kernel rounds P to bf16 before the PV product (as the TPU
    # kernel), the plain version keeps it in f32
    m_err, l_err = max_err(m_, m_r), max_err(l_, l_r) / l_r.abs().max().item()
    check(m_err <= 1e-3 and l_err <= 1e-4, f"flash_decode_partial: m error {m_err} "
          f"(tol 1e-3), l error {l_err} of the largest l (tol 1e-4)")
    qT, kT, vT = q.transpose(1, 2), kk, vv
    row("flash_decode_partial", f"1i training forward B={Bt} S=T={St} Hq={Hq} Hkv={Hkv} "
        f"d={d} bf16 (acc; m err {m_err:.3g}, l err {l_err:.3g} of max)", fd_src,
        "triton_dist_tpu/kernels/flash_attn.py:406", max_err(acc, acc_r),
        1e-2 * (1 + acc_r.abs().max().item()),
        lambda: fa._partial(q, kk, vv, T, 0, scale),
        lambda: fa._partial_ref(q, kk, vv, T, 0, scale),
        lambda: F.scaled_dot_product_attention(qT, kT, vT, is_causal=True, enable_gqa=True),
        2 * q.numel() + 2 * 2 * kk.numel() + 4 * acc.numel() + 2 * 4 * m_.numel(),
        4 * d * pairs)

    # the backward at the same shape, lse and D from the plain forward
    do = randn(Bt, St, Hq, d)
    qx = fat._fold_q(q, Hkv).contiguous()
    dox = fat._fold_q(do, Hkv).contiguous()
    kx, vx = kk.reshape(X, T, d), vv.reshape(X, T, d)
    lse = m_r + torch.log(l_r.clamp_min(1e-30))
    dvec = (dox.float() * (acc_r / l_r.clamp_min(1e-30)[..., None])).sum(-1)
    del acc, m_, l_, acc_r, m_r, l_r
    args = (qx, kx, vx, dox, lse, dvec, T, 0)
    kw = dict(scale=scale, rep=rep)
    dq = fat.flash_attention_bwd_dq(*args, **kw)
    dk, dv = fat.flash_attention_bwd_dkdv(*args, **kw)
    dq_r = fat.flash_attention_bwd_dq_ref(*args, **kw)
    dk_r, dv_r = fat.flash_attention_bwd_dkdv_ref(*args, **kw)
    torch.cuda.synchronize()
    # one SDPA backward computes dq, dk and dv together: the yardstick of
    # both rows
    qs, ks, vs = (t.detach().requires_grad_() for t in (qT, kT, vT))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True, enable_gqa=True)
    gout = do.transpose(1, 2)

    def library():
        torch.autograd.grad(out, (qs, ks, vs), gout, retain_graph=True)
    bwd_src = "triton_dist_tpu_torch/kernels/csrc/flash_attn_bwd.cu"
    in_bytes = 2 * (qx.numel() + kx.numel() + vx.numel() + dox.numel()) + 4 * 2 * lse.numel()
    # both kernels round P and dS to bf16 as the plain version does and
    # sum in f32 in another order: within 1% of the largest output
    row("flash_attn_bwd_dq", f"8 dq B={Bt} S=T={St} Hq={Hq} Hkv={Hkv} d={d} bf16", bwd_src,
        "triton_dist_tpu/kernels/flash_attn_train.py:266", max_err(dq, dq_r),
        1e-2 * dq_r.abs().max().item(), lambda: fat.flash_attention_bwd_dq(*args, **kw),
        lambda: fat.flash_attention_bwd_dq_ref(*args, **kw), library,
        in_bytes + 2 * dq.numel(), 6 * d * pairs)
    err = max(max_err(dk, dk_r) / dk_r.abs().max().item(),
              max_err(dv, dv_r) / dv_r.abs().max().item())
    row("flash_attn_bwd_dkdv", f"9 dk/dv B={Bt} S=T={St} Hq={Hq} Hkv={Hkv} d={d} bf16 "
        "(error as a share of the largest output)", bwd_src,
        "triton_dist_tpu/kernels/flash_attn_train.py:283", err, 1e-2,
        lambda: fat.flash_attention_bwd_dkdv(*args, **kw),
        lambda: fat.flash_attention_bwd_dkdv_ref(*args, **kw), library,
        in_bytes + 2 * (dk.numel() + dv.numel()), 8 * d * pairs)
    del q, kk, vv, do, qx, dox, kx, vx, dq, dk, dv, dq_r, dk_r, dv_r, qs, ks, vs, out, gout
    torch.cuda.empty_cache()

    # the backward kernels' other arguments: queries after the first key
    # (q_off > 0, T > S), keys cut short (valid_len < T, the SP ring
    # backward's chunks), head dim 64, f32; lse and D from the plain forward
    for case, Bc, Sc, Tc, Hqc, Hkvc, dc, dt, q_off, valid in (
            ("T>S q_off>0", 2, 256, 1024, 16, 8, 128, torch.bfloat16, 768, 1024),
            ("valid_len<T", 2, 512, 1024, 16, 8, 128, torch.bfloat16, 512, 900),
            ("hd 64 f32", 2, 256, 256, 8, 4, 64, torch.float32, 0, 256)):
        repc, Xc, sc = Hqc // Hkvc, Bc * Hkvc, dc ** -0.5
        gq = lambda *shape: torch.randn(shape, generator=gen, device=dev, dtype=dt)
        q, kk, vv, do = gq(Bc, Sc, Hqc, dc), gq(Bc, Hkvc, Tc, dc), gq(Bc, Hkvc, Tc, dc), \
            gq(Bc, Sc, Hqc, dc)
        acc_r, m_r, l_r = fa._partial_ref(q, kk, vv, valid, q_off, sc)
        qx, dox = fat._fold_q(q, Hkvc).contiguous(), fat._fold_q(do, Hkvc).contiguous()
        kx, vx = kk.reshape(Xc, Tc, dc), vv.reshape(Xc, Tc, dc)
        lse = m_r + torch.log(l_r.clamp_min(1e-30))
        dvec = (dox.float() * (acc_r / l_r.clamp_min(1e-30)[..., None])).sum(-1)
        args = (qx, kx, vx, dox, lse, dvec, valid, q_off)
        kw = dict(scale=sc, rep=repc)
        dq, (dk, dv) = fat.flash_attention_bwd_dq(*args, **kw), \
            fat.flash_attention_bwd_dkdv(*args, **kw)
        dq_r, (dk_r, dv_r) = fat.flash_attention_bwd_dq_ref(*args, **kw), \
            fat.flash_attention_bwd_dkdv_ref(*args, **kw)
        torch.cuda.synchronize()
        # the library: one SDPA backward with the same causal frontier and
        # key cut as a boolean mask
        s_i, t_i = torch.arange(Sc, device=dev)[:, None], torch.arange(Tc, device=dev)[None]
        mask = (t_i <= q_off + s_i) & (t_i < valid)
        qs, ks, vs = (t.detach().requires_grad_() for t in (q.transpose(1, 2), kk, vv))
        out = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)
        gout = do.transpose(1, 2)

        def library(out=out, qs=qs, ks=ks, vs=vs, gout=gout):
            torch.autograd.grad(out, (qs, ks, vs), gout, retain_graph=True)
        # bf16 as above; f32 (nothing rounded) sums in another order
        rel = 1e-2 if dt == torch.bfloat16 else 1e-3
        rate = BF16_FLOPS_PER_S if dt == torch.bfloat16 else F32_FLOPS_PER_S
        pairs_c = Bc * Hqc * sum(min(q_off + s + 1, valid) for s in range(Sc))
        esz = 2 if dt == torch.bfloat16 else 4
        in_b = esz * (qx.numel() + kx.numel() + vx.numel() + dox.numel()) + 8 * lse.numel()
        label = f"B={Bc} S={Sc} T={Tc} q_off={q_off} valid_len={valid} Hq={Hqc} " \
                f"Hkv={Hkvc} d={dc} {'bf16' if dt == torch.bfloat16 else 'f32'}"
        row("flash_attn_bwd_dq", f"8 dq {case} {label} (error as a share of the largest "
            "output)", bwd_src, "triton_dist_tpu/kernels/flash_attn_train.py:266",
            max_err(dq, dq_r) / dq_r.abs().max().item(), rel,
            lambda: fat.flash_attention_bwd_dq(*args, **kw),
            lambda: fat.flash_attention_bwd_dq_ref(*args, **kw), library,
            in_b + esz * dq.numel(), 6 * dc * pairs_c, rate)
        err = max(max_err(dk, dk_r) / dk_r.abs().max().item(),
                  max_err(dv, dv_r) / dv_r.abs().max().item())
        row("flash_attn_bwd_dkdv", f"9 dk/dv {case} {label} (error as a share of the "
            "largest output)", bwd_src, "triton_dist_tpu/kernels/flash_attn_train.py:283",
            err, rel, lambda: fat.flash_attention_bwd_dkdv(*args, **kw),
            lambda: fat.flash_attention_bwd_dkdv_ref(*args, **kw), library,
            in_b + esz * (dk.numel() + dv.numel()), 8 * dc * pairs_c, rate)
        del q, kk, vv, do, qx, dox, kx, vx, dq, dk, dv, dq_r, dk_r, dv_r, acc_r, m_r, l_r
        del qs, ks, vs, out, gout, library
    torch.cuda.empty_cache()

    gemm_src = "triton_dist_tpu_torch/kernels/csrc/gemm.cu"
    ag_rep = "triton_dist_tpu/kernels/allgather_gemm.py:341"
    rs_rep = "triton_dist_tpu/kernels/gemm_reduce_scatter.py:315"
    M = TRAIN_B * TRAIN_S
    for case, K, N, rep_at, transposed in (
            ("14 ag_gemm qkv", 2048, 4096, ag_rep, False),
            ("15 gemm_rs o", 2048, 2048, rs_rep, False),
            ("14 ag_gemm gate_up", 2048, 12288, ag_rep, False),
            ("15 gemm_rs down", 6144, 2048, rs_rep, False),
            ("15 gemm_rs gate_up backward da = dy @ W^T (W^T a view)", 12288, 2048, rs_rep,
             True)):
        a = randn(M, K)
        b = randn(N, K, sc=K ** -0.5).T if transposed else randn(K, N, sc=K ** -0.5)
        out = k.gemm(a, b)
        ref = k.gemm_ref(a, b)
        torch.cuda.synchronize()
        # both accumulate in f32 and round once to bf16: one bf16 ulp of
        # the largest output where the two sums straddle a rounding boundary
        row("gemm", f"{case} M={M} K={K} N={N} bf16", gemm_src, rep_at, max_err(out, ref),
            2 ** -7 * ref.float().abs().max().item(), lambda: k.gemm(a, b),
            lambda: k.gemm_ref(a, b), lambda: a @ b, 2 * (M * K + K * N + M * N),
            2 * M * N * K)
        del a, b, out, ref
    # the f32 path with ragged M and N edges (no multiple of a tile), b a
    # transposed view: f32 sums in another order, 1e-5 of the largest output
    Mf, Kf, Nf = 1000, 300, 770
    a = torch.randn(Mf, Kf, generator=gen, device=dev)
    b = (torch.randn(Nf, Kf, generator=gen, device=dev) * Kf ** -0.5).T
    out, ref = k.gemm(a, b), k.gemm_ref(a, b)
    torch.cuda.synchronize()
    row("gemm", f"ragged f32 M={Mf} K={Kf} N={Nf} (b a transposed view)", gemm_src, rs_rep,
        max_err(out, ref), 1e-5 * ref.abs().max().item(), lambda: k.gemm(a, b),
        lambda: k.gemm_ref(a, b), lambda: a @ b, 4 * (Mf * Kf + Kf * Nf + Mf * Nf),
        2 * Mf * Nf * Kf, F32_FLOPS_PER_S)
    del a, b, out, ref
    torch.cuda.empty_cache()
    return rows


def dist_gemm_rows(k, gen):
    """Rows 14c-14d and 15e-15f (gemm, the one-rank ag_gemm and gemm_rs of
    Engine(backend="dist")) at the decode step's projections (B=128 rows
    of Qwen3-1.7B: QKV, gate/up, O, down), bf16 and int8 QuantW panels,
    each held against its plain version within one bf16 ulp of its
    largest output. Their launches are the dist engine's decode."""
    dev = torch.device("cuda")
    src = "triton_dist_tpu_torch/kernels/csrc/gemm.cu"
    rows = []
    for case, K, N, rep_at in (
            ("14c ag_gemm qkv", 2048, 4096, "triton_dist_tpu/kernels/allgather_gemm.py:341"),
            ("14d ag_gemm gate_up", 2048, 12288,
             "triton_dist_tpu/kernels/allgather_gemm.py:341"),
            ("15e gemm_rs o", 2048, 2048, "triton_dist_tpu/kernels/gemm_reduce_scatter.py:315"),
            ("15f gemm_rs down", 6144, 2048,
             "triton_dist_tpu/kernels/gemm_reduce_scatter.py:315")):
        a = torch.randn(B, K, generator=gen, device=dev).bfloat16()
        w = (torch.randn(K, N, generator=gen, device=dev) * K ** -0.5).bfloat16()
        for wt, b in (("bf16", w), ("int8", k.quantize_int8(w))):
            out, ref = k.gemm(a, b), k.gemm_ref(a, b)
            torch.cuda.synchronize()
            err, tol = max_err(out, ref), 2 ** -7 * ref.float().abs().max().item()
            check(err <= tol, f"gemm {case} {wt}: max_abs_err {err} > tol {tol}")
            wbytes = K * N * 2 if wt == "bf16" else K * N + 4 * N
            b_ms, b_by = bound(2 * B * K + wbytes + 2 * B * N, 2 * B * K * N)
            r = dict(name="gemm", case=f"{case} M={B} K={K} N={N} {wt} (dist decode, one "
                     "rank)", route="cuda", source=src, replaces=rep_at, launches=None,
                     max_abs_err=err, tol=tol, ms=cuda_ms(lambda: k.gemm(a, b)),
                     plain_ms=cuda_ms(lambda: k.gemm_ref(a, b), reps=5), bound_ms=b_ms,
                     bound_by=b_by,
                     library_ms=cuda_ms(lambda: a @ b) if wt == "bf16" else None)
            rows.append((r, (wt, "dist decode")))
            print(f"kernel gemm [{r['case']}]: max_abs_err {err:.3g} (tol {tol:.3g}) ms "
                  f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} library_ms "
                  f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 4)}"
                  f" bound_ms {b_ms:.4f} ({b_by})", flush=True)
    return rows


def train_phase(m, k, card):
    """Qwen3-1.7B at full width and depth (28 layers, bf16, random weights
    from a seeded generator) through DenseLLM.forward_train under
    torch.autograd: one checked step through mode "train" with exact
    launch counts, its loss and every gradient held against the plain
    mode "xla", timings, a profiled step, then TRAIN_STEPS SGD steps on
    the same batch with a falling loss."""
    from torch.profiler import ProfilerActivity, profile
    from triton_dist_tpu_torch.tools.fault_margin import (grad_gaps, grads_of, train_batch,
                                                          train_loss)
    cfg = m.qwen3_1p7b()
    model = m.AutoLLM.from_config(cfg, device="cuda", seed=0).requires_grad_()
    ids, labels = train_batch(cfg, TRAIN_B, TRAIN_S)
    L = cfg.num_layers
    grads_of(model, ids, labels, "train")          # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k.reset_launch_counts()
    t0 = time.perf_counter()
    loss = train_loss(model, ids, labels, "train")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = k.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = dict.fromkeys(counts, 0)
    want.update(flash_decode_partial=L, flash_attn_bwd_dq=L, flash_attn_bwd_dkdv=L,
                gemm=8 * L)
    check(counts == want, f"train step launches {counts}, want {want}")
    loss_k = loss.item()
    grads_k = {n: p.grad for n, p in model.named_parameters()}
    for _, p in model.named_parameters():
        p.grad = None
    fwd_ms, bwd_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
    tokens = TRAIN_B * TRAIN_S
    n_mm = sum(t.numel() for n, t in model.named_parameters()
               if n.endswith(("w_qkv", "w_o", "w_gate_up", "w_down", "lm_head")))
    # attention: QK^T and PV forward, twice that backward
    attn_flops = 3 * 4 * cfg.head_dim * L * TRAIN_B * cfg.num_heads * TRAIN_S * (TRAIN_S + 1) // 2
    flops = 6 * n_mm * tokens + attn_flops
    step_s = (t2 - t0)
    print(f"train step on {card}: Qwen3-1.7B {L} layers bf16, B={TRAIN_B} S={TRAIN_S}: "
          f"loss {loss_k:.5f}, forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms, "
          f"{tokens / step_s:.1f} tokens/s, {flops / 1e12:.2f} TFLOP a step (6 x {n_mm} "
          f"matmul params x {tokens} tokens + {attn_flops / 1e12:.2f} attention) = "
          f"{flops / step_s / 1e12:.1f} TFLOP/s, {flops / step_s / BF16_FLOPS_PER_S:.1%} of "
          f"the bf16 peak; peak memory {peak / 2**30:.2f} GiB; launches {counts}",
          flush=True)

    # the gate: the plain path on the same weights and batch
    torch.cuda.reset_peak_memory_stats()
    loss_x, grads_x = grads_of(model, ids, labels, "xla")
    loss_gap = abs(loss_k - loss_x) / abs(loss_x)
    gaps = grad_gaps(grads_k, grads_x)
    worst = max(gaps, key=gaps.get)
    gap = gaps[worst]
    print(f"train gate: loss {loss_k:.6f} (train) vs {loss_x:.6f} (xla), gap {loss_gap:.3g} "
          f"(limit {TRAIN_LOSS_LIMIT}); worst gradient gap {gap:.4f} of its largest value "
          f"({worst}; limit {TRAIN_GRAD_LIMIT}), median "
          f"{sorted(gaps.values())[len(gaps) // 2]:.4f}; plain path peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(loss_gap <= TRAIN_LOSS_LIMIT and gap <= TRAIN_GRAD_LIMIT,
          f"train gate: loss gap {loss_gap} (limit {TRAIN_LOSS_LIMIT}), gradient gap {gap} "
          f"({worst}; limit {TRAIN_GRAD_LIMIT})")
    del grads_k, grads_x

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grads_of(model, ids, labels, "train")
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ev) / 1e3
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile train step: device busy {busy_ms:.1f} ms of {step_s * 1e3:.1f} ms wall "
          f"({1 - busy_ms / (step_s * 1e3):.1%} idle; {prof_s * 1e3:.1f} ms under the "
          f"profiler), device launches {sum(e.count for e in ev)}; top: "
          + "; ".join(f"{e.key[:50]} {e.self_device_time_total / 1e3:.2f} ms" for e in top),
          flush=True)

    losses = []
    for _ in range(TRAIN_STEPS):
        loss, grads = grads_of(model, ids, labels, "train")
        losses.append(loss)
        with torch.no_grad():
            for n, p in model.named_parameters():
                p -= TRAIN_LR * grads[n]
        del grads
    with torch.no_grad():
        losses.append(train_loss(model, ids, labels, "train").item())
    print(f"train SGD (lr {TRAIN_LR}, same batch): loss per step "
          f"{[round(x, 5) for x in losses]}", flush=True)
    check(all(np.isfinite(losses)) and all(b < a for a, b in zip(losses, losses[1:])),
          f"train SGD: the loss did not fall at every step: {losses}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def gdn_partial_phase(k, gen):
    """Rows 10a-10e (gdn_fwd) and 4h-4i (flash_decode_paged_partial), each
    held against its plain version and timed beside its bound; no one
    PyTorch call computes either function (library null)."""
    from triton_dist_tpu_torch.tools import fault_margin as fm
    rows = []
    key = ("registry", "drive")
    gdn_src = "triton_dist_tpu_torch/kernels/csrc/gdn.cu"
    for case in fm.GDN_CASES:
        name, B_, H, T, dk, dv, C, dt, _, decay = case
        kw = fm.gdn_case(name)
        k.reset_launch_counts()
        out = k.gdn_fwd(**kw)
        torch.cuda.synchronize()
        c = k.launch_counts()
        check(c["gdn_fwd"] == 1, f"gdn {name}: {c['gdn_fwd']} gdn_fwd launches, want 1")
        only_launched(c, ("gdn_fwd",), f"gdn {name}")
        ref = k.gdn_chunk_ref(**kw)
        err = fm.gdn_gap(out, ref)
        check(all(bool(torch.isfinite(t).all()) for t in out), f"gdn {name}: non-finite output")
        check(err <= GDN_LIMIT, f"gdn_fwd {name}: gap {err} to the plain version > "
                                f"{GDN_LIMIT}")
        f64 = ""
        if name in GDN_F64_TOL:
            atol, rtol = GDN_F64_TOL[name]
            ro, rS = k.gdn_fwd_ref(kw["q"], kw["k"], kw["v"], kw["g"], kw["beta"], kw["S0"])
            over = max(((a.double() - b).abs() - rtol * b.abs()).max().item()
                       for a, b in ((out[0], ro), (out[1], rS)))
            check(over <= atol, f"gdn_fwd {name}: |d| - {rtol} |ref| = {over} > {atol} "
                                "against the f64 recurrence")
            f64 = f"; f64 recurrence within {atol} + {rtol} |ref|"
            del ro, rS
        isz = torch.finfo(dt).bits // 8
        heads_t = B_ * H * T
        nbytes = (heads_t * ((2 * dk + 2 * dv) * isz + 8)
                  + B_ * H * dk * dv * 4 * (2 if kw["S0"] is not None else 1))
        # per token and head: K K^T and Q K^T over the chunk's lower
        # triangle, the solve and N U (2 C (dk + dv) together), K S, Q S and
        # the state update (6 dk dv)
        flops = heads_t * (2 * C * (dk + dv) + 6 * dk * dv)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S if dt == torch.bfloat16
                           else F32_FLOPS_PER_S)
        big = T * H * B_ >= 2 ** 18
        r = dict(name="gdn_fwd", case=f"{name} B={B_} H={H} T={T} dk={dk} dv={dv} C={C} "
                 f"{'bf16' if dt == torch.bfloat16 else 'f32'}"
                 f"{' S0' if kw['S0'] is not None else ''} {decay} decay{f64}",
                 route="cuda", source=gdn_src, replaces="triton_dist_tpu/kernels/gdn.py:222",
                 launches=None, max_abs_err=err, tol=GDN_LIMIT,
                 ms=cuda_ms(lambda: k.gdn_fwd(**kw), reps=10 if big else 20),
                 plain_ms=cuda_ms(lambda: k.gdn_chunk_ref(**kw), reps=2 if big else 5,
                                  warmup=1),
                 bound_ms=b_ms, bound_by=b_by, library_ms=None)
        rows.append((r, key))
        print(f"kernel gdn_fwd [{r['case']}]: gap {err:.3g} (limit {GDN_LIMIT}) ms "
              f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms {b_ms:.4f} ({b_by})",
              flush=True)
        del kw, out, ref
    torch.cuda.empty_cache()
    rows += sp_partial_rows(k, gen)
    return rows


def sp_partial_rows(k, gen):
    """Rows 4h (decode) and 4i (the mixed tick's window): the
    sequence-parallel paged attend at SP_RANKS ranks on the serving cell's
    shape, bf16 and int8 pools. The pool's pages are a random permutation
    over the streams; rank r holds pages [r*pps, (r+1)*pps) and walks them
    through its local table (table - r*pps where it owns the page, else
    its last owned page before, as layers/tp_attn.py:990-1006 of the JAX
    package redirects) with its ownership mask. Batch row SOLO's pages all
    lie on rank 0. Every pool row no stream reads holds 100x values."""
    dev = torch.device("cuda")
    Hq, Hkv, d, Bs, T = 16, 8, 128, SERVE_B, SERVE_MAX_SEQ
    rep, X, maxp = Hq // Hkv, SERVE_B * Hkv, SERVE_MAX_SEQ // PAGE
    pps = X * maxp // SP_RANKS
    solo = 1
    rows = []
    src = "triton_dist_tpu_torch/kernels/csrc/flash_decode_paged.cu"

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)

    def ints(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device=dev, dtype=torch.int32)

    mine = torch.randperm(pps, generator=gen, device=dev)[:Hkv * maxp]
    rest = torch.ones(X * maxp, dtype=torch.bool, device=dev)
    rest[mine] = False
    others = rest.nonzero()[:, 0]
    others = others[torch.randperm(others.numel(), generator=gen, device=dev)]
    table = torch.empty(X, maxp, dtype=torch.int32, device=dev)
    table[solo * Hkv:(solo + 1) * Hkv] = mine.reshape(Hkv, maxp).to(torch.int32)
    keep = torch.ones(X, dtype=torch.bool, device=dev)
    keep[solo * Hkv:(solo + 1) * Hkv] = False
    table[keep] = others.reshape(-1, maxp).to(torch.int32)
    ti = torch.arange(maxp, device=dev)
    locals_ = []
    for me in range(SP_RANKS):
        owned = (table // pps == me)
        last = torch.cummax(torch.where(owned, ti, -1), dim=1).values.clamp_min(0)
        tbl = torch.gather(torch.where(owned, table - me * pps, 0), 1, last).to(torch.int32)
        locals_.append((owned.to(torch.int32).contiguous(), tbl.contiguous()))

    for case, S in (("4h", 1), ("4i", SERVE_BUDGET)):
        if S == 1:
            ql = None
            kl = ints(1, T + 1, Bs)
            kl[:2] = torch.tensor([T, 37], dtype=torch.int32)
            live = torch.ones(Bs, 1, dtype=torch.bool, device=dev)
            front = kl[:, None] - 1
        else:
            # the mixed tick of 4f: windows in [0, S], a row with no key
            ql = ints(0, S + 1, Bs)
            ql[:3] = torch.tensor([0, 1, S], dtype=torch.int32)
            kl = (ql + ints(0, T - S + 1, Bs)).to(torch.int32)
            kl[0], kl[2] = 0, T
            s_idx = torch.arange(S, device=dev)
            live = s_idx[None, :] < ql[:, None]
            front = kl[:, None] - ql[:, None] + torch.minimum(s_idx[None], ql[:, None] - 1)
        qkw = {} if ql is None else dict(q_lens=ql)
        q = randn(Bs, S, Hq, d)
        kl_x = kl.repeat_interleave(Hkv)
        tpos = torch.arange(maxp * PAGE, device=dev)
        valid = tpos[None, :] < kl_x[:, None]                          # [X, T]
        used = torch.zeros(X * maxp * PAGE, dtype=torch.bool, device=dev)
        used[(table.long()[:, tpos // PAGE] * PAGE + tpos % PAGE)[valid]] = True
        pk, pv = randn(X * maxp, PAGE, d), randn(X * maxp, PAGE, d)
        pk[~used.reshape(-1, PAGE)] *= 100
        pv[~used.reshape(-1, PAGE)] *= 100
        for kvt in ("bf16", "int8"):
            if kvt == "bf16":
                kk, vv, ks, vs = pk, pv, None, None
            else:
                kk, ks = k.quantize_kv_int8(pk)
                vv, vs = k.quantize_kv_int8(pv)
            full = k.flash_decode_paged(q, kk, vv, table, kv_lens=kl, k_scale=ks,
                                        v_scale=vs, **qkw)
            parts, calls = [], []
            for me, (owned, tbl) in enumerate(locals_):
                sl = slice(me * pps, (me + 1) * pps)
                kw = dict(kv_lens=kl, tile_owned=owned, **qkw)
                if ks is not None:
                    kw.update(k_scale=ks[sl], v_scale=vs[sl])
                args = (q, kk[sl], vv[sl], tbl)
                calls.append((args, kw))
                got = k.flash_decode_paged_partial(*args, **kw)
                ref = k.flash_decode_paged_partial_ref(*args, **kw)
                torch.cuda.synchronize()
                m_err = max_err(got[1][live], ref[1][live])
                l_err = max_err(got[2][live], ref[2][live]) / max(
                    ref[2][live].abs().max().item(), 1e-30)
                acc_err = max_err(got[0][live], ref[0][live])
                acc_tol = 1e-2 * (1 + ref[0][live].abs().max().item())
                label = f"{case} sp={SP_RANKS} rank {me} {kvt}"
                check(m_err <= 1e-3 and l_err <= 1e-4 and acc_err <= acc_tol,
                      f"flash_decode_paged_partial {label}: m error {m_err} (tol 1e-3), "
                      f"l error {l_err} of max (tol 1e-4), acc error {acc_err} "
                      f"(tol {acc_tol})")
                if me:
                    a, m_, l_ = (t[solo] for t in got)
                    check(bool((a == 0).all() and (m_ == -1e30).all() and (l_ == 0).all()),
                          f"flash_decode_paged_partial {label}: batch row {solo} owns no "
                          "page here, but its rows are not (0, -1e30, 0)")
                parts.append(got)
            out = k.lse_combine(*(torch.stack([p[i] for p in parts]) for i in range(3)))
            comb_err = max_err(out[live], full[live])
            comb_tol = 1e-2 * (1 + full[live].float().abs().max().item())
            check(comb_err <= comb_tol, f"flash_decode_paged_partial {case} {kvt}: the "
                                        f"{SP_RANKS} partials' combine differs from "
                                        f"flash_decode_paged by {comb_err} > {comb_tol}")
            # the row: rank 1's call, its own keys' bytes and pairs
            (args, kw), me = calls[1], 1
            owned = locals_[me][0]
            own_key = owned.bool().repeat_interleave(PAGE, dim=1) & valid   # [X, T]
            n_keys = int(own_key.sum())
            pairs = 0
            for x0 in range(0, X, 64):       # (live query, owned key) pairs, in slices
                xs = torch.arange(x0, min(x0 + 64, X), device=dev)
                fr = front[xs // Hkv]                                    # [64, S]
                pairs += int(((tpos[None, None, :] <= fr[..., None])
                              & live[xs // Hkv][..., None] & own_key[xs, None, :]).sum())
            key_bytes = 2 * d * (2 if kvt == "bf16" else 1) + (0 if kvt == "bf16" else 8)
            n_pages = int(((kl_x + PAGE - 1) // PAGE).sum())
            nbytes = (2 * q.numel() + n_keys * key_bytes + 8 * n_pages
                      + 4 * Bs * (1 if ql is None else 2) + X * S * rep * (d + 2) * 4)
            b_ms, b_by = bound(nbytes, 4 * d * rep * pairs)
            r = dict(name="flash_decode_paged_partial",
                     case=f"{case} {'decode' if S == 1 else 'window'} sp={SP_RANKS} rank 1 of "
                          f"B={Bs} S={S} kv_lens <= {int(kl.max())} page={PAGE} Hq={Hq} "
                          f"Hkv={Hkv} {kvt} (combine err {comb_err:.3g}, tol "
                          f"{comb_tol:.3g})",
                     route="cuda", source=src, replaces="triton_dist_tpu/kernels/paged_kv.py:411",
                     launches=None, max_abs_err=acc_err, tol=acc_tol,
                     ms=cuda_ms(lambda: k.flash_decode_paged_partial(*args, **kw)),
                     plain_ms=cuda_ms(lambda: k.flash_decode_paged_partial_ref(*args, **kw),
                                      reps=5),
                     bound_ms=b_ms, bound_by=b_by, library_ms=None)
            rows.append((r, ("registry", "drive")))
            print(f"kernel flash_decode_paged_partial [{r['case']}]: acc err {acc_err:.3g} "
                  f"(tol {acc_tol:.3g}) ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} "
                  f"bound_ms {b_ms:.4f} ({b_by}); rank 1 owns {n_keys} of "
                  f"{int(valid.sum())} keys", flush=True)
        del pk, pv, kk, vv
    torch.cuda.empty_cache()
    return rows


# the registry's canonical calls against their CPU runs: the largest
# difference as a share of (1 + the largest CPU value); bf16 grouped_gemm
# rounds its output, kv_update copies
REGISTRY_TOL = {"grouped_gemm": 1e-2, "kv_update": 0.0}
# the registry's launches: one of each kernel, flash_attention's forward
# through flash_decode's partial form
REGISTRY_LAUNCHES = {"flash_decode": 1, "flash_decode_paged": 1,
                     "flash_decode_paged_partial": 1, "kv_update": 1, "grouped_gemm": 1,
                     "swiglu": 1, "gdn_fwd": 1, "flash_decode_partial": 1}
REPORT_KERNELS = ("gemm", "flash_decode", "flash_decode_paged", "gdn_fwd")
REPORT_ROWS = ("ag_gemm", "gemm_rs", "flash_decode", "flash_decode_paged", "gdn_fwd(pallas)")


def registry_phase(k, card):
    """This slice's main path, through its entry points: every
    kernel_registry() spec built on the card and run, held to the same
    spec on the CPU, then perf_report.run_report() on rows whose outputs
    were first held to their plain versions. Returns the launch counts of
    both."""
    from triton_dist_tpu_torch.tools import perf_report
    # the single-card specs (the comm specs run in the tensor-parallel phase)
    reg = {n: s_ for n, s_ in k.kernel_registry().items() if s_.min_devices == 1}
    k.reset_launch_counts()
    outs = {}
    for name, spec in reg.items():
        fn, args = spec.build("cuda")
        outs[name] = fn(*args)
    torch.cuda.synchronize()
    c_reg = k.launch_counts()
    check(all(c_reg[n] == REGISTRY_LAUNCHES.get(n, 0) for n in c_reg),
          f"registry: launches {c_reg}, want {REGISTRY_LAUNCHES} and no other")
    for name, spec in reg.items():
        fn, args = spec.build("cpu")
        want = fn(*args)
        got = outs[name]
        got, want = (list(t) if isinstance(t, tuple) else [t] for t in (got, want))
        err = max(max_err(a.cpu(), b) / (1 + b.float().abs().max().item())
                  for a, b in zip(got, want))
        tol = REGISTRY_TOL.get(name, 1e-3)
        check(err <= tol, f"registry {name}: card against CPU {err} > {tol}")
        print(f"registry {name} ({spec.module}, {spec.kind}): card against its CPU run "
              f"{err:.3g} of 1 + max (tol {tol})", flush=True)
    # each report row's op once at its timed shape, on the very inputs the
    # report times, against its plain version at the tolerances of rows
    # 1c and 4c (flash_decode, paged), 14a (gemm) and 10a (gdn); these
    # launches compare and are not counted
    from triton_dist_tpu_torch.tools import fault_margin as fm
    from triton_dist_tpu_torch.tools.perf_model import chip_specs
    rep_rows = perf_report.report_rows(chip_specs())
    for r in rep_rows:
        out, ref = r.fn(*r.args), r.plain(*r.args)
        torch.cuda.synchronize()
        if r.op.startswith("gdn_fwd"):
            err, tol = fm.gdn_gap(out, ref), GDN_LIMIT
        elif r.op.startswith("flash_decode"):
            err, tol = max_err(out, ref), 1e-2 * (1 + ref.float().abs().max().item())
        else:
            err, tol = max_err(out, ref), 2 ** -7 * ref.float().abs().max().item()
        check(err <= tol, f"perf_report row {r.op}: error {err} to its plain version > {tol}")
        print(f"perf_report row {r.op}: error {err:.3g} to its plain version (tol {tol:.3g})",
              flush=True)
        del out, ref
    k.reset_launch_counts()
    report = perf_report.run_report(rows=rep_rows)
    del rep_rows
    torch.cuda.synchronize()
    c_rep = k.launch_counts()
    for n in REPORT_KERNELS:
        check(c_rep[n] > 0, f"perf_report: kernel {n} did not run ({c_rep})")
    only_launched(c_rep, REPORT_KERNELS, "perf_report")
    ops = {r["op"]: r for r in report["ops"]}
    for n in REPORT_ROWS:
        check(n in ops and ops[n]["achieved_us"] > 0 and 0 < ops[n]["sol_frac"] <= 1.0,
              f"perf_report: row {n} {ops.get(n)}")
    print(f"perf_report on {card}: {json.dumps(report)}", flush=True)
    return {n: c_reg[n] + c_rep[n] for n in c_reg}


def tp_phase(k, card):
    """The tensor-parallel phase (11. above). Returns its kernel rows with
    their launch-count keys and the counts they read."""
    from triton_dist_tpu_torch.runtime import make_mesh, symm_mem
    from triton_dist_tpu_torch.tools import tp_check
    mesh = make_mesh(4, devices=["cuda:0"] * 4)
    cpu_mesh = make_mesh(4, devices=["cpu"] * 4)
    # the sequence-parallel specs run in the SP phase, p2p_shift in the
    # Ulysses and pipeline phase
    from triton_dist_tpu_torch.tools.pp_check import PP_SPECS
    from triton_dist_tpu_torch.tools.sp_check import SP_SPECS
    comm = {n: s_ for n, s_ in k.kernel_registry().items()
            if s_.min_devices > 1 and n not in SP_SPECS + PP_SPECS}
    k.reset_launch_counts()
    outs = {}
    for name, spec in comm.items():
        fn, args = spec.build(mesh)
        outs[name] = fn(*args)
    torch.cuda.synchronize()
    c_reg = k.launch_counts()
    kernels = ("all_gather", "reduce_scatter", "all_reduce", "gemm_allreduce", "ag_gemm",
               "gemm_rs", "all_to_all", "dispatch_a2a", "ep_moe_fused", "ag_group_gemm",
               "moe_reduce_rs", "moe_reduce_ar")
    for n in kernels:
        check(c_reg[n] > 0, f"tp registry: {n} did not run ({c_reg})")
    only_launched(c_reg, kernels, "tp registry")
    # ep_dispatch_combine's weighted sums, ep_fused's products and
    # low_latency_all_to_all's int8 pack and unpack are f32 arithmetic on
    # the card against the CPU's (the pack one f32 ulp apart on the H100:
    # 7.5e-8 of the largest output); their exchanges are held bitwise in
    # tp_check's rows
    limits = {"gemm_ar": tp_check.GEMM_AR_LIMIT, "ag_gemm": tp_check.AG_GEMM_LIMIT,
              "gemm_rs": tp_check.GEMM_RS_LIMIT, "ep_fused": tp_check.EP_FUSED_LIMIT,
              "ep_dispatch_combine": 1e-5, "low_latency_all_to_all": 1e-6,
              "ag_group_gemm": tp_check.TP_MOE_LIMIT, "moe_reduce_rs": tp_check.TP_MOE_LIMIT,
              "moe_reduce_ar": tp_check.TP_MOE_LIMIT}
    for name, spec in comm.items():
        fn, args = spec.build(cpu_mesh)
        tol = limits.get(name, 0.0)
        for r, (got, want) in enumerate(zip(outs[name], fn(*args))):
            err = max_err(got.cpu(), want) / want.float().abs().max().item()
            check(err <= tol, f"tp registry {name} rank {r}: card against CPU {err} > {tol}")
        print(f"tp registry {name} ({spec.module}): card against its CPU run within "
              f"{tol or 'bitwise'}", flush=True)
    # row 5's TP form is case 5c of the megakernel phase
    res = tp_check.run(mesh, card=card, n_layers=TP_LAYERS, mega_row=False)
    dist = res["counts"]["dist"]
    mega = res["counts"]["mega"]
    counts = {"registry": c_reg, "ar decode": res["counts"]["ar"]["decode"],
              "gemm_ar decode": res["counts"]["gemm_ar"]["decode"],
              "dist engine": {n: dist["prefill"][n] + dist["decode"][n]
                              for n in dist["decode"]},
              "mega engine": dict(mega["decode"],
                                  **{"mega_decode/tp": mega["methods"]["mega_decode tp"]})}
    print(f"tp phase, {TP_LAYERS} layers: decode ms/step (idle share) " + ", ".join(
        f"{b} {c['ms_per_step']:.2f} ({tp_check.share(c['idle'])})"
        for b, c in ((b, res["counts"][b]) for b in ("ar", "gemm_ar", "dist", "mega"))),
        flush=True)
    key = {"all_reduce": "ar decode", "gemm_allreduce": "gemm_ar decode",
           "all_gather": "registry", "reduce_scatter": "registry",
           "ag_gemm": "dist engine", "gemm_rs": "dist engine"}
    symm_mem.clear_registry()          # the landing buffers and signal pads
    return [(r, ("tp", key[r["name"]])) for r in res["rows"]], counts


def ep_phase(k, card, model):
    """The expert-parallel phase (12. above) on the MoE phases' model.
    Returns its kernel rows with their launch-count keys and the counts
    they read."""
    from triton_dist_tpu_torch.runtime import make_mesh, symm_mem
    from triton_dist_tpu_torch.tools import tp_check
    mesh = make_mesh(4, devices=["cuda:0"] * 4)
    res = tp_check.run_ep(mesh, card=card, one=model, n_layers=MOE_MESH_LAYERS)
    ep = res["counts"]["ep"]
    counts = {"ep engine": {n: ep["prefill"][n] + ep["decode"][n] for n in ep["decode"]},
              "ep layer": res["counts"]["layer"]["launches"]}
    key = {"all_to_all": "ep engine", "dispatch_a2a": "ep engine",
           "ep_moe_fused": "ep layer"}
    symm_mem.clear_registry()
    return [(r, ("ep", key[r["name"]])) for r in res["rows"]], counts


def tp_moe_phase(k, card, model):
    """The tensor-parallel MoE phase (13. above) on the MoE phases' model.
    Returns its kernel rows with their launch-count keys and the counts
    they read."""
    from triton_dist_tpu_torch.runtime import make_mesh, symm_mem
    from triton_dist_tpu_torch.tools import tp_check
    mesh = make_mesh(4, devices=["cuda:0"] * 4)
    res = tp_check.run_tp_moe(mesh, card=card, one=model, n_layers=MOE_MESH_LAYERS)
    dist = res["counts"]["dist"]
    counts = {"dist engine": {n: dist["prefill"][n] + dist["decode"][n] for n in dist["decode"]},
              "fused layer": res["counts"]["layer"]["launches"]}
    # rows 21-23 run in the fused layer forms (no engine mode reaches
    # them, as in the JAX package); grouped_gemm, all_gather and
    # reduce_scatter in the "dist" engine
    for n in ("ag_group_gemm", "moe_reduce_rs", "moe_reduce_ar"):
        check(counts["fused layer"][n] > 0, f"tp-moe phase: {n} did not run")
    for n in ("grouped_gemm", "all_gather", "reduce_scatter"):
        check(counts["dist engine"][n] > 0, f"tp-moe phase: {n} did not run in the engine")
    symm_mem.clear_registry()
    return [(r, ("tp_moe", "fused layer")) for r in res["rows"]], counts


def sp_phase(k, card):
    """The sequence-parallel phase (14. above). Returns its kernel rows with
    their launch-count keys and the counts they read."""
    from triton_dist_tpu_torch.runtime import make_mesh, symm_mem
    from triton_dist_tpu_torch.tools import sp_check
    mesh = make_mesh(4, devices=["cuda:0"] * 4)
    res = sp_check.run_sp(mesh, card=card, ulysses=False)
    c = res["counts"]
    counts = {"prefill": c["layer"]["prefill ring_shmem"], "serving": c["serving"]["serving"]}
    key = {"lse_combine": "serving", "kv_scatter": "prefill", "ring_attn": "prefill"}
    for n, ph in key.items():
        check(counts[ph][n] > 0, f"sp phase: {n} did not run in the {ph}")
    counts["spattn ms"] = c["layer"]["ms"]
    symm_mem.clear_registry()
    return [(r, ("sp", key[r["name"]])) for r in res["rows"]], counts


def ulysses_pp_phase(k, card, spattn_ms):
    """The Ulysses and pipeline phase (15. above). Returns its kernel rows
    with their launch-count keys and the counts they read."""
    from triton_dist_tpu_torch.runtime import make_mesh, symm_mem
    from triton_dist_tpu_torch.tools import pp_check, sp_check
    mesh = make_mesh(4, devices=["cuda:0"] * 4)
    rows = sp_check.ulysses_rows(mesh)
    uly = sp_check.ulysses_check(mesh, spattn_ms=spattn_ms)
    pp = pp_check.run_pp(mesh, card=card)
    counts = {"ulysses fused": uly["counts"]["fused"],
              "pipeline": pp["counts"]["pipeline"]["PPipeline replicate_out=True"]}
    key = {"gemm_a2a": "ulysses fused", "o_a2a_gemm": "ulysses fused", "p2p_shift": "pipeline"}
    for n, ph in key.items():
        check(counts[ph][n] > 0, f"ulysses/pp phase: {n} did not run in the {ph} path")
    symm_mem.clear_registry()
    return [(r, ("ulysses_pp", key[r["name"]])) for r in rows + pp["rows"]], counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if PACKAGE_MISSING is not None:
        print(f"chip_smoke: the port's package is not beside this script: "
              f"{PACKAGE_MISSING}", file=sys.stderr)
        return 2
    import triton_dist_tpu_torch.kernels as k
    import triton_dist_tpu_torch.models as m
    from triton_dist_tpu_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.ext()
    print(f"build: {time.perf_counter() - t0:.1f} s (cpp_extension.load of "
          f"{', '.join(_build.SOURCES)} and the binding)", flush=True)

    t_start = time.perf_counter()

    def stamp(what):
        print(f"[{time.perf_counter() - t_start:.1f} s] {what} done", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_phase(k, gen)
    rows += window_kernel_phase(k, torch.Generator(device="cuda").manual_seed(6))
    rows += mega_kernel_phase(gen)
    rows += dist_gemm_rows(k, torch.Generator(device="cuda").manual_seed(8))
    stamp("kernel phases")

    cfg = m.qwen3_1p7b()
    ids = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    model = m.AutoLLM.from_config(cfg, device="cuda", seed=0)
    counts = {"bf16": engine_phase(m, k, model, None, "bf16", ids, card)}
    stamp("engine bf16")
    counts["bf16"]["dist decode"] = engine_phase(m, k, model, None, "dist bf16", ids, card,
                                                 backend="dist")["decode"]
    stamp("engine dist bf16")
    counts["bf16"]["mega decode"] = engine_phase(m, k, model, None, "mega bf16", ids,
                                                 card, backend="mega")["decode"]
    stamp("engine mega bf16")
    model = model.quantize_int8()
    counts["int8"] = engine_phase(m, k, model, torch.int8, "int8", ids, card)
    stamp("engine int8")
    counts["int8"]["dist decode"] = engine_phase(m, k, model, torch.int8, "dist int8", ids,
                                                 card, backend="dist")["decode"]
    stamp("engine dist int8")

    reqs = serving_requests(m, cfg.vocab_size)
    model = m.AutoLLM.from_config(cfg, device="cuda", seed=0)
    counts["bf16"]["paged"] = serving_phase(m, k, model, None, "paged bf16", True, reqs,
                                            card)
    stamp("serving paged bf16")
    counts["bf16"]["contiguous"] = serving_phase(m, k, model, None, "contiguous bf16",
                                                 False, reqs, card)
    stamp("serving contiguous bf16")
    # the megakernel takes bf16 weights; its int8 configuration is the
    # int8 KV pool alone
    counts["bf16"]["mega paged"] = serving_phase(m, k, model, None, "mega paged bf16",
                                                 True, reqs, card, backend="mega")
    stamp("serving mega paged bf16")
    counts["int8"]["mega paged"] = serving_phase(m, k, model, torch.int8,
                                                 "mega paged int8-KV", True, reqs, card,
                                                 backend="mega")
    stamp("serving mega paged int8-KV")
    # the window path: speculative decoding and chunked prefill
    spec_counts = spec_phase(m, k, model, card)
    for form, c in spec_counts.items():
        counts["bf16"][f"spec {form}"] = c
    stamp("spec serving bf16")
    for form, paged in (("paged", True), ("contiguous", False)):
        counts["bf16"][f"chunked {form}"] = chunked_phase(m, k, model, None, f"{form} bf16",
                                                          paged, card)
        stamp(f"chunked prefill {form} bf16")
    chunked_first_poll(m, model, reqs, card)
    counts["bf16"]["chunked serving"] = serving_phase(
        m, k, model, None, f"paged bf16 prefill_budget {SERVE_BUDGET}", True, reqs, card,
        probe=False, prefill_budget=SERVE_BUDGET)
    stamp(f"serving paged bf16 prefill_budget {SERVE_BUDGET}")
    model = model.quantize_int8()
    counts["int8"]["paged"] = serving_phase(m, k, model, torch.int8, "paged int8", True,
                                            reqs, card)
    stamp("serving paged int8")
    for form, paged in (("paged", True), ("contiguous", False)):
        counts["int8"][f"chunked {form}"] = chunked_phase(
            m, k, model, torch.int8, f"{form} int8", paged, card, compare=paged)
        stamp(f"chunked prefill {form} int8")

    # training: Qwen3-1.7B steps through forward_train and the backward kernels
    del model
    gc.collect()
    torch.cuda.empty_cache()
    rows += train_kernel_phase(k, torch.Generator(device="cuda").manual_seed(2))
    stamp("training kernel rows")
    counts["train"] = {"step": train_phase(m, k, card)}
    stamp("training steps")

    # GDN, the sequence-parallel paged partial, the registry and perf_report
    rows += gdn_partial_phase(k, torch.Generator(device="cuda").manual_seed(7))
    stamp("gdn and partial kernel rows")
    counts["registry"] = {"drive": registry_phase(k, card)}
    stamp("registry and perf_report")
    gc.collect()
    torch.cuda.empty_cache()
    tp_rows, counts["tp"] = tp_phase(k, card)
    rows += tp_rows
    stamp("tensor-parallel phase")
    gc.collect()
    torch.cuda.empty_cache()
    sp_rows, counts["sp"] = sp_phase(k, card)
    rows += sp_rows
    stamp("sequence-parallel phase")
    gc.collect()
    torch.cuda.empty_cache()
    uly_rows, counts["ulysses_pp"] = ulysses_pp_phase(k, card, counts["sp"]["spattn ms"])
    rows += uly_rows
    stamp("Ulysses and pipeline phase")

    # MoE: Qwen3-30B-A3B, about 61 GB of bf16 weights, built once every
    # dense model is gone
    gc.collect()
    torch.cuda.empty_cache()
    print(f"memory before the MoE phases: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          "allocated", flush=True)
    rows += moe_kernel_phase(k, gen)
    moe_layer_phase(k, gen)
    stamp("moe kernel and layer phases")
    cfg = m.qwen3_30b_a3b()
    t0 = time.perf_counter()
    model = m.AutoLLM.from_config(cfg, device="cuda", seed=0, capacity_factor=2.0)
    torch.cuda.synchronize()
    print(f"moe model: {time.perf_counter() - t0:.1f} s to draw, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated", flush=True)
    counts["moe"] = moe_engine_phase(m, k, model, ids, card)
    stamp("engine moe bf16")
    counts["moe"]["paged"] = serving_phase(m, k, model, None, "moe paged bf16", True,
                                           reqs[:MOE_REQS], card, tf_reqs=0)
    stamp("serving moe paged bf16")
    set_capacity(model, "dropless")
    serving_phase(m, k, model, None, "moe paged bf16 dropless", True, reqs[:MOE_DL_REQS],
                  card, batch=MOE_DL_SLOTS, tf_reqs=MOE_DL_TF_REQS, probe=False)
    stamp("serving moe paged bf16 dropless")
    counts["moe"]["chunked"] = serving_phase(
        m, k, model, None, f"moe paged bf16 dropless prefill_budget {MOE_BUDGET}", True,
        reqs[:MOE_DL_REQS], card, batch=MOE_DL_SLOTS, tf_reqs=MOE_TF_REQS, probe=False,
        prefill_budget=MOE_BUDGET)
    set_capacity(model, 2.0)
    stamp(f"serving moe paged bf16 dropless prefill_budget {MOE_BUDGET}")

    # expert parallelism: the same model's experts split over four ranks
    # emulated on the card (views of its expert panels)
    ep_rows, counts["ep"] = ep_phase(k, card, model)
    rows += ep_rows
    stamp("expert-parallel phase")
    gc.collect()
    torch.cuda.empty_cache()
    tp_moe_rows, counts["tp_moe"] = tp_moe_phase(k, card, model)
    rows += tp_moe_rows
    stamp("tensor-parallel MoE phase")

    out = []
    for r, (kvt, phase) in rows:
        r["launches"] = counts[kvt][phase][r["name"]]
        out.append(r)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
