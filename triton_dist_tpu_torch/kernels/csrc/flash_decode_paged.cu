// Decode attention of continuous-batching slots through the page table of
// the paged KV pool, and its sequence-parallel partial form.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/paged_kv.py
// `_paged_kernel` (launched by `_flash_decode_paged_call`, the pallas_call
// at paged_kv.py:411) in its per-stream (`kv_lens`) decode form and its
// `q_lens` window form (speculative verify and chunked prefill; the
// frontier kvl - ql + min(row, ql - 1) of paged_kv.py:279-350), plain and
// int8. Contract:
//   q [B, S, Hq, d] (row strides given); pools k/v [NP, G, page, d] with
//   G == 1 (page and row strides given, d contiguous), optional int8
//   pools with per-position f32 scale pages [NP, G, page]; table
//   [B*Hkv, maxp] int32 (contiguous) maps logical tile t of stream
//   b*Hkv + h to a physical page; kv_lens [B] int32: row b attends its
//   own positions [0, kv_lens[b]). S == 1 without q_lens; with q_lens [B]
//   int32 row b's first q_lens[b] query positions are a window ending at
//   kv_lens[b] - 1, causal within it (padding positions repeat the last
//   valid one). Output [B, S, Hq, d] contiguous, in q's dtype.
//
// The partial form (flash_decode_paged_partial, the TPU kernel's
// `partial=True` branch, paged_kv.py:105-150 and :190-197; the split-KV
// partial of the sequence-parallel paged attend, layers/tp_attn.py:990-1006
// in the JAX package) walks the same frontiers over one rank's pool shard
// through the rank's local table, and takes an ownership row per stream,
// owned [B*Hkv, maxp] int32: keys on logical pages the rank does not own
// are never read and contribute nothing (their table entries point at some
// local page and stay unused). It stores the unnormalised f32 acc
// [B*Hkv, S*rep, d] and the running (m, l) [B*Hkv, S*rep] per folded query
// row; a row that owns no key keeps (0, -1e30, 0), the combine's neutral
// element, so the ranks' partials LSE-combine to the whole pool's softmax.
//
// What bounds it on an H100: one decode step reads every valid K/V row of
// every stream once (about 4 flops per byte), so HBM bytes bound it, and
// the bytes are sum over streams of kv_lens[b] rows, not B * capacity (of
// a partial walk, the owned rows only).
//
// Design (flash_tile.cuh with PagedKV addressing): one CTA per stream
// x = b*Hkv + h (a window's S * rep folded query rows take one CTA per
// block of rows, each walking to its block's furthest frontier). The TPU
// kernel resolved pages in its BlockSpec index map
// (scalar prefetch) and clamped the walk of a short stream to its last
// page; here the CTA reads its own page ids, table[x, t / page], for the
// keys t < kv_lens[b] only, so the clamp is the loop bound and no page
// past the stream's length is ever read. A 32-key tile is two 16-row
// pages staged in shared memory, serving the rep query rows of the group;
// the online softmax lives in f32 registers and rounds as the TPU kernel
// does (paged_kv.py:119-197): -1e30 start, scale after the dot, K scale
// on the logits, V scale folded into P, P rounded to bf16 before the PV
// product (f32 pools keep P in f32), acc / max(l, 1e-30). The partial
// form's ownership test is per key (two ranks may own the two pages of
// one tile), and a tile with no owned key is skipped whole.
#include "flash_tile.cuh"

namespace {

template <typename QT, typename KT, bool QUANT, tdt_flash::Form F>
cudaError_t launch(int HD, const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const int* table, const int* kv_lens, const int* q_lens,
                   const int* owned, void* o, const tdt_flash::Partial& P, int B, int S,
                   int Hq, int Hkv, int maxp, int page, float scale, const long long* st,
                   cudaStream_t stream) {
  const tdt_flash::PagedKV<KT> A{static_cast<const KT*>(k),
                                 static_cast<const KT*>(v),
                                 static_cast<const float*>(ks),
                                 static_cast<const float*>(vs),
                                 table,
                                 kv_lens,
                                 q_lens,
                                 owned,
                                 Hkv,
                                 maxp,
                                 page,
                                 st[3],
                                 st[4],
                                 st[5]};
  return tdt_flash::launch<QT, KT, QUANT, F>(HD, q, o, A, B, S, Hq, Hkv, scale, st[0], st[1],
                                             st[2], stream, P);
}

// the three dtype pairs of either form
template <tdt_flash::Form F>
cudaError_t dispatch(int q_dtype, int kv_dtype, int HD, const void* q, const void* k,
                     const void* v, const void* ks, const void* vs, const int* table,
                     const int* kv_lens, const int* q_lens, const int* owned, void* o,
                     const tdt_flash::Partial& P, int B, int S, int Hq, int Hkv, int maxp,
                     int page, float scale, const long long* st, cudaStream_t stream) {
  if (S != 1 && q_lens == nullptr) return cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float, false, F>(HD, q, k, v, ks, vs, table, kv_lens, q_lens, owned,
                                          o, P, B, S, Hq, Hkv, maxp, page, scale, st, stream);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false, F>(HD, q, k, v, ks, vs, table,
                                                          kv_lens, q_lens, owned, o, P, B, S,
                                                          Hq, Hkv, maxp, page, scale, st,
                                                          stream);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch<__nv_bfloat16, int8_t, true, F>(HD, q, k, v, ks, vs, table, kv_lens,
                                                  q_lens, owned, o, P, B, S, Hq, Hkv, maxp,
                                                  page, scale, st, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t tdt::flash_decode_paged(int q_dtype, int kv_dtype, const void* q, const void* k,
                                    const void* v, const void* ks, const void* vs,
                                    const int* table, const int* kv_lens,
                                    const int* q_lens, void* o, int B, int S, int Hq,
                                    int Hkv, int maxp, int page, int HD, float scale,
                                    const long long* st, cudaStream_t stream) {
  return dispatch<tdt_flash::kOut>(q_dtype, kv_dtype, HD, q, k, v, ks, vs, table, kv_lens,
                                   q_lens, nullptr, o, tdt_flash::Partial{}, B, S, Hq, Hkv,
                                   maxp, page, scale, st, stream);
}

cudaError_t tdt::flash_decode_paged_partial(int q_dtype, int kv_dtype, const void* q,
                                            const void* k, const void* v, const void* ks,
                                            const void* vs, const int* table,
                                            const int* kv_lens, const int* q_lens,
                                            const int* owned, float* acc, float* m,
                                            float* l, int B, int S, int Hq, int Hkv, int maxp,
                                            int page, int HD, float scale,
                                            const long long* st, cudaStream_t stream) {
  if (owned == nullptr) return cudaErrorInvalidValue;
  return dispatch<tdt_flash::kPartialOwned>(q_dtype, kv_dtype, HD, q, k, v, ks, vs, table,
                                            kv_lens, q_lens, owned, nullptr,
                                            tdt_flash::Partial{acc, m, l, 0}, B, S, Hq, Hkv,
                                            maxp, page, scale, st, stream);
}
