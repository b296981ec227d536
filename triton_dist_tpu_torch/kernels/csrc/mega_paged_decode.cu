// One decode layer over the paged KV pool as one persistent CUDA kernel.
//
// Replaces the TPU kernel triton_dist_tpu/mega/decode_layer.py
// `MegaPagedDecodeLayer.__call__` (the pallas_call at decode_layer.py:919).
// Contract: x [B, D] f32 -> y [B, D] f32; slot b's new token sits at its
// own position pos[b] ([B] int32 on the device): its K/V row is written
// into the page table[b*Hkv + g, pos[b] / page] at row pos[b] % page of
// the pools [NP, 1, page, hd] (bf16, or int8 with f32 scale pages
// [NP, 1, page]), and it attends its own keys [0, pos[b]] through the
// table. A retired slot's table rows all map the trash page, so its
// write lands there; its output is not meaningful (CTAs race on that
// page), and no live stream maps the trash page.
//
// The TPU kernel computed each write page outside the kernel (an
// interpreter limit on dynamic scalar indexing); here the attending warp
// reads it from the table itself. What bounds it, and the design:
// mega_layer.cuh (PagedCache addressing).
#include "mega_layer.cuh"

cudaError_t tdt::mega_paged_decode(const MegaLayerArgs& a, cudaStream_t stream) {
  if (a.hd != tdt_mega::HD || a.n_phases > kMaxPhases) return cudaErrorInvalidValue;
  if (a.kv_dtype == kBF16)
    return tdt_mega::launch_layer<__nv_bfloat16, false, true>(a, stream);
  if (a.kv_dtype == kI8) return tdt_mega::launch_layer<int8_t, true, true>(a, stream);
  return cudaErrorInvalidValue;
}
