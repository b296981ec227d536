// One decode layer over the contiguous KV cache as one persistent CUDA
// kernel.
//
// Replaces the TPU kernel triton_dist_tpu/mega/decode_layer.py
// `MegaDecodeLayer.__call__` (the pallas_call at decode_layer.py:462) at
// tensor-parallel size 1. Contract: x [B, D] f32 -> y [B, D] f32 for the
// layer step at the shared position pos; the new K/V rows are written in
// place into the cache [B, Hkv, T, hd] bf16 (the port's KVCache layout;
// the TPU kernel took [Hkv, B, T, hd], transposed per decode call) and
// row b attends its keys [0, pos].
//
// What bounds it, and the design: mega_layer.cuh (ContigCache addressing).
#include "mega_layer.cuh"

cudaError_t tdt::mega_decode(const MegaLayerArgs& a, cudaStream_t stream) {
  if (a.hd != tdt_mega::HD || a.kv_dtype != kBF16 || a.n_phases > 8)
    return cudaErrorInvalidValue;
  return tdt_mega::launch_layer<__nv_bfloat16, false, false>(a, stream);
}
