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
// The tensor-parallel form (mega_decode_tp) replaces the same kernel's
// tp > 1 body: each rank's layer on its head and FFN shards, with the two
// in-kernel one-shot all-reduce sections (decode_layer.py `ar_section`,
// :191-216) after its partial o_proj and down_proj. Contract: every rank
// takes the replicated x [B, D] f32 and its shards and cache heads, and
// returns the same y [B, D] f32, bitwise, on every rank.
//
// What bounds it, and the design: mega_layer.cuh (ContigCache addressing;
// the TP form's protocol, over shmem.cuh).
#include "mega_layer.cuh"

cudaError_t tdt::mega_decode(const MegaLayerArgs& a, cudaStream_t stream) {
  if (a.hd != tdt_mega::HD || a.kv_dtype != kBF16 || a.n_phases > kMaxPhases)
    return cudaErrorInvalidValue;
  return tdt_mega::launch_layer<__nv_bfloat16, false, false>(a, stream);
}

cudaError_t tdt::mega_decode_tp(const MegaTpArgs& a, int ctas, cudaStream_t stream) {
  const int n_local = a.c.n_local;
  if (n_local < 1 || n_local > kMaxRanks) return cudaErrorInvalidValue;
  for (int i = 0; i < n_local; ++i) {
    const MegaLayerArgs& L = a.L[i];
    if (L.hd != tdt_mega::HD || L.kv_dtype != kBF16 || L.n_phases > kMaxPhases ||
        !L.part || L.D % 4 || L.B != a.L[0].B || L.D != a.L[0].D)
      return cudaErrorInvalidValue;
  }
  MegaTpArgs args = a;
  void* params[] = {&args};
  return tdt::coop_launch(tdt_mega::mega_tp_kernel<__nv_bfloat16>, a.c, ctas,
                          tdt_mega::kSmemBytes, params, stream);
}
