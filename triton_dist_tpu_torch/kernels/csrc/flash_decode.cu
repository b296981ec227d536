// Cached GQA attention for prefill-into-cache and decode over the
// contiguous cache.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/flash_attn.py
// `_flash_decode_kernel` (launched by `_flash_call`, the pallas_call at
// flash_attn.py:406) in its plain, int8-KV and per-row-length forms.
// Same contract:
//   q [B, S, Hq, d] (row strides given), k/v [B, Hkv, T, d] (row strides
//   given, d contiguous), optional int8 k/v with per-position f32 scales
//   ks/vs [B, Hkv, T]; query s sits at position kv_len - S + s and attends
//   keys col <= kv_len - S + s with col < min(kv_len, T). With kv_lens
//   (device int32 [B], S == 1: the continuous-batching tick) row b uses
//   kv_lens[b] in place of kv_len. With kv_lens and q_lens (device int32
//   [B], any S: the `q_lens` window form, flash_attn.py:111-119, of
//   speculative verify and chunked prefill) row b's first q_lens[b]
//   positions are a window ending at kv_lens[b] - 1, causal within it, and
//   its padding positions repeat the last valid one. Output [B, S, Hq, d]
//   contiguous, in q's dtype.
//
// What bounds it on an H100: decode (S = 1) reads every valid K/V row of
// the cache once and does ~4 flops per byte, so HBM bytes bound it.
// Prefill (S = 128) is bounded by bytes as well at these shapes (q, K, V
// and the output are each touched once; the causal work is ~8 GFLOP).
//
// The partial form (flash_decode_partial, the TPU kernel's partial=True,
// public in triton_dist_tpu/kernels/flash_attn.py:286) is the training
// forward: one launch over the whole query (B=4, S=T=1024 at Qwen3-1.7B's
// width), the causal frontier q_off given by the caller, the unnormalised
// f32 acc and the (m, l) statistics stored per folded row. Its causal work
// (~17 GFLOP a layer at that shape) runs on FMA units, so operations bound
// it on this design, not the card's tensor-core peak.
//
// The tile loop and its design are in flash_tile.cuh (ContigKV
// addressing). With per-row lengths each CTA walks only its own row's
// keys, so a mixed-length batch reads sum(len_b) rows, not B * max_len.
#include "flash_tile.cuh"

namespace {

template <typename QT, typename KT, bool QUANT>
cudaError_t launch(int HD, const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, const int* kv_lens, const int* q_lens, void* o,
                   int kv_len, int B, int S, int Hq, int Hkv, int T, float scale,
                   const long long* st, cudaStream_t stream) {
  const tdt_flash::ContigKV<KT> A{static_cast<const KT*>(k),
                                  static_cast<const KT*>(v),
                                  static_cast<const float*>(ks),
                                  static_cast<const float*>(vs),
                                  kv_lens,
                                  q_lens,
                                  kv_len,
                                  T,
                                  st[3],
                                  st[4],
                                  st[5],
                                  st[6],
                                  st[7]};
  return tdt_flash::launch<QT, KT, QUANT>(HD, q, o, A, B, S, Hq, Hkv, scale, st[0], st[1],
                                          st[2], stream);
}

template <typename T>
cudaError_t launch_partial(int HD, const void* q, const void* k, const void* v,
                           const tdt_flash::Partial& P, int kv_len, int B, int S, int Hq,
                           int Hkv, int T_, float scale, const long long* st,
                           cudaStream_t stream) {
  const tdt_flash::ContigKV<T> A{static_cast<const T*>(k), static_cast<const T*>(v), nullptr,
                                 nullptr, nullptr, nullptr, kv_len, T_, st[3], st[4], st[5],
                                 0, 0};
  return tdt_flash::launch<T, T, false, tdt_flash::kPartialOff>(
      HD, q, nullptr, A, B, S, Hq, Hkv, scale, st[0], st[1], st[2], stream, P);
}

}  // namespace

cudaError_t tdt::flash_decode_partial(int dtype, const void* q, const void* k, const void* v,
                                      float* acc, float* m, float* l, int kv_len, int q_off,
                                      int B, int S, int Hq, int Hkv, int T, int HD,
                                      float scale, const long long* st,
                                      cudaStream_t stream) {
  const tdt_flash::Partial P{acc, m, l, q_off};
  if (dtype == kF32)
    return launch_partial<float>(HD, q, k, v, P, kv_len, B, S, Hq, Hkv, T, scale, st, stream);
  if (dtype == kBF16)
    return launch_partial<__nv_bfloat16>(HD, q, k, v, P, kv_len, B, S, Hq, Hkv, T, scale, st,
                                         stream);
  return cudaErrorInvalidValue;
}

cudaError_t tdt::flash_decode(int q_dtype, int kv_dtype, const void* q, const void* k,
                              const void* v, const void* ks, const void* vs,
                              const int* kv_lens, const int* q_lens, void* o, int kv_len,
                              int B, int S, int Hq, int Hkv, int T, int HD, float scale,
                              const long long* st, cudaStream_t stream) {
  // per-row lengths take S == 1 unless a window rides with them
  if ((kv_lens != nullptr && S != 1 && q_lens == nullptr) ||
      (q_lens != nullptr && kv_lens == nullptr))
    return cudaErrorInvalidValue;
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float, false>(HD, q, k, v, ks, vs, kv_lens, q_lens, o, kv_len, B,
                                       S, Hq, Hkv, T, scale, st, stream);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(HD, q, k, v, ks, vs, kv_lens,
                                                       q_lens, o, kv_len, B, S, Hq, Hkv, T,
                                                       scale, st, stream);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch<__nv_bfloat16, int8_t, true>(HD, q, k, v, ks, vs, kv_lens, q_lens, o,
                                               kv_len, B, S, Hq, Hkv, T, scale, st, stream);
  return cudaErrorInvalidValue;
}
