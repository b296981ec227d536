// Kernel (row 24), the inter-rank LSE combine of sp_combine_partials(
// combine="dist"): every rank's split-KV partial (acc, m, l) pushed to
// every peer and merged there, normalised, replicated.
//
// Replaces triton_dist_tpu/kernels/sp_flash_decode.py `_lse_combine_pallas`
// (the pallas_call at :131, kernel `_lse_combine_kernel`): each rank puts
// its acc [R, d] and its stats (m, l) into slot me of every peer's landing
// buffers and signals; after n arrivals it computes m* = max_p m_p, the
// rescale s_p = exp(m_p - m*), l* = sum_p l_p s_p, and writes
// (sum_p acc_p s_p) / max(l*, 1e-30) in f32, the TPU kernel's order (the
// first slot's product, then the others added in rank order, times the
// inverse). A row that owns no key on any rank arrives as (0, -1e30, 0)
// everywhere: m* = -1e30, s_p = 1, l* = 0 and the output is 0, not NaN.
//
// What bounds it: bytes. One card holding every rank reads each rank's
// partial once and writes it n times into the landing buffers, then reads
// n partials and writes one output per rank; over NVLink each rank sends
// (n - 1) partials.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all (csrc/shmem.cuh) so no rank overwrites a
// landing slot a peer still reads from the previous call. CTA g owns the
// same rows of every rank's partial: it puts them, signals CTA g of every
// peer (region A, slot me), waits for CTA g of every source, then merges
// those rows. Landed data is read through L2 (ld.global.cg).
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;

__global__ void __launch_bounds__(kThreads) lse_combine_kernel(CommArgs a, int R, int d) {
  const int me = my_pe(a);
  const int dv = d / 4;  // 16-byte vectors of a row
  long long lo, hi;
  split(R, lo, hi);
  barrier_all(a);
  const uint4* acc = static_cast<const uint4*>(a.in[me]);
  const float* st = static_cast<const float*>(a.in2[me]);
  for (int p = 0; p < a.n; ++p) {
    putmem_nbi(static_cast<uint4*>(a.land[p]) + static_cast<long long>(me) * R * dv, acc,
               lo * dv, hi * dv);
    float* lst = static_cast<float*>(a.out2[p]) + static_cast<long long>(me) * 2 * R;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      lst[i] = __ldcg(st + i);
      lst[R + i] = __ldcg(st + R + i);
    }
  }
  quiet();
  signal_all(a, kRegionA, me);
  wait_sources(a, kRegionA);
  const float4* land = static_cast<const float4*>(a.land[me]);
  const float* lst = static_cast<const float*>(a.out2[me]);
  float4* out = static_cast<float4*>(a.out[me]);
  for (long long i = lo * dv + threadIdx.x; i < hi * dv; i += blockDim.x) {
    const long long row = i / dv;
    float m_star = -INFINITY;
    for (int p = 0; p < a.n; ++p) m_star = fmaxf(m_star, __ldcg(lst + p * 2LL * R + row));
    float l_star = 0.f;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < a.n; ++p) {
      const float sc = expf(__ldcg(lst + p * 2LL * R + row) - m_star);
      l_star += __ldcg(lst + p * 2LL * R + R + row) * sc;
      const float4 v = __ldcg(land + p * static_cast<long long>(R) * dv + i);
      if (p == 0) {
        s = make_float4(v.x * sc, v.y * sc, v.z * sc, v.w * sc);
      } else {
        s.x += v.x * sc;
        s.y += v.y * sc;
        s.z += v.z * sc;
        s.w += v.w * sc;
      }
    }
    const float inv_l = 1.f / fmaxf(l_star, 1e-30f);
    out[i] = make_float4(s.x * inv_l, s.y * inv_l, s.z * inv_l, s.w * inv_l);
  }
}

}  // namespace

cudaError_t tdt::lse_combine(const CommArgs& a, int R, int d, int ctas, cudaStream_t stream) {
  if (R == 0) return cudaSuccess;
  if (R < 0 || d < 4 || d % 4) return cudaErrorInvalidValue;
  tdt::CommArgs args_v = a;
  void* args[] = {&args_v, &R, &d};
  return tdt::coop_launch(lse_combine_kernel, a, ctas, 0, args, stream);
}
