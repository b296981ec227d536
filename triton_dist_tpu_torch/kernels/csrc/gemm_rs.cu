// Kernel F, gemm_rs over n ranks: C = reduce_scatter(sum over ranks of A_r @
// B_r). Rank r holds A_r [M, k] (its K-shard of the activations, bf16 or
// f32) and B_r [k, N] (its row shard of the weight, in A's dtype or an int8
// QuantW panel with per-column f32 scales) and gets rows [r * M / n, (r + 1) * M / n)
// of the sum in A's dtype. The O and down projections of the "dist"
// backend.
//
// Replaces triton_dist_tpu/kernels/gemm_reduce_scatter.py `_gemm_rs_kernel`
// (:93; the pallas_call of `_gemm_rs_call` at :315), with its roundings:
// each partial tile in f32, scaled per column for an int8 panel, rounded to
// A's dtype (:196-203); then the ring fold, which adds the landed chunk in
// f32 and rounds at every hop (:247-249), chunk c starting at rank c + 1 and
// ending at rank c. That is tdt_shmem::ring_reduce_scatter over the rounded
// partials, so the result differs from gemm_rs_ref only by the products'
// summation order.
//
// What bounds it: at decode (M = 64-128, k = 512-1536 a rank, N = 2048,
// bf16) bytes, the weight panel (2 k N bytes a rank); at prefill (M = 16384)
// operations. On four cards the ring moves (n - 1) / n of each rank's
// partial over NVLink.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks). A
// CTA raises its barrier flag first; persistent CTAs (t = g, g + ctas, ...)
// write the rank's rounded partial [M, N] tile by tile into its local
// buffer (gemm_tile.cuh RowTile); a rank_barrier follows, since CTA g's
// ring slice of a chunk spans tiles that other CTAs wrote; then every CTA
// waits for the peers' barrier flags (no rank writes into a landing buffer
// a peer may still read from its previous call) and runs the ring. The
// products and the ring do not overlap yet.
#include "gemm_tile.cuh"
#include "ring.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads)
    gemm_rs_kernel(CommArgs a, long long cvec, int M, int N, int K) {
  using Tl = tdt_gemm::RowTile<T, BT>;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int me = my_pe(a);
  // barrier_all, split: arrive now, wait before the first put
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int p = 0; p < a.n; ++p) signal_op(a.sig[p] + kBarrier + me, a.epoch);
  const T* A = static_cast<const T*>(a.in[me]);
  const BT* B = static_cast<const BT*>(a.in2[me]);
  const float* scale = a.scale[me];
  T* P = static_cast<T*>(a.out2[me]);
  const int tn = (N + Tl::BN - 1) / Tl::BN;
  const int tiles = ((M + Tl::BM - 1) / Tl::BM) * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tn) * Tl::BM, n0 = (t % tn) * Tl::BN;
    Tl::compute(A, B, M, N, K, m0, n0, smem);
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (m0 + r >= M || n0 + c >= N) continue;
      *reinterpret_cast<uint4*>(P + static_cast<long long>(m0 + r) * N + n0 + c) =
          tdt_gemm::tile_vec<T, Tl::LD>(Cs, r, c, scale, n0 + c);
    }
  }
  rank_barrier(a, kRegionB);
  wait_all(a, a.sig[me] + kBarrier, 1);
  ring_reduce_scatter<T>(a, static_cast<const uint4*>(a.out2[me]),
                         static_cast<uint4*>(a.out[me]), cvec, kRegionA);
}

template <typename T, typename BT>
cudaError_t launch(const tdt::CommArgs& a, long long cvec, int M, int N, int K, int ctas,
                   cudaStream_t stream) {
  tdt::CommArgs args_v = a;
  void* args[] = {&args_v, &cvec, &M, &N, &K};
  return tdt::coop_launch(gemm_rs_kernel<T, BT>, a, ctas, tdt_gemm::RowTile<T, BT>::kSmem,
                          args, stream);
}

}  // namespace

cudaError_t tdt::gemm_rs(int a_dtype, int b_dtype, const CommArgs& a, long long cvec, int M,
                         int N, int K, int ctas, cudaStream_t stream) {
  if (M == 0 || N == 0 || cvec == 0) return cudaSuccess;
  if (M % a.n || a.n < 2) return cudaErrorInvalidValue;
  if (a_dtype == kBF16 && (K % 8 || N % 8)) return cudaErrorInvalidValue;
  if (a_dtype == kBF16 && b_dtype == kBF16)
    return launch<bf16, bf16>(a, cvec, M, N, K, ctas, stream);
  if (a_dtype == kBF16 && b_dtype == kI8)
    return launch<bf16, int8_t>(a, cvec, M, N, K, ctas, stream);
  if (a_dtype == kF32 && b_dtype == kF32 && N % 4 == 0)
    return launch<float, float>(a, cvec, M, N, K, ctas, stream);
  if (a_dtype == kF32 && b_dtype == kI8 && N % 4 == 0)
    return launch<float, int8_t>(a, cvec, M, N, K, ctas, stream);
  return cudaErrorInvalidValue;
}
