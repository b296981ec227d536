// Kernel E, ag_gemm over n ranks: C_r = allgather(A) @ B_r. Rank r holds the
// row shard A_r [m, K] (bf16 or f32) and the column shard B_r [K, N] (in
// A's dtype, or an int8 QuantW panel with per-column f32 scales) and gets
// C_r [n * m, N] in A's dtype; the gathered A stays in the rank's symmetric
// buffer. The QKV and gate/up projections of the "dist" backend.
//
// Replaces triton_dist_tpu/kernels/allgather_gemm.py `_ag_gemm_kernel`
// (:127; the pallas_call of `_ag_gemm_call` at :341): a ring all-gather of
// the A chunks and, per chunk, the tile products against the local B shard
// in f32, an int8 panel widened to A's dtype before the dot and its scale
// applied per column after it, each tile rounded once to A's dtype
// (:253-260). The result is the f32 product of the gathered A and B_r
// rounded once, what ag_gemm_ref computes, up to the product's summation
// order.
//
// What bounds it: at decode (M = 64-128 rows, K = 2048, N = 1024-3072 a
// rank, bf16) bytes, the weight panel (2 K N bytes a rank) against 2 M K N
// flops; at prefill (M = 16384) operations. On four cards the ring moves
// (n - 1) m K of A into each rank over NVLink.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks).
// Persistent CTAs first copy their slice of the local chunk into slot me of
// the gathered buffer, enter through barrier_all, and run
// tdt_shmem::ring_all_gather (CTA g forwards slice g of every chunk and
// waits only for CTA g of its left neighbour); a rank_barrier then tells
// every CTA that every slice has landed, since a tile's rows span slices
// that other CTAs received. The tile loop (t = g, g + ctas, ...) is
// gemm_tile.cuh's RowTile over the gathered A. The ring and the products do
// not overlap: the local chunk first with per-chunk arrival waits, wgmma and
// TMA are later work.
#include "gemm_tile.cuh"
#include "ring.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads)
    ag_gemm_kernel(CommArgs a, long long cvec, int M, int N, int K) {
  using Tl = tdt_gemm::RowTile<T, BT>;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int me = my_pe(a);
  long long lo, hi;
  split(cvec, lo, hi);
  // the local chunk first: only this rank's CTA g reads it back (the ring)
  putmem_nbi(static_cast<uint4*>(a.out[me]) + me * cvec, static_cast<const uint4*>(a.in[me]),
             lo, hi);
  barrier_all(a);
  ring_all_gather(a, cvec, kRegionA);
  rank_barrier(a, kRegionB);
  const T* A = static_cast<const T*>(a.out[me]);
  const BT* B = static_cast<const BT*>(a.in2[me]);
  const float* scale = a.scale[me];
  T* C = static_cast<T*>(a.out2[me]);
  const int tn = (N + Tl::BN - 1) / Tl::BN;
  const int tiles = ((M + Tl::BM - 1) / Tl::BM) * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tn) * Tl::BM, n0 = (t % tn) * Tl::BN;
    Tl::compute(A, B, M, N, K, m0, n0, smem);
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (m0 + r >= M || n0 + c >= N) continue;
      *reinterpret_cast<uint4*>(C + static_cast<long long>(m0 + r) * N + n0 + c) =
          tdt_gemm::tile_vec<T, Tl::LD>(Cs, r, c, scale, n0 + c);
    }
  }
}

template <typename T, typename BT>
cudaError_t launch(const tdt::CommArgs& a, long long cvec, int M, int N, int K, int ctas,
                   cudaStream_t stream) {
  tdt::CommArgs args_v = a;
  void* args[] = {&args_v, &cvec, &M, &N, &K};
  return tdt::coop_launch(ag_gemm_kernel<T, BT>, a, ctas, tdt_gemm::RowTile<T, BT>::kSmem,
                          args, stream);
}

}  // namespace

cudaError_t tdt::ag_gemm(int a_dtype, int b_dtype, const CommArgs& a, long long cvec, int M,
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
