// Kernel B, gemm_allreduce: C = sum over ranks of A_r @ B_r, replicated on
// every rank, in one kernel. A_r [M, k_loc] is rank r's K-shard of the
// activations, B_r [k_loc, N] its row shard of the weight (bf16, or an int8
// QuantW panel with per-column f32 scales); the decode O and down
// projections of the "gemm_ar" backend.
//
// Replaces triton_dist_tpu/kernels/gemm_allreduce.py `_gemm_ar_kernel` (the
// pallas_call of `_gemm_ar_call` at :225): each rank computes its partial
// tile by tile in f32 (an int8 panel widened to A's dtype before the dot,
// its scale applied per column after it), rounds the tile to A's dtype and
// pushes it into slot me of every rank's landing buffer [n, M, N]; then
// every rank sums the n landed tiles in rank order in f32 and rounds once.
// Those are the Pallas kernel's roundings (:141-147, :167-185), so the
// result differs from gemm_allreduce_ref only by the product's own
// summation order.
//
// What bounds it: at decode (M = 64-128 rows, k_loc = 512-1536, N = 2048,
// bf16) bytes: the weight panel dominates (2 k_loc N bytes a rank) against
// 2 M k_loc N flops, 64-128 flops a byte, below the card's ~295. On four
// cards the pushes add (n-1) M N of NVLink traffic a rank.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks);
// persistent CTAs loop over the output tiles t = g, g + ctas, ..., so the
// grid is sized to be resident (four ranks share the card's 132 SMs when
// emulated on one) whatever the tile count. The tile product is
// gemm_tile.cuh's RowTile (shared with ag_gemm.cu and gemm_rs.cu; its bf16
// tile is gemm.cu's): 128 x 128 bf16 tiles (wmma, a
// 4-stage cp.async ring; an int8 panel widened as it is staged), 64 x 64
// FMA tiles for f32. A CTA raises its barrier flag first and waits for its
// peers' only after its first product, so the barrier hides under the
// GEMM; every rank's CTA g owns the same tiles, so CTA g waits for CTA g
// of every peer before it reduces.
#include "gemm_tile.cuh"
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads) gemm_ar_kernel(CommArgs a, int M, int N, int K) {
  using Tl = tdt_gemm::RowTile<T, BT>;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int me = my_pe(a);
  const T* A = static_cast<const T*>(a.in[me]);
  const BT* B = static_cast<const BT*>(a.in2[me]);
  const float* scale = a.scale[me];
  const int tn = (N + Tl::BN - 1) / Tl::BN;
  const int tiles = ((M + Tl::BM - 1) / Tl::BM) * tn;
  // barrier_all, split: arrive now, wait before the first put
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int p = 0; p < a.n; ++p) signal_op(a.sig[p] + kBarrier + me, a.epoch);
  bool entered = false;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tn) * Tl::BM, n0 = (t % tn) * Tl::BN;
    Tl::compute(A, B, M, N, K, m0, n0, smem);
    if (!entered) {
      wait_all(a, a.sig[me] + kBarrier, 1);
      entered = true;
    }
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (m0 + r >= M || n0 + c >= N) continue;
      // the partial, rounded to A's dtype
      const uint4 tile16 = tdt_gemm::tile_vec<T, Tl::LD>(Cs, r, c, scale, n0 + c);
      const long long off = (static_cast<long long>(me) * M + m0 + r) * N + n0 + c;
      for (int p = 0; p < a.n; ++p)
        *reinterpret_cast<uint4*>(static_cast<T*>(a.land[p]) + off) = tile16;
    }
  }
  if (!entered) wait_all(a, a.sig[me] + kBarrier, 1);
  quiet();
  signal_all(a, kRegionA, me);
  wait_sources(a, kRegionA);
  const long long slot = static_cast<long long>(M) * N / V;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tn) * Tl::BM, n0 = (t % tn) * Tl::BN;
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (m0 + r >= M || n0 + c >= N) continue;
      reduce_landed<T>(static_cast<uint4*>(a.out[me]), static_cast<const uint4*>(a.land[me]),
                       slot, a.n, (static_cast<long long>(m0 + r) * N + n0 + c) / V);
    }
  }
}

template <typename T, typename BT>
cudaError_t launch(const tdt::CommArgs& a, int M, int N, int K, int ctas, cudaStream_t stream) {
  tdt::CommArgs args_v = a;
  void* args[] = {&args_v, &M, &N, &K};
  return tdt::coop_launch(gemm_ar_kernel<T, BT>, a, ctas, tdt_gemm::RowTile<T, BT>::kSmem,
                          args, stream);
}

}  // namespace

cudaError_t tdt::gemm_allreduce(int a_dtype, int b_dtype, const CommArgs& a, int M, int N,
                                int K, int ctas, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (a_dtype == kBF16 && (K % 8 || N % 8)) return cudaErrorInvalidValue;
  if (a_dtype == kBF16 && b_dtype == kBF16) return launch<bf16, bf16>(a, M, N, K, ctas, stream);
  if (a_dtype == kBF16 && b_dtype == kI8) return launch<bf16, int8_t>(a, M, N, K, ctas, stream);
  if (a_dtype == kF32 && b_dtype == kF32 && N % 4 == 0)
    return launch<float, float>(a, M, N, K, ctas, stream);
  return cudaErrorInvalidValue;
}
