// Kernel (row 27), o_a2a_gemm over n ranks: the Ulysses combine fused with
// the O projection. Rank r holds x_r [n, m, Nc] (bf16 or f32: its head
// group's attention output over the whole sequence, chunk p = sequence
// block p) and w [n * Nc, D] in x's dtype (the O projection's rows,
// head-group-major) and gets y_r [m, D] = sum over q of chunk r of x_q @
// w[q * Nc:(q + 1) * Nc]: its sequence block projected over every head
// group.
//
// Replaces triton_dist_tpu/kernels/sp_attention.py `_a2a_gemm_kernel`
// (:735; the pallas_call of `o_a2a_gemm` at :816): every remote chunk
// pushed first into slot me of its owner's landing buffer, the local chunk
// multiplied at once, each landed chunk folded into an f32 accumulator in
// the order me, me + 1, ..., and the sum rounded once to x's dtype, as
// o_a2a_gemm_ref computes it, up to the products' summation order.
//
// What bounds it: operations. At the Ulysses prefill (m = 4096 tokens a
// rank, n Nc = 2048, D = 2048, bf16) a rank's products are 2 m n Nc D =
// 34.4 GFLOP, the four ranks emulated on one card 137 GFLOP (0.139 ms at
// 989 TFLOP/s); the pushes move (n - 1) m Nc elements a rank (over NVLink
// across cards), under the local chunk's products.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all (csrc/shmem.cuh), so that no rank writes
// into a peer's landing buffer (symmetric, reused by every call) while the
// peer still reads it in its previous call. CTA g pushes slice g of each
// remote chunk into its owner's slot me (16-byte vectors, owners staggered
// from me + 1) and raises its flag me there (region A). Then the CTAs walk
// the output's tiles; each tile takes the chunk products in the order me,
// me + 1, ... (gemm_tile.cuh's RowTile: 128 x 128 wmma in bf16, 64 x 64
// FMA in f32), added into an f32 tile in shared memory, the local chunk
// first and with no wait, a remote chunk q once every CTA of rank q has
// signalled (a tile's rows span slices that all of q's CTAs wrote; a CTA
// waits for each source once). Landed chunks reach the tiles through
// cp.async.cg, through L2 and never a stale L1 line. The sum is rounded
// once and stored. wgmma, TMA and finer-grained arrival flags are later
// work.
#include "gemm_tile.cuh"
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T> struct A2aGemm {
  using Tl = tdt_gemm::RowTile<T, T>;
  static constexpr int kPer = Tl::BM * Tl::BN / kThreads;   // tile elements a thread
  static constexpr int kSmem = Tl::kSmem + Tl::BM * Tl::BN * 4;
};

template <typename T>
__global__ void __launch_bounds__(kThreads) a2a_gemm_kernel(CommArgs a, int m, int Nc, int D) {
  using Tl = typename A2aGemm<T>::Tl;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  float* acc = reinterpret_cast<float*>(smem + Tl::kSmem);
  const int me = my_pe(a);
  const long long chunk = static_cast<long long>(m) * Nc;  // elements
  const long long cvec = chunk / V;
  const T* X = static_cast<const T*>(a.in[me]);
  const T* W = static_cast<const T*>(a.in2[me]);
  const T* L = static_cast<const T*>(a.land[me]);
  T* Y = static_cast<T*>(a.out[me]);
  barrier_all(a);
  long long lo, hi;
  split(cvec, lo, hi);
  for (int s = 1; s < a.n; ++s) {
    const int p = (me + s) % a.n;
    putmem_nbi(static_cast<uint4*>(a.land[p]) + me * cvec,
               reinterpret_cast<const uint4*>(X) + p * cvec, lo, hi);
  }
  quiet();
  if (threadIdx.x == 0)
    for (int s = 1; s < a.n; ++s) signal_op(flag(a.sig[(me + s) % a.n], kRegionA, me), a.epoch);
  unsigned arrived = 1u << me;
  const int tn = (D + Tl::BN - 1) / Tl::BN;
  const int tiles = ((m + Tl::BM - 1) / Tl::BM) * tn;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = (t / tn) * Tl::BM, n0 = (t % tn) * Tl::BN;
    for (int s = 0; s < a.n; ++s) {
      const int q = (me + s) % a.n;
      if (!((arrived >> q) & 1u)) {
        if (threadIdx.x == 0) signal_wait_rank(a, kRegionA, q);
        __syncthreads();
        arrived |= 1u << q;
      }
      const T* A = (q == me ? X : L) + q * chunk;
      Tl::compute_ld(A, Nc, W + static_cast<long long>(q) * Nc * D, D, m, D, Nc, m0, n0, smem);
      // each thread adds the same elements every time: no barrier needed
#pragma unroll
      for (int i = 0; i < A2aGemm<T>::kPer; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const float v = Cs[(e / Tl::BN) * Tl::LD + e % Tl::BN];
        acc[e] = s == 0 ? v : acc[e] + v;
      }
    }
#pragma unroll
    for (int i = 0; i < A2aGemm<T>::kPer; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / Tl::BN, c = e % Tl::BN;
      if (m0 + r < m && n0 + c < D)
        Y[static_cast<long long>(m0 + r) * D + n0 + c] = from_f<T>(acc[e]);
    }
  }
}

template <typename T>
cudaError_t launch(const tdt::CommArgs& a, int m, int Nc, int D, int ctas,
                   cudaStream_t stream) {
  tdt::CommArgs args_v = a;
  void* args[] = {&args_v, &m, &Nc, &D};
  return tdt::coop_launch(a2a_gemm_kernel<T>, a, ctas, A2aGemm<T>::kSmem, args, stream);
}

}  // namespace

cudaError_t tdt::o_a2a_gemm(int dtype, const CommArgs& a, int m, int Nc, int D, int ctas,
                            cudaStream_t stream) {
  if (m == 0 || D == 0) return cudaSuccess;
  if (Nc < 1 || a.n > 32) return cudaErrorInvalidValue;
  if (dtype == kBF16 && Nc % 8 == 0 && D % 8 == 0)
    return launch<bf16>(a, m, Nc, D, ctas, stream);
  if (dtype == kF32 && Nc % 4 == 0) return launch<float>(a, m, Nc, D, ctas, stream);
  return cudaErrorInvalidValue;
}
