// Kernel (row 28), gemm_all_to_all over n ranks: the QKV projection fused
// with the Ulysses dispatch. Rank r holds a block of the tokens, a_r [m, K]
// (bf16 or f32), and the whole weight w [K, n * Nc] in a's dtype, its
// columns head-group-major (chunk j: head group j's q, k and v columns).
// Rank j gets out_j [n, m, Nc], slot p = a_p @ w[:, chunk j]: the
// projection of the head group it owns over every rank's tokens. Rank
// me's tiles of chunk j are rounded once to a's dtype and stored straight
// into slot me of owner j's output.
//
// Replaces triton_dist_tpu/kernels/sp_attention.py `_gemm_a2a_kernel`
// (:635; the pallas_call of `_gemm_a2a_call` at :855, reached by
// gemm_all_to_all and qkv_gemm_a2a): per chunk j the f32 dot a @ w[:, j]
// rounded to a's dtype and put into owner j's slot me. The result is what
// gemm_all_to_all_ref computes, up to the products' summation order. The
// TPU kernel pads Nc to a multiple of 128 lanes (:845-853), Mosaic's DMA
// alignment, which has no counterpart here.
//
// What bounds it: operations. At the Ulysses prefill (m = 4096 tokens a
// rank, K = 2048, n Nc = 4096, bf16) a rank's product is 2 m K n Nc = 68.7
// GFLOP, the four ranks emulated on one card 275 GFLOP (0.278 ms at 989
// TFLOP/s); across cards (n - 1) / n of each output crosses NVLink, under
// the products.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all (csrc/shmem.cuh): every owner has reached
// this call, so its stream is done with whatever its output's memory held
// before. Persistent CTAs walk the n chunks' tiles starting at chunk
// me + 1, so that the ranks store into different owners at once and the
// local chunk comes last; each tile is gemm_tile.cuh's RowTile (128 x 128
// wmma in bf16, 64 x 64 FMA in f32) of a against the chunk's column panel
// of w (row stride n Nc), and its epilogue stores 16-byte vectors into
// the owner's slot: the put is the epilogue, as the reference's tile
// epilogue issues its putmem. Then each CTA raises its flag me in every
// owner's pad and waits for CTA g of every source, so the launch ends on
// a device only once every slot of its ranks' outputs has landed. wgmma,
// TMA and overlapping the stores with the next tile's loads are later
// work.
#include "gemm_tile.cuh"
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T>
__global__ void __launch_bounds__(kThreads) gemm_a2a_kernel(CommArgs a, int m, int Nc, int K) {
  using Tl = tdt_gemm::RowTile<T, T>;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int me = my_pe(a);
  const long long N = static_cast<long long>(a.n) * Nc;
  const T* A = static_cast<const T*>(a.in[me]);
  const T* W = static_cast<const T*>(a.in2[me]);
  barrier_all(a);
  const int tn = (Nc + Tl::BN - 1) / Tl::BN;
  const int per = ((m + Tl::BM - 1) / Tl::BM) * tn;  // tiles of one chunk
  for (int t = blockIdx.x; t < a.n * per; t += gridDim.x) {
    const int j = (me + 1 + t / per) % a.n;
    const int m0 = ((t % per) / tn) * Tl::BM, n0 = ((t % per) % tn) * Tl::BN;
    Tl::compute_ld(A, K, W + static_cast<long long>(j) * Nc, N, m, Nc, K, m0, n0, smem);
    T* dst = static_cast<T*>(a.out[j]) + static_cast<long long>(me) * m * Nc;
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (m0 + r >= m || n0 + c >= Nc) continue;
      *reinterpret_cast<uint4*>(dst + static_cast<long long>(m0 + r) * Nc + n0 + c) =
          tdt_gemm::tile_vec<T, Tl::LD>(Cs, r, c, nullptr, 0);
    }
  }
  quiet();
  signal_all(a, kRegionA, me);
  wait_sources(a, kRegionA);
}

template <typename T>
cudaError_t launch(const tdt::CommArgs& a, int m, int Nc, int K, int ctas,
                   cudaStream_t stream) {
  tdt::CommArgs args_v = a;
  void* args[] = {&args_v, &m, &Nc, &K};
  return tdt::coop_launch(gemm_a2a_kernel<T>, a, ctas, tdt_gemm::RowTile<T, T>::kSmem, args,
                          stream);
}

}  // namespace

cudaError_t tdt::gemm_all_to_all(int dtype, const CommArgs& a, int m, int Nc, int K, int ctas,
                                 cudaStream_t stream) {
  if (m == 0 || Nc == 0) return cudaSuccess;
  if (K < 1) return cudaErrorInvalidValue;
  if (dtype == kBF16 && K % 8 == 0 && Nc % 8 == 0)
    return launch<bf16>(a, m, Nc, K, ctas, stream);
  if (dtype == kF32 && Nc % 4 == 0) return launch<float>(a, m, Nc, K, ctas, stream);
  return cudaErrorInvalidValue;
}
