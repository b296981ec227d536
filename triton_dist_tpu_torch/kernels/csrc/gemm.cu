// One GEMM, C = A @ B, for the world-size-1 forms of ag_gemm and gemm_rs.
//
// Replaces, at one rank, the TPU kernels triton_dist_tpu/kernels/
// allgather_gemm.py `_ag_gemm_kernel` (the pallas_call at :341) and
// gemm_reduce_scatter.py `_gemm_rs_kernel` (the pallas_call at :315): with
// one rank their rings have one step and the collective moves nothing, so
// each kernel's body is the whole product, jnp.dot with f32 accumulation
// and one rounding to A's dtype. The ring, its signals and the overlap of
// the multi-rank forms are not here.
//
// A [M, K] and B [K, N] come with a row and a column stride each, so the
// training backward's B^T (grad.py's _transpose_rows/_transpose_cols) is
// a view: each operand may be row-major (unit column stride) or
// column-major (unit row stride). C [M, N] is contiguous.
//
// What bounds it on an H100: at the training step's shapes (M = 4096,
// K and N of 2048-12288) operations: 2*M*N*K flops against 2*(MK + KN +
// MN) bytes, 350-700 flops a byte, above the card's ~295.
//
// Design, bf16. One CTA per 128 x 128 tile of C, 256 threads in 8 warps, 2
// (rows) x 4 (columns); BK = 32-deep panels of A and B stream through a
// 4-stage cp.async ring in shared memory, each warp multiplying bf16 wmma
// 16x16x16 fragments into f32 accumulators over a 64 x 32 piece of the
// tile; an operand is staged in its own major order (16-byte copies along
// its unit-stride dimension) and loaded as a row- or column-major wmma
// fragment, so a transposed operand costs no copy. Rows and columns past
// the edges load as zeros and are not stored. The epilogue stages the f32
// tile in shared memory (the ring, reused), rounds it once and writes
// 16-byte vectors. This is grouped_gemm.cu's tile loop at BM = 128; it is
// written out here rather than shared through a header because that
// kernel stages row-major operands only and picks its M tile from the
// expert capacity, and a shared loop would template a kernel of the
// serving path on layouts it never takes.
//
// f32 (the port's f32 models): a plain FMA tile loop, 64 x 64 tiles of 4 x
// 4 per thread, any strides; no tensor core takes f32 without rounding
// its inputs (TF32).
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 32, kStages = 4;
constexpr int LDC = BN + 4;

// shared layout of one operand panel: ROW = rows of the panel along its
// unit-stride dimension. A panel is BM x BK (A) or BK x BN (B).
template <bool A_ROW, bool B_ROW> struct Tile {
  static constexpr int kLdA = A_ROW ? BK + 8 : BM + 8;  // 16-byte rows, spread banks
  static constexpr int kLdB = B_ROW ? BN + 8 : BK + 8;
  static constexpr int kAElems = A_ROW ? BM * kLdA : BK * kLdA;
  static constexpr int kBElems = B_ROW ? BK * kLdB : BN * kLdB;
  static constexpr int kStageElems = kAElems + kBElems;
  static constexpr int kRingBytes = kStages * kStageElems * 2;
  static constexpr int kCBytes = BM * LDC * 4;
  static constexpr int kSmemBytes = kRingBytes > kCBytes ? kRingBytes : kCBytes;
};

// A_ROW: A's column stride is 1 (else its row stride is); B_ROW likewise.
// The unit-stride extents (K for a row-major A, M for a column-major one;
// N for a row-major B, K for a column-major one) and N are multiples of 8.
template <bool A_ROW, bool B_ROW>
__global__ void __launch_bounds__(kThreads)
    gemm_bf16_kernel(const bf16* __restrict__ a, long long lda, const bf16* __restrict__ b,
                     long long ldb, bf16* __restrict__ c, int M, int N, int K) {
  using namespace nvcuda;
  using Tl = Tile<A_ROW, B_ROW>;
  using ALayout = std::conditional_t<A_ROW, wmma::row_major, wmma::col_major>;
  using BLayout = std::conditional_t<B_ROW, wmma::row_major, wmma::col_major>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nk = (K + BK - 1) / BK;

  // 16-byte chunks of one panel: `outer` lines of `inner` elements along
  // the unit-stride dimension; line i, chunk at e of panel (o0, i0) reads
  // src[(o0 + i) * ld + i0 + e] when o0 + i < outer_lim and i0 + e < inner_lim
  auto copy = [&](bf16* dst, int ldd, const bf16* src, long long ld, int outer, int inner,
                  int o0, int i0, int outer_lim, int inner_lim) {
    for (int ch = tid; ch < outer * (inner / 8); ch += kThreads) {
      const int o = ch / (inner / 8), e = (ch % (inner / 8)) * 8;
      const bool ok = o0 + o < outer_lim && i0 + e < inner_lim;
      cp_async16(dst + o * ldd + e, ok ? src + (o0 + o) * ld + i0 + e : src, ok ? 16 : 0);
    }
  };
  auto load = [&](int kt, int s) {
    bf16* As = sm + s * Tl::kStageElems;
    bf16* Bs = As + Tl::kAElems;
    const int k0 = kt * BK;
    if (A_ROW)
      copy(As, Tl::kLdA, a, lda, BM, BK, m0, k0, M, K);
    else
      copy(As, Tl::kLdA, a, lda, BK, BM, k0, m0, K, M);
    if (B_ROW)
      copy(Bs, Tl::kLdB, b, ldb, BK, BN, k0, n0, K, N);
    else
      copy(Bs, Tl::kLdB, b, ldb, BN, BK, n0, k0, N, K);
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    wmma::fill_fragment(acc[i][0], 0.f);
    wmma::fill_fragment(acc[i][1], 0.f);
  }
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // panel kt landed; the slot refilled below is consumed
    if (kt + kStages - 1 < nk) load(kt + kStages - 1, (kt + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* As = sm + (kt % kStages) * Tl::kStageElems;
    const bf16* Bs = As + Tl::kAElems;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(fb[j], B_ROW ? Bs + ks * Tl::kLdB + n : Bs + n * Tl::kLdB + ks,
                               Tl::kLdB);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = wm * 64 + i * 16;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> fa;
        wmma::load_matrix_sync(fa, A_ROW ? As + m * Tl::kLdA + ks : As + ks * Tl::kLdA + m,
                               Tl::kLdA);
        wmma::mma_sync(acc[i][0], fa, fb[0], acc[i][0]);
        wmma::mma_sync(acc[i][1], fa, fb[1], acc[i][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the C tile
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j],
                              LDC, wmma::mem_row_major);
  __syncthreads();
  for (int ch = tid; ch < BM * (BN / 8); ch += kThreads) {
    const int r = ch / (BN / 8), col = (ch % (BN / 8)) * 8;
    if (m0 + r >= M || n0 + col >= N) continue;
    store16<bf16>(c + static_cast<long long>(m0 + r) * N + n0 + col, Cs + r * LDC + col);
  }
}

template <bool A_ROW, bool B_ROW>
cudaError_t launch_bf16(const void* a, long long lda, const void* b, long long ldb, void* c,
                        int M, int N, int K, cudaStream_t stream) {
  constexpr int bytes = Tile<A_ROW, B_ROW>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<A_ROW, B_ROW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<A_ROW, B_ROW><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(a), lda, static_cast<const bf16*>(b), ldb,
      static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

// f32: 64 x 64 tile per CTA, 16-deep panels, thread (ty, tx) of 16 x 16
// owns rows ty + 16 * i and columns tx + 16 * j (i, j < 4)
constexpr int FT = 64, FK = 16;

__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const float* __restrict__ a, long long sam, long long sak,
                    const float* __restrict__ b, long long sbk, long long sbn,
                    float* __restrict__ c, int M, int N, int K) {
  __shared__ float As[FK][FT + 1];
  __shared__ float Bs[FK][FT + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * FT, m0 = blockIdx.y * FT;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += FK) {
    for (int idx = tid; idx < FT * FK; idx += kThreads) {
      const int mm = idx % FT, kk = idx / FT;  // A: consecutive threads along M
      As[kk][mm] = m0 + mm < M && k0 + kk < K ? a[(m0 + mm) * sam + (k0 + kk) * sak] : 0.f;
      const int nn = idx % FT;                 // B: consecutive threads along N
      Bs[kk][nn] = n0 + nn < N && k0 + kk < K ? b[(k0 + kk) * sbk + (n0 + nn) * sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty + 16 * i];
        bv[i] = Bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N) c[static_cast<long long>(m) * N + n] = acc[i][j];
    }
}

}  // namespace

cudaError_t tdt::gemm(int dtype, const void* a, long long sam, long long sak, const void* b,
                      long long sbk, long long sbn, void* c, int M, int N, int K,
                      cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (dtype == kF32) {
    const dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT);
    gemm_f32_kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(a), sam, sak, static_cast<const float*>(b), sbk, sbn,
        static_cast<float*>(c), M, N, K);
    return cudaGetLastError();
  }
  if (dtype != kBF16 || K % 8 || N % 8) return cudaErrorInvalidValue;
  const bool a_row = sak == 1, b_row = sbn == 1;
  if ((!a_row && (sam != 1 || M % 8)) || (!b_row && sbk != 1)) return cudaErrorInvalidValue;
  const long long lda = a_row ? sam : sak, ldb = b_row ? sbk : sbn;
  if (a_row && b_row) return launch_bf16<true, true>(a, lda, b, ldb, c, M, N, K, stream);
  if (a_row) return launch_bf16<true, false>(a, lda, b, ldb, c, M, N, K, stream);
  if (b_row) return launch_bf16<false, true>(a, lda, b, ldb, c, M, N, K, stream);
  return launch_bf16<false, false>(a, lda, b, ldb, c, M, N, K, stream);
}
