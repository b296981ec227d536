// One GEMM, C = A @ B, for the world-size-1 forms of ag_gemm and gemm_rs.
//
// Replaces, at one rank, the TPU kernels triton_dist_tpu/kernels/
// allgather_gemm.py `_ag_gemm_kernel` (the pallas_call at :341) and
// gemm_reduce_scatter.py `_gemm_rs_kernel` (the pallas_call at :315): with
// one rank their rings have one step and the collective moves nothing, so
// each kernel's body is the whole product, jnp.dot with f32 accumulation
// and one rounding to A's dtype. The rings of the multi-rank forms are
// ag_gemm.cu and gemm_rs.cu.
//
// A [M, K] and B [K, N] come with a row and a column stride each, so the
// training backward's B^T (grad.py's _transpose_rows/_transpose_cols) is
// a view: each operand may be row-major (unit column stride) or
// column-major (unit row stride). C [M, N] is contiguous. B may also be an
// int8 QuantW panel: widened to A's dtype as it is staged (row-major under
// a bf16 A), its per-column f32 scale applied to the f32 tile before the
// one rounding, as the Pallas kernels do (allgather_gemm.py:253-260).
//
// What bounds it on an H100: at the training step's shapes (M = 4096,
// K and N of 2048-12288) operations: 2*M*N*K flops against 2*(MK + KN +
// MN) bytes, 350-700 flops a byte, above the card's ~295.
//
// Design: one CTA per tile of C, the tile products of gemm_tile.cuh
// (RowTile's bf16 tile in the comm GEMMs). bf16: 128 x 128 tiles from a 4-stage
// cp.async ring into wmma fragments, the f32 tile staged in shared memory
// (the ring, reused), rounded once and written as 16-byte vectors; rows
// and columns past the edges are not stored. This is grouped_gemm.cu's
// tile loop at BM = 128; it is not shared with that kernel because that
// one stages row-major operands only and picks its M tile from the expert
// capacity. f32 (the port's f32 models): the plain FMA tile, 64 x 64.
#include "gemm_tile.cuh"

namespace {

using namespace tdt_gemm;

template <bool A_ROW, bool B_ROW, typename BT>
__global__ void __launch_bounds__(kThreads)
    gemm_bf16_kernel(const bf16* __restrict__ a, long long lda, const BT* __restrict__ b,
                     long long ldb, const float* __restrict__ scale, bf16* __restrict__ c,
                     int M, int N, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  product_tile<A_ROW, B_ROW, BT>(a, lda, b, ldb, M, N, K, m0, n0, smem);
  for (int ch = threadIdx.x; ch < BM * (BN / 8); ch += kThreads) {
    const int r = ch / (BN / 8), col = (ch % (BN / 8)) * 8;
    if (m0 + r >= M || n0 + col >= N) continue;
    *reinterpret_cast<uint4*>(c + static_cast<long long>(m0 + r) * N + n0 + col) =
        tile_vec<bf16, LDC>(Cs, r, col, scale, n0 + col);
  }
}

template <bool A_ROW, bool B_ROW, typename BT>
cudaError_t launch_bf16(const void* a, long long lda, const void* b, long long ldb,
                        const float* scale, void* c, int M, int N, int K,
                        cudaStream_t stream) {
  constexpr int bytes = Tile<A_ROW, B_ROW>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<A_ROW, B_ROW, BT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_bf16_kernel<A_ROW, B_ROW, BT><<<grid, kThreads, bytes, stream>>>(
      static_cast<const bf16*>(a), lda, static_cast<const BT*>(b), ldb, scale,
      static_cast<bf16*>(c), M, N, K);
  return cudaGetLastError();
}

template <typename BT>
__global__ void __launch_bounds__(kThreads)
    gemm_f32_kernel(const float* __restrict__ a, long long sam, long long sak,
                    const BT* __restrict__ b, long long sbk, long long sbn,
                    const float* __restrict__ scale, float* __restrict__ c, int M, int N,
                    int K) {
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * FT, m0 = blockIdx.y * FT;
  float acc[4][4];
  product_tile_f32<BT>(a, sam, sak, b, sbk, sbn, M, N, K, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N)
        c[static_cast<long long>(m) * N + n] = acc[i][j] * (scale ? scale[n] : 1.f);
    }
}

}  // namespace

cudaError_t tdt::gemm(int dtype, int b_dtype, const void* a, long long sam, long long sak,
                      const void* b, long long sbk, long long sbn, const float* scale,
                      void* c, int M, int N, int K, cudaStream_t stream) {
  if (M == 0 || N == 0) return cudaSuccess;
  if (dtype == kF32) {
    const dim3 grid((N + FT - 1) / FT, (M + FT - 1) / FT);
    if (b_dtype == kF32)
      gemm_f32_kernel<float><<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(a), sam, sak, static_cast<const float*>(b), sbk, sbn,
          scale, static_cast<float*>(c), M, N, K);
    else if (b_dtype == kI8)
      gemm_f32_kernel<int8_t><<<grid, kThreads, 0, stream>>>(
          static_cast<const float*>(a), sam, sak, static_cast<const int8_t*>(b), sbk, sbn,
          scale, static_cast<float*>(c), M, N, K);
    else
      return cudaErrorInvalidValue;
    return cudaGetLastError();
  }
  if (dtype != kBF16 || K % 8 || N % 8) return cudaErrorInvalidValue;
  const bool a_row = sak == 1, b_row = sbn == 1;
  if ((!a_row && (sam != 1 || M % 8)) || (!b_row && sbk != 1)) return cudaErrorInvalidValue;
  const long long lda = a_row ? sam : sak, ldb = b_row ? sbk : sbn;
  if (b_dtype == kI8) {
    if (!b_row) return cudaErrorInvalidValue;
    return a_row ? launch_bf16<true, true, int8_t>(a, lda, b, ldb, scale, c, M, N, K, stream)
                 : launch_bf16<false, true, int8_t>(a, lda, b, ldb, scale, c, M, N, K, stream);
  }
  if (b_dtype != kBF16) return cudaErrorInvalidValue;
  if (a_row && b_row) return launch_bf16<true, true, bf16>(a, lda, b, ldb, scale, c, M, N, K,
                                                           stream);
  if (a_row) return launch_bf16<true, false, bf16>(a, lda, b, ldb, scale, c, M, N, K, stream);
  if (b_row) return launch_bf16<false, true, bf16>(a, lda, b, ldb, scale, c, M, N, K, stream);
  return launch_bf16<false, false, bf16>(a, lda, b, ldb, scale, c, M, N, K, stream);
}
