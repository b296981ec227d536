// The tile products of gemm.cu, shared with gemm_allreduce.cu, ag_gemm.cu
// and gemm_rs.cu: one CTA of 256 threads computes one f32 tile of C = A @ B
// and leaves it where its caller's epilogue reads it.
//
// bf16 (product_tile): a 128 x 128 tile, 8 warps in 2 (rows) x 4
// (columns); BK = 32-deep panels of A and B stream through a 4-stage
// cp.async ring in shared memory, each warp multiplying bf16 wmma 16x16x16
// fragments into f32 accumulators over a 64 x 32 piece of the tile; an
// operand is staged in its own major order (16-byte copies along its
// unit-stride dimension) and loaded as a row- or column-major wmma
// fragment, so a transposed operand costs no copy. Rows and columns past
// the edges load as zeros. An int8 B (a QuantW panel, row-major only) is
// widened to bf16 as it is staged, with plain 8-byte loads in place of
// cp.async; the per-column scale is the caller's, after the product
// (tile_vec). The f32 tile lands in shared memory, [BM][LDC] floats over
// the ring.
//
// f32 (product_tile_f32, B f32 or an int8 panel widened as it is staged):
// a plain FMA loop over a 64 x 64 tile, thread
// (ty, tx) of 16 x 16 owning rows ty + 16 * i and columns tx + 16 * j
// (i, j < 4), any strides; no tensor core takes f32 without rounding its
// inputs (TF32).
//
// RowTile<T, BT> picks one of the two for the comm kernels' row-major A
// (T) and B (BT), with their row strides or packed (compute_ld, compute),
// and leaves the tile in shared memory as floats; tile_vec
// (their epilogues' and gemm.cu's) reads one 16-byte vector of it back,
// scaled per column and rounded to T.
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace tdt_gemm {

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
// BT: bf16, or int8_t (B_ROW only) widened to bf16 as it is staged. On
// return (after a __syncthreads) smem holds the tile as floats, row r at
// r * LDC; the call begins with a __syncthreads, so a persistent loop may
// read the previous tile up to the next call.
template <bool A_ROW, bool B_ROW, typename BT>
__device__ __forceinline__ void product_tile(const bf16* __restrict__ a, long long lda,
                                             const BT* __restrict__ b, long long ldb, int M,
                                             int N, int K, int m0, int n0,
                                             unsigned char* smem) {
  using namespace nvcuda;
  static_assert(std::is_same<BT, bf16>::value || (std::is_same<BT, int8_t>::value && B_ROW),
                "B is bf16, or row-major int8");
  using Tl = Tile<A_ROW, B_ROW>;
  using ALayout = std::conditional_t<A_ROW, wmma::row_major, wmma::col_major>;
  using BLayout = std::conditional_t<B_ROW, wmma::row_major, wmma::col_major>;
  bf16* sm = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int nk = (K + BK - 1) / BK;
  __syncthreads();  // the previous tile's readers are done with smem

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
  // the int8 B panel, BK x BN, widened 8 values (8 bytes) at a time
  auto copy_i8 = [&](bf16* dst, const int8_t* src, int k0) {
    for (int ch = tid; ch < BK * (BN / 8); ch += kThreads) {
      const int o = ch / (BN / 8), e = (ch % (BN / 8)) * 8;
      uint4 out = make_uint4(0, 0, 0, 0);
      if (k0 + o < K && n0 + e < N) {
        const int2 raw = *reinterpret_cast<const int2*>(src + (k0 + o) * ldb + n0 + e);
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw);
        bf16* w = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = __float2bfloat16_rn(static_cast<float>(q[i]));
      }
      *reinterpret_cast<uint4*>(dst + o * Tl::kLdB + e) = out;
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
    if constexpr (std::is_same<BT, int8_t>::value) {
      copy_i8(Bs, b, k0);
    } else if (B_ROW) {
      copy(Bs, Tl::kLdB, b, ldb, BK, BN, k0, n0, K, N);
    } else {
      copy(Bs, Tl::kLdB, b, ldb, BN, BK, n0, k0, N, K);
    }
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
}

// f32: a 64 x 64 tile at (m0, n0), 16-deep panels, into acc (thread (ty,
// tx) = (tid / 16, tid % 16) owns rows m0 + ty + 16 * i, columns n0 + tx +
// 16 * j); strides in elements; BT float, or int8_t (a QuantW panel,
// widened to f32 exactly as it is staged)
constexpr int FT = 64, FK = 16;

template <typename BT = float>
__device__ __forceinline__ void product_tile_f32(const float* __restrict__ a, long long sam,
                                                 long long sak, const BT* __restrict__ b,
                                                 long long sbk, long long sbn, int M, int N,
                                                 int K, int m0, int n0, float (&acc)[4][4]) {
  __shared__ float As[FK][FT + 1];
  __shared__ float Bs[FK][FT + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += FK) {
    __syncthreads();  // the previous panel (or tile) is consumed
    for (int idx = tid; idx < FT * FK; idx += kThreads) {
      const int mm = idx % FT, kk = idx / FT;  // A: consecutive threads along M
      As[kk][mm] = m0 + mm < M && k0 + kk < K ? a[(m0 + mm) * sam + (k0 + kk) * sak] : 0.f;
      const int nn = idx % FT;                 // B: consecutive threads along N
      Bs[kk][nn] = n0 + nn < N && k0 + kk < K ? to_f<BT>(b[(k0 + kk) * sbk + (n0 + nn) * sbn])
                                              : 0.f;
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
  }
}

// The tile of C = A @ B for row-major A [M, K] (T) and B [K, N] (BT: T, or
// an int8 panel), as floats in shared memory, row r at r * LD: the
// wmma tile for bf16, the FMA tile for f32. compute begins and ends with a
// __syncthreads, so a persistent loop may read the previous tile up to the
// next call.
template <typename T, typename BT> struct RowTile {
  static constexpr int BM = tdt_gemm::BM, BN = tdt_gemm::BN, LD = LDC;
  static constexpr int kSmem = Tile<true, true>::kSmemBytes;
  __device__ static void compute(const T* a, const BT* b, int M, int N, int K, int m0, int n0,
                                 unsigned char* smem) {
    compute_ld(a, K, b, N, M, N, K, m0, n0, smem);
  }
  // the same with row strides (elements) lda of A and ldb of B, multiples of 8
  __device__ static void compute_ld(const T* a, long long lda, const BT* b, long long ldb, int M,
                                    int N, int K, int m0, int n0, unsigned char* smem) {
    product_tile<true, true, BT>(a, lda, b, ldb, M, N, K, m0, n0, smem);
  }
};

template <typename BT> struct RowTile<float, BT> {
  static constexpr int BM = FT, BN = FT, LD = FT + 1;
  static constexpr int kSmem = BM * LD * 4;
  __device__ static void compute(const float* a, const BT* b, int M, int N, int K, int m0,
                                 int n0, unsigned char* smem) {
    compute_ld(a, K, b, N, M, N, K, m0, n0, smem);
  }
  __device__ static void compute_ld(const float* a, long long lda, const BT* b, long long ldb,
                                    int M, int N, int K, int m0, int n0, unsigned char* smem) {
    float acc[4][4];
    product_tile_f32<BT>(a, lda, 1, b, ldb, 1, M, N, K, m0, n0, acc);
    float* Cs = reinterpret_cast<float*>(smem);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    __syncthreads();  // the previous tile's readers are done with Cs
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Cs[(ty + 16 * i) * LD + tx + 16 * j] = acc[i][j];
    __syncthreads();
  }
};

// Vector c / V of row r of a tile in shared memory (floats, row r at r *
// LD), each column times its scale (scale[col0 + e]; none when null),
// rounded to T: the one rounding of a tile.
template <typename T, int LD>
__device__ __forceinline__ uint4 tile_vec(const float* Cs, int r, int c, const float* scale,
                                          int col0) {
  constexpr int V = Vec16<T>::n;
  float v[V];
#pragma unroll
  for (int e = 0; e < V; ++e) v[e] = Cs[r * LD + c + e] * (scale ? scale[col0 + e] : 1.f);
  uint4 out;
  store16<T>(reinterpret_cast<T*>(&out), v);
  return out;
}

}  // namespace tdt_gemm
