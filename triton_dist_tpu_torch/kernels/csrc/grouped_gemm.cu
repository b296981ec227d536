// Grouped GEMM of the MoE expert MLPs: out[e] = x[e] @ w[e].
//
// Replaces the TPU kernel triton_dist_tpu/kernels/group_gemm.py
// `_gg_kernel` (the pallas_call at group_gemm.py:74): x [E, C, D] @ w
// [E, D, F] -> [E, C, F], bf16 operands, f32 accumulation, one rounding
// to bf16 on store. The C rows of an expert are its capacity slots: rows
// that hold no token (zeros) are computed like any other and the caller
// masks them, as on the TPU.
//
// What bounds it on an H100: at decode capacities (C = 16-24) bytes, as
// every expert's weights are read once per call (2 * E * D * F bytes
// against 2 * E * C * D * F flops); at prefill capacities (C ~ 2000)
// operations.
//
// Design. One CTA per (F tile, C tile, expert); blockIdx.x is the F tile,
// so the CTAs that share an x tile run side by side. 256 threads in 8
// warps, 2 (rows) x 4 (columns). BK = 32-deep panels of x and w stream
// through a 4-stage cp.async ring in shared memory; each warp multiplies
// bf16 wmma 16x16x16 fragments into f32 accumulators over a (BM/2) x 32
// piece of the BM x 128 output tile. BM is 32, 64 or 128, the smallest
// that covers C up to 128, so a decode call computes few padding rows.
// Rows past C load as zeros and are not stored; columns past F likewise.
// The epilogue stages the f32 tile in shared memory (the ring, reused),
// rounds it once to bf16 and writes 16-byte vectors.
//
// w may be a strided view, and its columns may come from two blocks of
// equal strides: tensor-parallel rank r's panels are views of the one-rank
// model's ([gate_r | up_r] two column blocks of [gate | up] at row stride
// 2I, w_down's rows at expert stride I * D), so a rank multiplies them
// where they lie (grouped_gemm_strided_kernel); a contiguous panel keeps
// grouped_gemm_kernel as it was.
#include <mma.h>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int BN = 128, BK = 32, kStages = 4;
constexpr int LDA = BK + 8;  // shared row strides in elements: 16-byte rows, spread banks
constexpr int LDW = BN + 8;
constexpr int LDC = BN + 4;

template <int BM> struct Tile {
  static constexpr int kFM = BM / 32;  // 16-row fragments per warp (two warp rows)
  static constexpr int kStageElems = BM * LDA + BK * LDW;
  static constexpr int kRingBytes = kStages * kStageElems * 2;
  static constexpr int kCBytes = BM * LDC * 4;
  static constexpr int kSmemBytes = kRingBytes > kCBytes ? kRingBytes : kCBytes;
};

// x rows of expert e start at x + e * x_es (row stride D); w and out are
// contiguous [E, D, F] and [E, C, F]. D is a multiple of BK, F of 8.
template <int BM>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_kernel(const bf16* __restrict__ x, long long x_es,
                        const bf16* __restrict__ w, bf16* __restrict__ out, int C, int D,
                        int F) {
  using namespace nvcuda;
  using T = Tile<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const bf16* xe = x + e * x_es;
  const bf16* we = w + static_cast<long long>(e) * D * F;
  bf16* oe = out + static_cast<long long>(e) * C * F;
  const int nk = D / BK;

  auto load = [&](int kt, int s) {
    bf16* As = sm + s * T::kStageElems;
    bf16* Ws = As + BM * LDA;
    const int k0 = kt * BK;
    for (int ch = tid; ch < BM * (BK / 8); ch += kThreads) {
      const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
      const bool ok = m0 + r < C;
      cp_async16(As + r * LDA + c, ok ? xe + static_cast<long long>(m0 + r) * D + k0 + c : xe,
                 ok ? 16 : 0);
    }
    for (int ch = tid; ch < BK * (BN / 8); ch += kThreads) {
      const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
      const bool ok = n0 + c < F;
      cp_async16(Ws + r * LDW + c, ok ? we + static_cast<long long>(k0 + r) * F + n0 + c : we,
                 ok ? 16 : 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFM][2];
#pragma unroll
  for (int i = 0; i < T::kFM; ++i) {
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
    const bf16* As = sm + (kt % kStages) * T::kStageElems;
    const bf16* Ws = As + BM * LDA;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
      wmma::load_matrix_sync(b[0], Ws + ks * LDW + wn * 32, LDW);
      wmma::load_matrix_sync(b[1], Ws + ks * LDW + wn * 32 + 16, LDW);
#pragma unroll
      for (int i = 0; i < T::kFM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, As + (wm * (BM / 2) + i * 16) * LDA + ks, LDA);
        wmma::mma_sync(acc[i][0], a, b[0], acc[i][0]);
        wmma::mma_sync(acc[i][1], a, b[1], acc[i][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the C tile
#pragma unroll
  for (int i = 0; i < T::kFM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * (BM / 2) + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int ch = tid; ch < BM * (BN / 8); ch += kThreads) {
    const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
    if (m0 + r >= C || n0 + c >= F) continue;
    store16<bf16>(oe + static_cast<long long>(m0 + r) * F + n0 + c, Cs + r * LDC + c);
  }
}

// x rows of expert e start at x + e * x_es (row stride D); out is
// contiguous [E, C, F]. w: expert e's panel at w + e * w_es, rows at stride
// w_ld; its columns [0, split) there and, when w1 is not null, columns
// [split, F) from w1 (a second column block with w's strides: a rank's
// [gate_r | up_r] as two views of the one-rank [gate | up] panel). D is a
// multiple of BK; F, split and the strides of 8. A contiguous panel takes
// the kernel above: served by this one, the contiguous prefill rows ran 3%
// slower on the H100 (rows 7c-7d, the two timed in one call).
template <int BM>
__global__ void __launch_bounds__(kThreads)
    grouped_gemm_strided_kernel(const bf16* __restrict__ x, long long x_es,
                                const bf16* __restrict__ w, const bf16* __restrict__ w1,
                                long long w_es, long long w_ld, int split,
                                bf16* __restrict__ out, int C, int D, int F) {
  using namespace nvcuda;
  using T = Tile<BM>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, e = blockIdx.z;
  const bf16* xe = x + e * x_es;
  const bf16* we = w + e * w_es;
  const bf16* we1 = w1 ? w1 + e * w_es - split : we;  // column c >= split at we1 + c
  bf16* oe = out + static_cast<long long>(e) * C * F;
  const int nk = D / BK;

  auto load = [&](int kt, int s) {
    bf16* As = sm + s * T::kStageElems;
    bf16* Ws = As + BM * LDA;
    const int k0 = kt * BK;
    for (int ch = tid; ch < BM * (BK / 8); ch += kThreads) {
      const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
      const bool ok = m0 + r < C;
      cp_async16(As + r * LDA + c, ok ? xe + static_cast<long long>(m0 + r) * D + k0 + c : xe,
                 ok ? 16 : 0);
    }
    for (int ch = tid; ch < BK * (BN / 8); ch += kThreads) {
      const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
      const bool ok = n0 + c < F;
      const bf16* src = (n0 + c >= split ? we1 : we) + (k0 + r) * w_ld + n0 + c;
      cp_async16(Ws + r * LDW + c, ok ? src : we, ok ? 16 : 0);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFM][2];
#pragma unroll
  for (int i = 0; i < T::kFM; ++i) {
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
    const bf16* As = sm + (kt % kStages) * T::kStageElems;
    const bf16* Ws = As + BM * LDA;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
      wmma::load_matrix_sync(b[0], Ws + ks * LDW + wn * 32, LDW);
      wmma::load_matrix_sync(b[1], Ws + ks * LDW + wn * 32 + 16, LDW);
#pragma unroll
      for (int i = 0; i < T::kFM; ++i) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, As + (wm * (BM / 2) + i * 16) * LDA + ks, LDA);
        wmma::mma_sync(acc[i][0], a, b[0], acc[i][0]);
        wmma::mma_sync(acc[i][1], a, b[1], acc[i][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the C tile
#pragma unroll
  for (int i = 0; i < T::kFM; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * (BM / 2) + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int ch = tid; ch < BM * (BN / 8); ch += kThreads) {
    const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
    if (m0 + r >= C || n0 + c >= F) continue;
    store16<bf16>(oe + static_cast<long long>(m0 + r) * F + n0 + c, Cs + r * LDC + c);
  }
}

template <int BM>
cudaError_t launch(const void* x, long long x_es, const void* w, const void* w1, long long w_es,
                   long long w_ld, int split, void* out, int E, int C, int D, int F,
                   cudaStream_t stream) {
  constexpr int bytes = Tile<BM>::kSmemBytes;
  const bool strided = w1 || w_es != static_cast<long long>(D) * F || w_ld != F;
  const void* fn = strided ? reinterpret_cast<const void*>(grouped_gemm_strided_kernel<BM>)
                           : reinterpret_cast<const void*>(grouped_gemm_kernel<BM>);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((F + BN - 1) / BN, (C + BM - 1) / BM, E);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  if (strided)
    grouped_gemm_strided_kernel<BM><<<grid, kThreads, bytes, stream>>>(
        xb, x_es, wb, static_cast<const bf16*>(w1), w_es, w_ld, split, ob, C, D, F);
  else
    grouped_gemm_kernel<BM><<<grid, kThreads, bytes, stream>>>(xb, x_es, wb, ob, C, D, F);
  return cudaGetLastError();
}

}  // namespace

cudaError_t tdt::grouped_gemm(const void* x, long long x_es, const void* w, const void* w1,
                              long long w_es, long long w_ld, int split, void* out, int E,
                              int C, int D, int F, cudaStream_t stream) {
  if (D % BK || F % 8 || split % 8 || split < 0 || split > F || w_ld % 8 || w_es % 8 ||
      (!w1 && split != F))
    return cudaErrorInvalidValue;
  if (E == 0 || C == 0 || F == 0) return cudaSuccess;
  if (C <= 32) return launch<32>(x, x_es, w, w1, w_es, w_ld, split, out, E, C, D, F, stream);
  if (C <= 64) return launch<64>(x, x_es, w, w1, w_es, w_ld, split, out, E, C, D, F, stream);
  return launch<128>(x, x_es, w, w1, w_es, w_ld, split, out, E, C, D, F, stream);
}
