// Gated DeltaNet (GDN) forward: the chunked gated delta rule.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/gdn.py `_gdn_kernel`
// (launched by `_gdn_pallas`, the pallas_call at gdn.py:222; the default
// mode of `gdn_fwd`). Per head, with state S [dk, dv] in f32:
//   S_t = exp(g_t) S_{t-1} + beta_t k_t (v_t - exp(g_t) S_{t-1}^T k_t)^T
//   o_t = S_t^T q_t
// computed a chunk of C tokens at a time in the closed form of gdn.py:1-40:
//   cum = inclusive cumsum of g over the chunk, A = exp(cum);
//   (I + L) U = diag(beta)(V - diag(A) K S), L_ij = beta_i exp(cum_i - cum_j) k_i.k_j (j < i);
//   O = diag(A) Q S + N U,                   N_ij = exp(cum_i - cum_j) q_i.k_j (j <= i);
//   S' = exp(cum_C) S + K^T diag(exp(cum_C - cum)) U.
// Contract: q, k [BH, T, dk] and v [BH, T, dv] contiguous, bf16 or f32
// alike; g, beta [BH, T] f32; s0 [BH, dk, dv] f32 or null (zeros); o
// [BH, T, dv] in q's dtype, sT [BH, dk, dv] f32. dk, dv in {64, 128}, C in
// {32, 64}; T any (the last chunk is ragged: its missing tokens load as
// zeros with g = beta = 0, which leaves the state untouched).
//
// What bounds it on an H100: the data is read once (q, k, v, g, beta) and
// o written once, about 1 KB a token and head at dk = dv = 128 in bf16,
// against about 160 kflop a token and head of products (the [C, C] K K^T
// and Q K^T, K S, Q S, N U, the state update and the C^2/2-deep solve): at
// the card's bf16 peak the bytes bound it. This design runs every product
// in f32 on the FMA units (f32 peak 67 TFLOP/s), so operations bound it
// here: about 5.5 Mflop a chunk per CTA.
//
// Design. The TPU kernel batched 16 heads per grid step for the MXU and
// VPU, carried the state in VMEM across a sequential chunk grid, inverted
// the unit-lower system by a doubling product and built the decay from a
// two-level 60-nat outer product. Here one CTA of 256 threads owns one
// head stream and one block of 64 dv columns (U, O and S' split by dv
// column, so CTAs never talk; the [C, C] matrices are recomputed by each
// of the dv/64 blocks of a head), and loops over the chunks in order with
// its slice of the state, S[:, block] (32 KB at dk 128), resident in shared
// memory: the sequential grid becomes the loop. Per chunk: stage q, k (f32,
// rows padded by 4 floats so a warp's 16-byte reads of 8 rows hit distinct
// banks) and the v block; the dot products K K^T, Q K^T, K S and Q S with
// register tiles while thread 0 sums the chunk's log decays in token
// order; the decays exp(cum_i - cum_j) only where j <= i (the exponent is
// never formed above the diagonal, where it would overflow); the
// right-hand side in place of v; a forward substitution over the C rows
// (four lanes per dv column, one warp per 8 columns, no block barrier in
// the row loop); then O and the state update. Every product is an f32 FMA
// of f32 values widened from bf16 or f32; o is rounded once to q's dtype.
// Shared memory is about 151 KB at C 64, dk 128, above the 48 KB default:
// the launcher raises the kernel's dynamic limit first.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDVB = 64;  // dv columns per CTA
constexpr int kUP = kDVB + 8;  // U row stride: the solve's 4 x 8 lanes hit 32 banks

template <int C, int DK> constexpr int smem_floats() {
  return DK * kDVB + 2 * C * (DK + 4) + C * kUP + 2 * C * (C + 4) + 3 * C;
}

template <typename T, int C, int DK>
__global__ void __launch_bounds__(kThreads)
gdn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const float* __restrict__ g, const float* __restrict__ beta,
           const float* __restrict__ s0, T* __restrict__ o, float* __restrict__ sT, int Tn,
           int DV) {
  constexpr int KP = DK + 4;          // row stride of Q and K
  constexpr int CP = C + 4;           // row stride of L and N
  constexpr int RG = kThreads / kDVB; // row groups of a [*, kDVB] output
  constexpr int CR = C / RG;          // chunk rows per thread of a [C, kDVB] output
  constexpr int SR = DK / RG;         // state rows per thread
  constexpr int MG = kThreads / C;    // row groups of a [C, C] output
  constexpr int MR = C / MG;          // rows per thread of a [C, C] output
  constexpr int VN = Vec16<T>::n;
  static_assert(CR % 4 == 0 && SR % 4 == 0 && MR >= 1, "tile shapes");

  extern __shared__ __align__(16) float smem[];
  float* S_s = smem;                  // [DK][kDVB] the state slice
  float* Q_s = S_s + DK * kDVB;       // [C][KP]
  float* K_s = Q_s + C * KP;          // [C][KP]
  float* U_s = K_s + C * KP;          // [C][kUP]: v, then the right-hand side, then U
  float* L_s = U_s + C * kUP;         // [C][CP]
  float* N_s = L_s + C * CP;          // [C][CP]
  float* cum = N_s + C * CP;          // [C] inclusive cumulative log decay
  float* bet = cum + C;               // [C]
  float* wd = bet + C;                // [C] exp(cum_C - cum_i)

  const int x = blockIdx.x;           // head stream
  const int c0 = blockIdx.y * kDVB;   // this CTA's first dv column
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long tok0 = static_cast<long long>(x) * Tn;

  for (int idx = tid; idx < DK * kDVB; idx += kThreads) {
    const int r = idx / kDVB, c = idx % kDVB;
    S_s[idx] = s0 ? s0[(static_cast<long long>(x) * DK + r) * DV + c0 + c] : 0.f;
  }

  // [*, kDVB] outputs: this thread's column and its rows
  const int col = tid % kDVB, rg = tid / kDVB;
  const int i0 = rg * CR, kk0 = rg * SR;
  // [C, C] outputs: this thread's column j and its rows
  const int mj = tid % C, mi0 = (tid / C) * MR;
  // the solve: this lane's column and its share of each row's sum
  const int sc = warp * 8 + (lane >> 2), part = lane & 3;

  for (int t0 = 0; t0 < Tn; t0 += C) {
    const int n = min(C, Tn - t0);    // tokens of this chunk
    __syncthreads();                  // the previous chunk is consumed, S_s staged
    for (int idx = tid; idx < C * (DK / VN); idx += kThreads) {
      const int i = idx / (DK / VN), c = (idx % (DK / VN)) * VN;
      float qf[VN], kf[VN];
      if (i < n) {
        load16<T>(q + (tok0 + t0 + i) * DK + c, qf);
        load16<T>(k + (tok0 + t0 + i) * DK + c, kf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) qf[e] = kf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        Q_s[i * KP + c + e] = qf[e];
        K_s[i * KP + c + e] = kf[e];
      }
    }
    for (int idx = tid; idx < C * (kDVB / VN); idx += kThreads) {
      const int i = idx / (kDVB / VN), c = (idx % (kDVB / VN)) * VN;
      float vf[VN];
      if (i < n) {
        load16<T>(v + (tok0 + t0 + i) * DV + c0 + c, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) U_s[i * kUP + c + e] = vf[e];
    }
    if (tid < C) {
      cum[tid] = tid < n ? g[tok0 + t0 + tid] : 0.f;
      bet[tid] = tid < n ? beta[tok0 + t0 + tid] : 0.f;
    }
    __syncthreads();

    if (tid == 0) {  // the inclusive cumsum, in token order
      float s = 0.f;
      for (int i = 0; i < C; ++i) {
        s += cum[i];
        cum[i] = s;
      }
    }
    // K K^T and Q K^T, rows mi0.. of column mj (a warp's rows are all above
    // its columns: nothing to compute, the entries are zero)
    float kk[MR], qk[MR];
#pragma unroll
    for (int r = 0; r < MR; ++r) kk[r] = qk[r] = 0.f;
    if (mj <= mi0 + MR - 1) {
#pragma unroll 4
      for (int c = 0; c < DK; c += 4) {
        const float4 kj = *reinterpret_cast<const float4*>(&K_s[mj * KP + c]);
#pragma unroll
        for (int r = 0; r < MR; ++r) {
          const float4 ki = *reinterpret_cast<const float4*>(&K_s[(mi0 + r) * KP + c]);
          const float4 qi = *reinterpret_cast<const float4*>(&Q_s[(mi0 + r) * KP + c]);
          kk[r] = fmaf(ki.x, kj.x, fmaf(ki.y, kj.y, fmaf(ki.z, kj.z, fmaf(ki.w, kj.w, kk[r]))));
          qk[r] = fmaf(qi.x, kj.x, fmaf(qi.y, kj.y, fmaf(qi.z, kj.z, fmaf(qi.w, kj.w, qk[r]))));
        }
      }
    }
    // K S and Q S, rows i0.. of column col
    float ks[CR], qs[CR];
#pragma unroll
    for (int r = 0; r < CR; ++r) ks[r] = qs[r] = 0.f;
#pragma unroll 2
    for (int c = 0; c < DK; c += 4) {
      const float s_0 = S_s[c * kDVB + col], s_1 = S_s[(c + 1) * kDVB + col];
      const float s_2 = S_s[(c + 2) * kDVB + col], s_3 = S_s[(c + 3) * kDVB + col];
#pragma unroll
      for (int r = 0; r < CR; ++r) {
        const float4 ki = *reinterpret_cast<const float4*>(&K_s[(i0 + r) * KP + c]);
        const float4 qi = *reinterpret_cast<const float4*>(&Q_s[(i0 + r) * KP + c]);
        ks[r] = fmaf(ki.w, s_3, fmaf(ki.z, s_2, fmaf(ki.y, s_1, fmaf(ki.x, s_0, ks[r]))));
        qs[r] = fmaf(qi.w, s_3, fmaf(qi.z, s_2, fmaf(qi.y, s_1, fmaf(qi.x, s_0, qs[r]))));
      }
    }
    __syncthreads();  // cum is summed

    // decays where j <= i only (masked before the exp), L and N
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      const int i = mi0 + r;
      const float e = mj <= i ? expf(cum[i] - cum[mj]) : 0.f;
      L_s[i * CP + mj] = mj < i ? bet[i] * (e * kk[r]) : 0.f;
      N_s[i * CP + mj] = e * qk[r];
    }
    // the right-hand side in place of v, and O's first term
#pragma unroll
    for (int r = 0; r < CR; ++r) {
      const int i = i0 + r;
      const float a = expf(cum[i]);
      U_s[i * kUP + col] = bet[i] * (U_s[i * kUP + col] - a * ks[r]);
      qs[r] = a * qs[r];
    }
    if (tid < C) wd[tid] = expf(cum[C - 1] - cum[tid]);
    __syncthreads();

    // forward substitution (I + L) U = rhs, U in place: lanes 4c..4c+3 of a
    // warp own column sc, each summing every fourth j
    for (int i = 1; i < C; ++i) {
      float s = 0.f;
      for (int j = part; j < i; j += 4) s = fmaf(L_s[i * CP + j], U_s[j * kUP + sc], s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (part == 0) U_s[i * kUP + sc] -= s;
      __syncwarp();
    }
    __syncthreads();

    // O = A Q S + N U (N is zero past the diagonal), rounded once
    for (int j = 0; j < i0 + CR; j += 4) {
      const float u0 = U_s[j * kUP + col], u1 = U_s[(j + 1) * kUP + col];
      const float u2 = U_s[(j + 2) * kUP + col], u3 = U_s[(j + 3) * kUP + col];
#pragma unroll
      for (int r = 0; r < CR; ++r) {
        const float4 nv = *reinterpret_cast<const float4*>(&N_s[(i0 + r) * CP + j]);
        qs[r] = fmaf(nv.w, u3, fmaf(nv.z, u2, fmaf(nv.y, u1, fmaf(nv.x, u0, qs[r]))));
      }
    }
#pragma unroll
    for (int r = 0; r < CR; ++r)
      if (i0 + r < n) o[(tok0 + t0 + i0 + r) * DV + c0 + col] = from_f<T>(qs[r]);

    // S' = exp(cum_C) S + K^T (wd * U), rows kk0.. of column col (owned by
    // this thread alone)
    float sa[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) sa[r] = 0.f;
    for (int i = 0; i < C; ++i) {
      const float u = wd[i] * U_s[i * kUP + col];
#pragma unroll
      for (int r = 0; r < SR; r += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&K_s[i * KP + kk0 + r]);
        sa[r] = fmaf(kv.x, u, sa[r]);
        sa[r + 1] = fmaf(kv.y, u, sa[r + 1]);
        sa[r + 2] = fmaf(kv.z, u, sa[r + 2]);
        sa[r + 3] = fmaf(kv.w, u, sa[r + 3]);
      }
    }
    const float a_last = expf(cum[C - 1]);
#pragma unroll
    for (int r = 0; r < SR; ++r)
      S_s[(kk0 + r) * kDVB + col] = fmaf(a_last, S_s[(kk0 + r) * kDVB + col], sa[r]);
  }
  __syncthreads();
  for (int idx = tid; idx < DK * kDVB; idx += kThreads) {
    const int r = idx / kDVB, c = idx % kDVB;
    sT[(static_cast<long long>(x) * DK + r) * DV + c0 + c] = S_s[idx];
  }
}

template <typename T, int C, int DK>
cudaError_t launch(const void* q, const void* k, const void* v, const float* g,
                   const float* beta, const float* s0, void* o, float* sT, int BH, int Tn,
                   int DV, cudaStream_t stream) {
  constexpr int bytes = smem_floats<C, DK>() * static_cast<int>(sizeof(float));
  auto kernel = gdn_kernel<T, C, DK>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(BH, DV / kDVB), kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), g, beta,
      s0, static_cast<T*>(o), sT, Tn, DV);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_shape(int C, int DK, const void* q, const void* k, const void* v,
                         const float* g, const float* beta, const float* s0, void* o,
                         float* sT, int BH, int Tn, int DV, cudaStream_t stream) {
  if (C == 64 && DK == 128) return launch<T, 64, 128>(q, k, v, g, beta, s0, o, sT, BH, Tn, DV, stream);
  if (C == 64 && DK == 64) return launch<T, 64, 64>(q, k, v, g, beta, s0, o, sT, BH, Tn, DV, stream);
  if (C == 32 && DK == 128) return launch<T, 32, 128>(q, k, v, g, beta, s0, o, sT, BH, Tn, DV, stream);
  if (C == 32 && DK == 64) return launch<T, 32, 64>(q, k, v, g, beta, s0, o, sT, BH, Tn, DV, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t tdt::gdn_fwd(int dtype, const void* q, const void* k, const void* v,
                         const float* g, const float* beta, const float* s0, void* o,
                         float* sT, int BH, int T, int DK, int DV, int C,
                         cudaStream_t stream) {
  if (DV != 64 && DV != 128) return cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_shape<float>(C, DK, q, k, v, g, beta, s0, o, sT, BH, T, DV, stream);
  if (dtype == kBF16)
    return launch_shape<__nv_bfloat16>(C, DK, q, k, v, g, beta, s0, o, sT, BH, T, DV, stream);
  return cudaErrorInvalidValue;
}
