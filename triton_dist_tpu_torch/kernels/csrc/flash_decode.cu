// Cached GQA attention for prefill-into-cache and decode.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/flash_attn.py
// `_flash_decode_kernel` (launched by `_flash_call`, the pallas_call at
// flash_attn.py:406) in its plain and int8-KV forms. Same contract:
//   q [B, S, Hq, d] (row strides given), k/v [B, Hkv, T, d] (row strides
//   given, d contiguous), optional int8 k/v with per-position f32 scales
//   ks/vs [B, Hkv, T]; query s sits at position kv_len - S + s and attends
//   keys col <= kv_len - S + s with col < min(kv_len, T). Output
//   [B, S, Hq, d] contiguous, in q's dtype.
//
// What bounds it on an H100: decode (S = 1) reads every valid K/V row of
// the cache once and does ~4 flops per byte, so HBM bytes bound it.
// Prefill (S = 128) is bounded by bytes as well at these shapes (q, K, V
// and the output are each touched once; the causal work is ~8 GFLOP).
//
// Design: one CTA per (batch * kv-head stream, block of R query rows).
// The rep = Hq / Hkv query heads of a group are consecutive rows of the
// stream ([B, S, Hkv, rep, d] folded to [B*Hkv, S*rep, d]: row r is query
// position r / rep), so every K/V tile staged in shared memory serves all
// of them and K/V is read once per stream, not once per query head. A loop
// inside the CTA walks 32-key tiles up to the block's causal frontier
// (never past kv_len, never the cache tail) with an f32 online softmax
// (m, l, acc) in registers. Lane j of a warp owns key j of the tile for
// QK^T, each warp owns RPW query rows, and P is broadcast by shuffles for
// the PV product, whose output dims c = lane + 32 * i sit in the lane's
// registers. The arithmetic follows the TPU kernel: running max starts at
// -1e30, scale multiplies the f32 logits after the dot, the int8 K scale
// multiplies the logits and the V scale multiplies P, P is rounded to the
// query dtype before the PV product, and the output is acc / l in f32.
// Plain FMA, no tensor cores: a first, correct kernel.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBT = 32;  // keys per tile == warp width: lane j owns key j

template <typename QT, typename KT, bool QUANT, int HD, int RPW>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                    const KT* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, QT* __restrict__ o,
                    int kv_len, int S, int Hq, int Hkv,
                    int T, float scale, long long q_sb, long long q_ss,
                    long long q_sh, long long kv_sb, long long kv_sh,
                    long long kv_st, long long sc_sb, long long sc_sh) {
  constexpr int R = kWarps * RPW;  // query rows per CTA
  constexpr int DPL = HD / 32;     // output dims per lane
  constexpr int VN = Vec16<KT>::n;
  __shared__ __align__(16) float q_s[R][HD];
  __shared__ float k_s[kBT][HD + 1];  // +1: lane j reads row j without bank conflicts
  __shared__ float v_s[kBT][HD];

  const int x = blockIdx.x;  // stream = b * Hkv + g
  const int b = x / Hkv, g = x % Hkv;
  const int rep = Hq / Hkv;
  const int rows = S * rep;
  const int r0 = blockIdx.y * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int q_off = kv_len - S;  // position of query row 0
  const int kv_end = min(kv_len, T);
  const int walk_end = min(kv_end, q_off + (min(r0 + R, rows) - 1) / rep + 1);

  for (int idx = tid; idx < R * HD; idx += kThreads) {
    const int rr = idx / HD, c = idx % HD, r = r0 + rr;
    float val = 0.f;
    if (r < rows) {
      const int s = r / rep, h = g * rep + r % rep;
      val = to_f<QT>(q[b * q_sb + s * q_ss + h * q_sh + c]);
    }
    q_s[rr][c] = val;
  }

  // this warp's rows: r0 + warp * RPW + i; the last one has the furthest frontier
  const int wr0 = r0 + warp * RPW;
  const int w_last = min(wr0 + RPW, rows) - 1;
  const int w_front = w_last >= wr0 ? q_off + w_last / rep : -1;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  const KT* kx = k + b * kv_sb + g * kv_sh;
  const KT* vx = v + b * kv_sb + g * kv_sh;
  const float* ksx = QUANT ? ks + b * sc_sb + g * sc_sh : nullptr;
  const float* vsx = QUANT ? vs + b * sc_sb + g * sc_sh : nullptr;

  for (int t0 = 0; t0 < walk_end; t0 += kBT) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    for (int idx = tid; idx < kBT * (HD / VN); idx += kThreads) {
      const int j = idx / (HD / VN), c0 = (idx % (HD / VN)) * VN;
      float kf[VN], vf[VN];
      if (t0 + j < walk_end) {
        load16<KT>(kx + (t0 + j) * kv_st + c0, kf);
        load16<KT>(vx + (t0 + j) * kv_st + c0, vf);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        k_s[j][c0 + e] = kf[e];
        v_s[j][c0 + e] = vf[e];
      }
    }
    __syncthreads();
    // warp-uniform: every row of this warp lies before this tile, so the
    // update would be a no-op (alpha == 1, p == 0), as in the TPU kernel
    if (t0 > w_front) continue;

    const int j = t0 + lane;  // this lane's key
    float ksj = 1.f, vsj = 1.f;
    if (QUANT && j < walk_end) {
      ksj = ksx[j];
      vsj = vsx[j];
    }
    float dot[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) dot[i] = 0.f;
#pragma unroll 8
    for (int c = 0; c < HD; c += 4) {
      const float k0 = k_s[lane][c], k1 = k_s[lane][c + 1];
      const float k2 = k_s[lane][c + 2], k3 = k_s[lane][c + 3];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(&q_s[warp * RPW + i][c]);
        dot[i] = fmaf(qv.x, k0, dot[i]);
        dot[i] = fmaf(qv.y, k1, dot[i]);
        dot[i] = fmaf(qv.z, k2, dot[i]);
        dot[i] = fmaf(qv.w, k3, dot[i]);
      }
    }
    float p[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = wr0 + i;
      const bool valid = r < rows && j <= q_off + r / rep && j < kv_end;
      float s = dot[i] * scale;
      if (QUANT) s *= ksj;
      const float m_new = fmaxf(m[i], warp_max(valid ? s : -1e30f));
      const float alpha = expf(m[i] - m_new);
      float pi = valid ? expf(s - m_new) : 0.f;
      l[i] = l[i] * alpha + warp_sum(pi);
      if (QUANT) pi *= vsj;
      p[i] = round_to<QT>(pi);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
    }
#pragma unroll 4
    for (int jj = 0; jj < kBT; ++jj) {
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = v_s[jj][lane + 32 * e];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pj = __shfl_sync(0xffffffffu, p[i], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pj, vv[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = wr0 + i;
    if (r >= rows) break;
    const int s = r / rep, h = g * rep + r % rep;
    QT* orow = o + ((static_cast<long long>(b) * S + s) * Hq + h) * HD;
#pragma unroll
    for (int e = 0; e < DPL; ++e) orow[lane + 32 * e] = from_f<QT>(acc[i][e] / l[i]);
  }
}

template <typename QT, typename KT, bool QUANT, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, void* o, int kv_len, int B, int S,
                      int Hq, int Hkv, int T, float scale, const long long* st,
                      cudaStream_t stream) {
  const int rows = S * (Hq / Hkv);
  // prefill-sized streams take 4 rows per warp (16 per CTA); decode 1 per warp
  const bool wide = rows >= 16;
  const int R = kWarps * (wide ? 4 : 1);
  const dim3 grid(B * Hkv, (rows + R - 1) / R);
  auto args = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
        static_cast<const float*>(ks), static_cast<const float*>(vs), static_cast<QT*>(o),
        kv_len, S, Hq, Hkv, T, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7]);
  };
  if (wide)
    args(flash_decode_kernel<QT, KT, QUANT, HD, 4>);
  else
    args(flash_decode_kernel<QT, KT, QUANT, HD, 1>);
  return cudaGetLastError();
}

template <typename QT, typename KT, bool QUANT>
cudaError_t launch(int HD, const void* q, const void* k, const void* v, const void* ks,
                   const void* vs, void* o, int kv_len, int B, int S, int Hq,
                   int Hkv, int T, float scale, const long long* st,
                   cudaStream_t stream) {
  if (HD == 128)
    return launch_hd<QT, KT, QUANT, 128>(q, k, v, ks, vs, o, kv_len, B, S, Hq, Hkv, T,
                                         scale, st, stream);
  if (HD == 64)
    return launch_hd<QT, KT, QUANT, 64>(q, k, v, ks, vs, o, kv_len, B, S, Hq, Hkv, T,
                                        scale, st, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t tdt::flash_decode(int q_dtype, int kv_dtype, const void* q, const void* k,
                              const void* v, const void* ks, const void* vs, void* o,
                              int kv_len, int B, int S, int Hq, int Hkv, int T, int HD,
                              float scale, const long long* st, cudaStream_t stream) {
  if (q_dtype == kF32 && kv_dtype == kF32)
    return launch<float, float, false>(HD, q, k, v, ks, vs, o, kv_len, B, S, Hq, Hkv, T,
                                       scale, st, stream);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(HD, q, k, v, ks, vs, o, kv_len, B,
                                                       S, Hq, Hkv, T, scale, st, stream);
  if (q_dtype == kBF16 && kv_dtype == kI8)
    return launch<__nv_bfloat16, int8_t, true>(HD, q, k, v, ks, vs, o, kv_len, B, S, Hq,
                                               Hkv, T, scale, st, stream);
  return cudaErrorInvalidValue;
}
