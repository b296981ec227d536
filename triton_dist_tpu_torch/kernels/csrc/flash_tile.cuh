// The cached-attention tile loop shared by flash_decode.cu (contiguous
// cache) and flash_decode_paged.cu (page pool behind a page table). The
// two differ only in how key t of a (batch, kv-head) stream is found and
// how long the stream is; an addressing policy (ContigKV, PagedKV) passed
// by value to the kernel supplies both, and each .cu keeps its own
// launcher (and each Python wrapper its own launch count).
//
// Design: one CTA per (batch * kv-head stream, block of R query rows).
// The rep = Hq / Hkv query heads of a group are consecutive rows of the
// stream ([B, S, Hkv, rep, d] folded to [B*Hkv, S*rep, d]: row r is query
// position r / rep), so every K/V tile staged in shared memory serves all
// of them and K/V is read once per stream, not once per query head. A loop
// inside the CTA walks 32-key tiles up to the block's causal frontier
// (never past the stream's length, never the cache tail) with an f32
// online softmax (m, l, acc) in registers. Lane j of a warp owns key j of
// the tile for QK^T, each warp owns RPW query rows, and P is broadcast by
// shuffles for the PV product, whose output dims c = lane + 32 * i sit in
// the lane's registers. The arithmetic follows the TPU kernels: running
// max starts at -1e30, scale multiplies the f32 logits after the dot, the
// int8 K scale multiplies the logits and the V scale multiplies P, P is
// rounded to the query dtype before the PV product, and the output is
// acc / max(l, 1e-30) in f32. Plain FMA, no tensor cores.
//
// The window form (q_lens, per batch row, device int32 [B] beside the
// per-row lengths: speculative verify and chunked prefill) puts row b's
// first q_lens[b] query positions at kv_len - q_lens[b] .. kv_len - 1,
// causal within the window: position s attends keys
// t <= kv_len - q_len + min(s, q_len - 1). Padding positions (s >= q_len)
// repeat the last valid one; q_len == 0 attends keys < kv_len (its output
// is discarded by the caller and stays finite). Without q_lens every row
// has q_len = S, the plain causal frontier kv_len - S + s.
//
// The partial forms store the unnormalised f32 acc and the running (m, l)
// of each row in the folded layout [B*Hkv, S*rep], as the TPU kernels'
// partial=True outputs; rows that see no key keep m = -1e30, l = 0 and
// acc = 0, the neutral element of the LSE combine. kPartialOff
// (flash_decode.cu's flash_decode_partial, the training forward) takes
// the causal frontier q_off from the caller instead of kv_len - S.
// kPartialOwned (flash_decode_paged.cu's flash_decode_paged_partial, the
// sequence-parallel split-KV walk over one rank's pool shard) keeps each
// stream's own frontier (kv_lens, q_lens) and reads an ownership row per
// stream (PagedKV::owned): a key on a page the rank does not own is never
// loaded and contributes nothing, and a 32-key tile with no owned key is
// skipped, so the accumulators stay bitwise as they were. Ownership is
// per key, not per tile: a tile spans two 16-row serving pages, which
// two ranks may own.
#pragma once

#include "common.cuh"

namespace tdt_flash {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBT = 32;  // keys per tile == warp width: lane j owns key j

// Contiguous cache k/v [B, Hkv, T, d] (row strides in elements), int8
// scales [B, Hkv, T]. lens: per-batch-row lengths [B] on the device, or
// null for the one scalar kv_len of every row; qlens: per-batch-row query
// windows [B] on the device (with lens), or null.
template <typename KT> struct ContigKV {
  const KT* k;
  const KT* v;
  const float* ks;
  const float* vs;
  const int* lens;
  const int* qlens;
  int kv_len, T;
  long long kv_sb, kv_sh, kv_st, sc_sb, sc_sh;

  __device__ int len(int b) const { return lens ? lens[b] : kv_len; }
  __device__ int cap() const { return T; }
  // element offset of key t of stream (b, g) in k/v, and in ks/vs
  __device__ long long row(int b, int g, int t) const {
    return b * kv_sb + g * kv_sh + t * kv_st;
  }
  __device__ long long srow(int b, int g, int t) const {
    return b * sc_sb + g * sc_sh + t;
  }
};

// Page pool: payload pages of `page` rows (page stride pg_st, row stride
// row_st, in elements), int8 scale pages (page stride spg_st), one
// int32 table [B*Hkv, maxp] mapping logical tile t/page of stream
// b*Hkv+g to its physical page, per-batch-row lengths lens [B] and query
// windows qlens [B] (or null), and for kPartialOwned an ownership row per
// stream, owned [B*Hkv, maxp] int32 (non-zero: this rank holds the page of
// logical tile t/page; null otherwise). Only tiles below the stream's
// length are ever looked up, and of a partial walk only owned ones are
// read.
template <typename KT> struct PagedKV {
  const KT* k;
  const KT* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lens;
  const int* qlens;
  const int* owned;
  int Hkv, maxp, page;
  long long pg_st, row_st, spg_st;

  __device__ int len(int b) const { return lens[b]; }
  __device__ int cap() const { return maxp * page; }
  __device__ int page_of(int b, int g, int t) const {
    return table[static_cast<long long>(b * Hkv + g) * maxp + t / page];
  }
  __device__ long long row(int b, int g, int t) const {
    return page_of(b, g, t) * pg_st + (t % page) * row_st;
  }
  __device__ long long srow(int b, int g, int t) const {
    return page_of(b, g, t) * spg_st + t % page;
  }
  __device__ bool owns(int b, int g, int t) const {
    return owned[static_cast<long long>(b * Hkv + g) * maxp + t / page] != 0;
  }
};

// What the tile loop stores, and where each query row's frontier comes
// from (see the header comment).
enum Form { kOut, kPartialOff, kPartialOwned };

// Outputs of the partial forms: acc [X, rows, HD], m and l [X, rows] f32
// (X = B * Hkv streams; row r of stream x at x * rows + r); q_off (read by
// kPartialOff only) is the position of query row 0 relative to key 0 (may
// be negative or past T).
struct Partial {
  float* acc;
  float* m;
  float* l;
  int q_off;
};

template <typename QT, typename KT, bool QUANT, Form F, int HD, int RPW, typename KV>
__global__ void __launch_bounds__(kThreads)
flash_tile_kernel(const QT* __restrict__ q, QT* __restrict__ o, const KV A, int S,
                  int Hq, int Hkv, float scale, long long q_sb, long long q_ss,
                  long long q_sh, const Partial P) {
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

  const int kv_len = A.len(b);
  // query position s attends keys <= q_off + min(s, s_max): the window's
  // frontier (s_max = q_len - 1 clamps the padding positions), the plain
  // causal one (q_len = S), or kPartialOff's q_off
  const int q_len = A.qlens ? A.qlens[b] : S;
  const int q_off = F == kPartialOff ? P.q_off : kv_len - q_len;
  // key t is read and used: always, or if this rank owns its page
  auto use = [&](int t) {
    if constexpr (F == kPartialOwned)
      return A.owns(b, g, t);
    else
      return true;
  };
  const int s_max = q_len - 1;
  const int kv_end = min(kv_len, A.cap());
  // the block's last row has its furthest frontier
  const int walk_end =
      min(kv_end, q_off + min((min(r0 + R, rows) - 1) / rep, s_max) + 1);

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
  const int w_front = w_last >= wr0 ? q_off + min(w_last / rep, s_max) : -1;

  float m[RPW], l[RPW], acc[RPW][DPL];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = -1e30f;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  }

  for (int t0 = 0; t0 < walk_end; t0 += kBT) {
    // the previous tile is consumed (and q_s is staged); a partial walk
    // skips a tile with no owned key, block-uniformly
    if constexpr (F == kPartialOwned) {
      if (!__syncthreads_or(tid < kBT && t0 + tid < walk_end && use(t0 + tid))) continue;
    } else {
      __syncthreads();
    }
    for (int idx = tid; idx < kBT * (HD / VN); idx += kThreads) {
      const int j = idx / (HD / VN), c0 = (idx % (HD / VN)) * VN;
      float kf[VN], vf[VN];
      if (t0 + j < walk_end && use(t0 + j)) {
        const long long off = A.row(b, g, t0 + j);
        load16<KT>(A.k + off + c0, kf);
        load16<KT>(A.v + off + c0, vf);
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
    const bool own_j = j < walk_end && use(j);
    float ksj = 1.f, vsj = 1.f;
    if (QUANT && own_j) {
      const long long so = A.srow(b, g, j);
      ksj = A.ks[so];
      vsj = A.vs[so];
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
      const bool valid = own_j && r < rows && j <= q_off + min(r / rep, s_max) && j < kv_end;
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
    if (F != kOut) {
      const long long xr = static_cast<long long>(x) * rows + r;
#pragma unroll
      for (int e = 0; e < DPL; ++e) P.acc[xr * HD + lane + 32 * e] = acc[i][e];
      if (lane == 0) {
        P.m[xr] = m[i];
        P.l[xr] = l[i];
      }
      continue;
    }
    const int s = r / rep, h = g * rep + r % rep;
    const float inv_l = 1.f / fmaxf(l[i], 1e-30f);
    QT* orow = o + ((static_cast<long long>(b) * S + s) * Hq + h) * HD;
#pragma unroll
    for (int e = 0; e < DPL; ++e) orow[lane + 32 * e] = from_f<QT>(acc[i][e] * inv_l);
  }
}

// Launch the tile kernel for head dim HD over B*Hkv streams of S query
// positions; q strides (elements) q_sb, q_ss, q_sh; output [B, S, Hq, HD]
// contiguous. Returns cudaGetLastError() after the launch.
template <typename QT, typename KT, bool QUANT, Form F, int HD, typename KV>
cudaError_t launch_hd(const void* q, void* o, const KV& A, int B, int S, int Hq, int Hkv,
                      float scale, long long q_sb, long long q_ss, long long q_sh,
                      cudaStream_t stream, const Partial& P) {
  const int rows = S * (Hq / Hkv);
  // prefill-sized streams take 4 rows per warp (16 per CTA); decode 1 per warp
  const bool wide = rows >= 16;
  const int R = kWarps * (wide ? 4 : 1);
  const dim3 grid(B * Hkv, (rows + R - 1) / R);
  auto run = [&](auto kernel) {
    kernel<<<grid, kThreads, 0, stream>>>(static_cast<const QT*>(q), static_cast<QT*>(o),
                                          A, S, Hq, Hkv, scale, q_sb, q_ss, q_sh, P);
  };
  if (wide)
    run(flash_tile_kernel<QT, KT, QUANT, F, HD, 4, KV>);
  else
    run(flash_tile_kernel<QT, KT, QUANT, F, HD, 1, KV>);
  return cudaGetLastError();
}

// A partial form: o is unused and P receives the partial outputs.
template <typename QT, typename KT, bool QUANT, Form F = kOut, typename KV>
cudaError_t launch(int HD, const void* q, void* o, const KV& A, int B, int S, int Hq,
                   int Hkv, float scale, long long q_sb, long long q_ss, long long q_sh,
                   cudaStream_t stream, const Partial& P = Partial{}) {
  if (HD == 128)
    return launch_hd<QT, KT, QUANT, F, 128>(q, o, A, B, S, Hq, Hkv, scale, q_sb, q_ss,
                                                  q_sh, stream, P);
  if (HD == 64)
    return launch_hd<QT, KT, QUANT, F, 64>(q, o, A, B, S, Hq, Hkv, scale, q_sb, q_ss,
                                                 q_sh, stream, P);
  return cudaErrorInvalidValue;
}

}  // namespace tdt_flash
