// One whole Qwen3 decode layer in ONE persistent cooperative launch,
// shared by mega_decode.cu (contiguous cache) and mega_paged_decode.cu
// (page pool behind a page table). The two differ only in where key t of
// a (batch row, kv head) stream lives and where row b's position comes
// from; a cache policy (ContigCache, PagedCache) supplies both.
//
// The layer runs as barrier-separated phases, in the order the host
// passes (the order MegaKernelBuilder validated, mega/decode_layer.py):
//   ln1      xn = bf16(rms(x) * w_ln1)                      [B, D]
//   qkv_mm   qkv = xn @ w_qkv (f32 accumulation)           [B, (Hq+2Hkv)hd]
//   attend   per (b, g) stream: QK-norm + RoPE of its rep query heads and
//            its K head, append of the new K/V row at pos, then attention
//            over the pos + 1 keys; attn = bf16(out)      [B, Hq*hd]
//   o_proj   ores = attn @ w_o + x                         [B, D] f32
//   ln2      on = bf16(rms(ores) * w_ln2)
//   gate_up  h = bf16(g * sigmoid(g) * u), [g | u] = on @ w_gu
//   down     y = h @ w_d + ores                            [B, D] f32
// Activations pass through a per-layer-object scratch in device memory
// (about 6 MB at B = 128, so it stays in the 50 MB L2); a phase starts
// only when every CTA has finished the previous one (grid_barrier).
//
// The tensor-parallel form (mega_decode.cu, mega_tp_kernel) replaces
// the TPU kernel's tp > 1 body (triton_dist_tpu/mega/decode_layer.py
// `ar_section`, :191-216, and the partial projections, :350-364,
// :407-418). Each rank runs the layer on its shards (Hq/n, Hkv/n, F/n);
// o_proj and down_proj write the bare partial to the rank's `part`
// scratch, and two all-reduce phases follow them:
//   o_allreduce  ores = x    + sum over ranks r (in rank order) of partial_r
//   d_allreduce  y    = ores + sum over ranks r of partial_r
// A section is gemm_allreduce.cu's one-shot protocol over shmem.cuh: CTA
// g of every rank owns the same slice of the [B, D] partial (split), puts
// it into slot me of every rank's landing buffer, quiet()s, signals CTA
// g of every peer (one region a section) and waits for the n arrivals,
// then folds its slice in f32 in rank order (acc = residual; acc = acc +
// land[r]), every landed value read through L2 (ld.global.cg). Every
// rank folds the same values in the same order, so every rank's y is
// bitwise the same. The epoch barrier is split as gemm_allreduce.cu
// splits it: CTA 0 of each rank arrives at kernel entry, and every CTA
// waits for the n arrivals before its first push, so no rank overwrites
// a landing slot a peer still folds from the previous launch (a device's
// launches run in stream order; one epoch a launch). One launch a device
// covers its ranks along blockIdx.z, each with its own scratch and grid
// barrier, at one CTA an SM split over the device's ranks, so that every
// rank's CTAs are resident at once (cudaLaunchCooperativeKernel refuses
// a grid that is not): a rank that spins on a peer whose CTAs were never
// scheduled would hang.
//
// What bounds it on an H100: bytes. At B = 128 a layer streams 100.7 MB
// of bf16 weights and reads its K/V once, against 12.9 GFLOP of products.
// The TP form over four ranks moves the same weights and K/V split four
// ways, plus 64 MiB of f32 partials (each rank's 1 MiB pushed to four
// slots and read back by the folds, two sections).
//
// Design.
// - Persistent grid: blocks-per-SM (occupancy API) x SM count, launched
//   with cudaLaunchCooperativeKernel, which refuses a grid that could not
//   be co-resident (a larger grid would deadlock at the first barrier).
//   The barrier is a sense-reversing counter in the scratch (no
//   relocatable device code needed); a wait of more than about ten
//   seconds traps instead of hanging.
// - Products: each CTA takes 64x64 output tiles (gate_up: 32 gate + 32 up
//   columns, so the SwiGLU is the epilogue) and streams 64-deep panels of
//   the bf16 activations and weights through a 3-stage cp.async ring in
//   shared memory; eight warps multiply with bf16 wmma fragments into f32
//   accumulators; the epilogue adds the residual or applies SwiGLU.
// - Attention: one warp per stream. Lane l holds head dims 4l..4l+3, so
//   RoPE pairs (i, i + 64) sit in lanes l and l ^ 16 (one shuffle) and the
//   appended row is one coalesced 256-byte store, made by the warp that
//   then reads it (__syncwarp; no other stream reads that row, so no grid
//   barrier sits between the append and the walk). The walk takes 32-key
//   tiles: each lane forms partial dot products over its dims for all 32
//   keys and a 31-shuffle transpose-reduction leaves key j's logit in lane
//   j, from where the online softmax is flash_tile.cuh's: -1e30 start,
//   scale after the dot, K scale on the logits, V scale folded into P, P
//   rounded to bf16 before the PV product, acc / max(l, 1e-30).
// - The int8 append quantizes the f32 row as kernels/quant.py does:
//   s = max(amax, 1e-8) / 127, q = rint(x / s) (half to even, a true
//   division). The bf16 append rounds the f32 row once.
#pragma once

#include <mma.h>

#include "common.cuh"
#include "shmem.cuh"

namespace tdt_mega {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BM = 64, BN = 64, BK = 64, kStages = 3;
constexpr int LDA = BK + 8;  // shared row strides in elements: 16-byte rows, spread banks
constexpr int LDW = BN + 8;
constexpr int LDC = BN + 4;
constexpr int kStageElems = BM * LDA + BK * LDW;
constexpr int kSmemBytes = kStages * kStageElems * 2;
static_assert(BM * LDC * 4 <= kSmemBytes, "the C tile reuses the stage ring");
static_assert(kThreads == tdt_shmem::kThreads, "the TP form launches through coop_launch");
constexpr int HD = 128;        // head dim the kernels are instantiated for
constexpr int DPL = HD / 32;   // head dims per lane
constexpr int kMaxRep = 4;     // query heads per kv head
constexpr int kBT = 32;        // keys per tile == warp width

enum Phase { kLn1 = 0, kQkvMm = 1, kAttend = 2, kOProj = 3, kLn2 = 4, kGateUp = 5,
             kDownProj = 6, kOAllReduce = 7, kDAllReduce = 8 };

// ---------------------------------------------------------------- caches

// Contiguous cache [B, Hkv, T, hd] (strides in elements).
template <typename KT> struct ContigCache {
  KT* k;
  KT* v;
  float* ks;
  float* vs;
  long long sb, sh, st;
  __device__ long long row(int b, int g, int t) const { return b * sb + g * sh + t * st; }
  __device__ long long srow(int, int, int) const { return 0; }
};

// Page pool [NP, 1, page, hd] (page stride pg_st, row stride row_st),
// int8 scale pages [NP, 1, page] (page stride spg_st), table [B*Hkv, maxp]
// int32. Logical tile t / page of stream b*Hkv + g lives in the page the
// table maps; the index is clamped to the table, as the JAX layer clamps
// the write page.
template <typename KT> struct PagedCache {
  KT* k;
  KT* v;
  float* ks;
  float* vs;
  const int* table;
  int Hkv, maxp, page;
  long long pg_st, row_st, spg_st;
  __device__ long long page_of(int b, int g, int t) const {
    return table[static_cast<long long>(b * Hkv + g) * maxp + min(t / page, maxp - 1)];
  }
  __device__ long long row(int b, int g, int t) const {
    return page_of(b, g, t) * pg_st + (t % page) * row_st;
  }
  __device__ long long srow(int b, int g, int t) const {
    return page_of(b, g, t) * spg_st + t % page;
  }
};

// ---------------------------------------------------------------- helpers

// Every CTA of the grid arrives before any leaves. bar[0] counts arrivals,
// bar[1] is the generation the last arrival bumps. Memory written before
// the barrier is visible after it (fences around the atomics).
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen_p = bar + 1;
    const unsigned int gen = *gen_p;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      long long spins = 0;
      while (*gen_p == gen) {
        __nanosleep(100);
        if (++spins > (1ll << 24)) __trap();  // a CTA never arrived
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// four consecutive cache elements of one lane, packed, and widened
template <typename KT> struct Pack4;
template <> struct Pack4<bf16> { using T = uint2; };
template <> struct Pack4<int8_t> { using T = unsigned int; };

template <typename KT>
__device__ __forceinline__ typename Pack4<KT>::T ld4(const KT* p) {
  return *reinterpret_cast<const typename Pack4<KT>::T*>(p);
}
template <typename KT>
__device__ __forceinline__ void unpack4(typename Pack4<KT>::T r, float* o) {
  const KT* e = reinterpret_cast<const KT*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) o[i] = to_f<KT>(e[i]);
}

// v[j] holds this lane's partial sum for key j; afterwards lane j holds
// the sum over lanes of v[j] (31 shuffles for 32 sums).
template <int W> __device__ __forceinline__ void tr_step(float* v, int lane) {
  const bool up = lane & W;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = up ? v[i] : v[i + W];
    const float keep = up ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}
__device__ __forceinline__ float transpose_reduce(float* v, int lane) {
  tr_step<16>(v, lane);
  tr_step<8>(v, lane);
  tr_step<4>(v, lane);
  tr_step<2>(v, lane);
  tr_step<1>(v, lane);
  return v[0];
}

// ---------------------------------------------------------------- phases

// out[b] = bf16(x[b] * rsqrt(mean(x[b]^2) + eps) * w), one warp per row
__device__ __forceinline__ void rmsnorm_rows(const float* x, const float* w, bf16* out,
                                             int B, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * kWarps;
  for (int b = blockIdx.x * kWarps + (threadIdx.x >> 5); b < B; b += nw) {
    const float* xr = x + static_cast<long long>(b) * D;
    float ss = 0.f;
    for (int c = lane * 4; c < D; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + c);
      ss += v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
    }
    const float r = rsqrtf(warp_sum(ss) / D + eps);
    bf16* orow = out + static_cast<long long>(b) * D;
    for (int c = lane * 4; c < D; c += 128) {
      const float4 v = *reinterpret_cast<const float4*>(xr + c);
      orow[c] = __float2bfloat16_rn(v.x * r * w[c]);
      orow[c + 1] = __float2bfloat16_rn(v.y * r * w[c + 1]);
      orow[c + 2] = __float2bfloat16_rn(v.z * r * w[c + 2]);
      orow[c + 3] = __float2bfloat16_rn(v.w * r * w[c + 3]);
    }
  }
}

// C = A[M, K] @ W[K, cols] over 64x64 output tiles, tile columns
// col_of(nb, 0) + [0, 32) and col_of(nb, 1) + [0, 32) of W; epi(Cs, m0, nb)
// consumes the f32 tile (row stride LDC) from shared memory. A rows past M
// load as zeros. K is a multiple of BK.
template <typename ColOf, typename Epi>
__device__ void gemm_phase(const bf16* A, int lda, const bf16* W, int ldw, int M, int K,
                           int n_blocks, ColOf col_of, Epi epi, char* smem) {
  using namespace nvcuda;
  bf16* sm = reinterpret_cast<bf16*>(smem);
  float* Cs = reinterpret_cast<float*>(smem);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int mtiles = (M + BM - 1) / BM;
  const int nk = K / BK;
  for (int tile = blockIdx.x; tile < mtiles * n_blocks; tile += gridDim.x) {
    // M fastest: the CTAs that share a weight panel run side by side
    const int m0 = (tile % mtiles) * BM, nb = tile / mtiles;
    const int c_lo = col_of(nb, 0), c_hi = col_of(nb, 1);
    auto load = [&](int kk, int s) {
      bf16* As = sm + s * kStageElems;
      bf16* Ws = As + BM * LDA;
      for (int ch = tid; ch < BM * BK / 8; ch += kThreads) {
        const int r = ch / (BK / 8), c = (ch % (BK / 8)) * 8;
        const bool ok = m0 + r < M;
        const bf16* src = ok ? A + static_cast<long long>(m0 + r) * lda + kk * BK + c : A;
        cp_async16(As + r * LDA + c, src, ok ? 16 : 0);
      }
      for (int ch = tid; ch < BK * BN / 8; ch += kThreads) {
        const int r = ch / (BN / 8), c = (ch % (BN / 8)) * 8;
        const int col = c < BN / 2 ? c_lo + c : c_hi + c - BN / 2;
        cp_async16(Ws + r * LDW + c, W + static_cast<long long>(kk * BK + r) * ldw + col, 16);
      }
    };
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nk) load(s, s);
      cp_async_commit();
    }
    for (int kk = 0; kk < nk; ++kk) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // panel kk landed; the slot refilled below is consumed
      if (kk + kStages - 1 < nk) load(kk + kStages - 1, (kk + kStages - 1) % kStages);
      cp_async_commit();
      const bf16* As = sm + (kk % kStages) * kStageElems;
      const bf16* Ws = As + BM * LDA;
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, As + wm * 16 * LDA + ks, LDA);
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
          wmma::load_matrix_sync(bw, Ws + ks * LDW + wn * 32 + f * 16, LDW);
          wmma::mma_sync(acc[f], a, bw, acc[f]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring: it becomes the C tile
#pragma unroll
    for (int f = 0; f < 2; ++f)
      wmma::store_matrix_sync(Cs + wm * 16 * LDC + wn * 32 + f * 16, acc[f], LDC,
                              wmma::mem_row_major);
    __syncthreads();
    epi(Cs, m0, nb);
    __syncthreads();  // the C tile is consumed before the next tile's loads
  }
}

// out[m, nb*64 + c] = C (+ add at the same index), rows < M
__device__ __forceinline__ void store_tile(const float* Cs, int m0, int nb, int M,
                                           float* out, const float* add, int ldo) {
  for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
    const int r = i / BN, c = i % BN;
    if (m0 + r >= M) continue;
    const long long o = static_cast<long long>(m0 + r) * ldo + nb * BN + c;
    out[o] = add ? Cs[r * LDC + c] + add[o] : Cs[r * LDC + c];
  }
}

// The attention phase: one warp per (b, g) stream (see the file comment).
template <typename KT, bool QUANT, typename Cache, typename PosOf>
__device__ void attend_phase(const tdt::MegaLayerArgs& L, const Cache& C, PosOf pos_of) {
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * kWarps;
  const int Hq = L.Hq, Hkv = L.Hkv, rep = Hq / Hkv;
  const long long Nqkv = static_cast<long long>(Hq + 2 * Hkv) * HD;
  const bool upper = lane >= 16;
  const int ci = (lane & 15) * DPL;  // RoPE frequency of this lane's first dim
  for (int x = blockIdx.x * kWarps + (threadIdx.x >> 5); x < L.B * Hkv; x += nw) {
    const int b = x / Hkv, g = x % Hkv;
    const int p = pos_of(b);
    const float* row = L.qkv + b * Nqkv;
    float cs[DPL], sn[DPL];
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      cs[e] = L.cos[b * L.cs_stride + ci + e];
      sn[e] = L.sin[b * L.cs_stride + ci + e];
    }
    // QK-norm (when the model has it) and RoPE of one head, in f32
    auto norm_rope = [&](const float* src, const float* nw_, float* out) {
      const float4 v4 = *reinterpret_cast<const float4*>(src + lane * DPL);
      float v[DPL] = {v4.x, v4.y, v4.z, v4.w};
      if (L.qk_norm) {
        float ss = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) ss += v[e] * v[e];
        const float r = rsqrtf(warp_sum(ss) / HD + L.eps);
#pragma unroll
        for (int e = 0; e < DPL; ++e) v[e] = v[e] * r * nw_[lane * DPL + e];
      }
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        const float o = __shfl_xor_sync(0xffffffffu, v[e], 16);
        out[e] = upper ? v[e] * cs[e] + o * sn[e] : v[e] * cs[e] - o * sn[e];
      }
    };
    float q[kMaxRep][DPL];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r < rep) {
        norm_rope(row + (g * rep + r) * HD, L.q_norm, q[r]);
#pragma unroll
        for (int e = 0; e < DPL; ++e) q[r][e] = round_to<bf16>(q[r][e]);
      }
    }
    float kn[DPL];
    norm_rope(row + (Hq + g) * HD, L.k_norm, kn);
    const float4 v4 = *reinterpret_cast<const float4*>(row + (Hq + Hkv + g) * HD + lane * DPL);
    const float vn[DPL] = {v4.x, v4.y, v4.z, v4.w};

    // the append of the new row at position p
    const long long wo = C.row(b, g, p) + lane * DPL;
    if constexpr (QUANT) {
      auto put = [&](KT* dst, float* sdst, const float* val) {
        float amax = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) amax = fmaxf(amax, fabsf(val[e]));
        const float s = fmaxf(warp_max(amax), 1e-8f) / 127.f;
        char4 q8;
        q8.x = static_cast<signed char>(__float2int_rn(val[0] / s));
        q8.y = static_cast<signed char>(__float2int_rn(val[1] / s));
        q8.z = static_cast<signed char>(__float2int_rn(val[2] / s));
        q8.w = static_cast<signed char>(__float2int_rn(val[3] / s));
        *reinterpret_cast<char4*>(dst + wo) = q8;
        if (lane == 0) *sdst = s;
      };
      const long long so = C.srow(b, g, p);
      put(C.k, C.ks + so, kn);
      put(C.v, C.vs + so, vn);
    } else {
      uint2 kr, vr;
      bf16* ke = reinterpret_cast<bf16*>(&kr);
      bf16* ve = reinterpret_cast<bf16*>(&vr);
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        ke[e] = __float2bfloat16_rn(kn[e]);
        ve[e] = __float2bfloat16_rn(vn[e]);
      }
      *reinterpret_cast<uint2*>(C.k + wo) = kr;
      *reinterpret_cast<uint2*>(C.v + wo) = vr;
    }
    __syncwarp();  // the row is written before any lane of this warp reads it

    const int len = L.fault == 1 ? p : p + 1;
    float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      m[r] = -1e30f;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] = 0.f;
    }
    using P4 = typename Pack4<KT>::T;
    for (int t0 = 0; t0 < len; t0 += kBT) {
      P4 kp[kBT];
#pragma unroll
      for (int j = 0; j < kBT; ++j)
        kp[j] = t0 + j < len ? ld4<KT>(C.k + C.row(b, g, t0 + j) + lane * DPL) : P4{};
      const int j = t0 + lane;  // this lane's key
      const bool valid = j < len;
      float ksj = 1.f, vsj = 1.f;
      if constexpr (QUANT) {
        if (valid) {
          const long long so = C.srow(b, g, j);
          ksj = C.ks[so];
          vsj = C.vs[so];
        }
      }
      float pj[kMaxRep];
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        pj[r] = 0.f;
        if (r >= rep) continue;
        float part[kBT];
#pragma unroll
        for (int jj = 0; jj < kBT; ++jj) {
          float kf[DPL];
          unpack4<KT>(kp[jj], kf);
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < DPL; ++e) d = fmaf(q[r][e], kf[e], d);
          part[jj] = d;
        }
        float s = transpose_reduce(part, lane) * L.scale;
        if constexpr (QUANT) s *= ksj;
        const float m_new = fmaxf(m[r], warp_max(valid ? s : -1e30f));
        const float alpha = expf(m[r] - m_new);
        float pi = valid ? expf(s - m_new) : 0.f;
        l[r] = l[r] * alpha + warp_sum(pi);
        if constexpr (QUANT) pi *= vsj;
        pj[r] = round_to<bf16>(pi);
        m[r] = m_new;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] *= alpha;
      }
      P4 vp[kBT];
#pragma unroll
      for (int jj = 0; jj < kBT; ++jj)
        vp[jj] = t0 + jj < len ? ld4<KT>(C.v + C.row(b, g, t0 + jj) + lane * DPL) : P4{};
#pragma unroll
      for (int jj = 0; jj < kBT; ++jj) {
        float vf[DPL];
        unpack4<KT>(vp[jj], vf);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r) {
          if (r >= rep) continue;
          const float pb = __shfl_sync(0xffffffffu, pj[r], jj);
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pb, vf[e], acc[r][e]);
        }
      }
    }
    bf16* out = static_cast<bf16*>(L.attn) + static_cast<long long>(b) * Hq * HD;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      uint2 o;
      bf16* oe = reinterpret_cast<bf16*>(&o);
#pragma unroll
      for (int e = 0; e < DPL; ++e) oe[e] = __float2bfloat16_rn(acc[r][e] * inv);
      *reinterpret_cast<uint2*>(out + (g * rep + r) * HD + lane * DPL) = o;
    }
  }
}

// One all-reduce section of the TP form (see the file comment): sec 0
// folds onto x into ores, sec 1 onto ores into y. Planted faults (L.fault)
// 3-5 for tools/fault_margin.py --mega-tp.
__device__ inline void ar_section(const tdt::MegaLayerArgs& L, const tdt::CommArgs& c,
                                  int sec, const float* add, float* dst) {
  const int me = tdt_shmem::my_pe(c), n = c.n;
  const long long nvec = static_cast<long long>(L.B) * L.D / 4;  // float4s of a partial
  long long lo, hi;
  tdt_shmem::split(nvec, lo, hi);
  auto slot = [&](int rank, int src) {
    return static_cast<float4*>(c.land[rank]) + (static_cast<long long>(sec) * n + src) * nvec;
  };
  const int odd = (me + 1) % n;  // the rank the faults 3 and 5 get wrong
  auto fold = [&]() {
    const float4* add4 = reinterpret_cast<const float4*>(add);
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) {
      float4 acc = __ldcg(add4 + i);
      for (int s = 0; s < n; ++s) {
        if (L.fault == 3 && s == odd) continue;
        const float4 v = __ldcg(slot(me, s) + i);
        for (int t = 0; t < (L.fault == 5 && s == odd ? 2 : 1); ++t) {
          acc.x = acc.x + v.x;
          acc.y = acc.y + v.y;
          acc.z = acc.z + v.z;
          acc.w = acc.w + v.w;
        }
      }
      dst4[i] = acc;
    }
  };
  if (L.fault == 4) fold();  // before the pushes and the wait: a stale own slot
  // the entry barrier's wait, before this launch's first push
  if (sec == 0) tdt_shmem::wait_all(c, c.sig[me] + tdt_shmem::kBarrier, 1);
  const float4* part = reinterpret_cast<const float4*>(L.part);
  for (int p = 0; p < n; ++p) {
    float4* d = slot(p, me);
    for (long long i = lo + threadIdx.x; i < hi; i += kThreads) d[i] = __ldcg(part + i);
  }
  tdt_shmem::quiet();
  const int region = sec ? tdt_shmem::kRegionB : tdt_shmem::kRegionA;
  tdt_shmem::signal_all(c, region, me);
  tdt_shmem::wait_sources(c, region);
  if (L.fault != 4) fold();
}

// ---------------------------------------------------------------- kernel

// The layer's phases in order; c is null at tp = 1, else the TP form's
// comm arguments (o_proj and down_proj then write the bare partial).
template <typename KT, bool QUANT, bool PAGED>
__device__ __forceinline__ void run_layer(const tdt::MegaLayerArgs& L, const tdt::CommArgs* c,
                                          char* smem) {
  const int B = L.B, D = L.D, F = L.F;
  const int HqD = L.Hq * HD, Nqkv = (L.Hq + 2 * L.Hkv) * HD;
  bf16* xn = static_cast<bf16*>(L.xn);
  bf16* attn = static_cast<bf16*>(L.attn);
  bf16* on = static_cast<bf16*>(L.on);
  bf16* h = static_cast<bf16*>(L.h);
  auto plain_cols = [](int nb, int half) { return nb * BN + half * (BN / 2); };
  for (int i = 0; i < L.n_phases; ++i) {
    if (i) grid_barrier(L.barrier);
    switch (L.phases[i]) {
      case kLn1:
        rmsnorm_rows(L.x, L.w_ln1, xn, B, D, L.eps);
        break;
      case kQkvMm: {
        float* qkv = L.qkv;
        gemm_phase(xn, D, static_cast<const bf16*>(L.w_qkv), Nqkv, B, D, Nqkv / BN,
                   plain_cols,
                   [&](const float* Cs, int m0, int nb) {
                     store_tile(Cs, m0, nb, B, qkv, nullptr, Nqkv);
                   },
                   smem);
        break;
      }
      case kAttend:
        if constexpr (PAGED) {
          const PagedCache<KT> C{static_cast<KT*>(L.k), static_cast<KT*>(L.v), L.ks, L.vs,
                                 L.table, L.Hkv, L.maxp, L.page, L.pg_st, L.row_st,
                                 L.spg_st};
          const int* pos = L.pos_dev;
          attend_phase<KT, QUANT>(L, C, [pos](int b) { return pos[b]; });
        } else {
          const ContigCache<KT> C{static_cast<KT*>(L.k), static_cast<KT*>(L.v), nullptr,
                                  nullptr, L.kv_sb, L.kv_sh, L.kv_st};
          const int pos = L.pos;
          attend_phase<KT, QUANT>(L, C, [pos](int) { return pos; });
        }
        break;
      case kOProj: {
        float* out = c ? L.part : L.ores;
        const float* add = c || L.fault == 2 ? nullptr : L.x;
        gemm_phase(attn, HqD, static_cast<const bf16*>(L.w_o), D, B, HqD, D / BN,
                   plain_cols,
                   [&](const float* Cs, int m0, int nb) {
                     store_tile(Cs, m0, nb, B, out, add, D);
                   },
                   smem);
        break;
      }
      case kOAllReduce:
        if (!c) __trap();
        ar_section(L, *c, 0, L.x, L.ores);
        break;
      case kDAllReduce:
        if (!c) __trap();
        ar_section(L, *c, 1, L.ores, L.y);
        break;
      case kLn2:
        rmsnorm_rows(L.ores, L.w_ln2, on, B, D, L.eps);
        break;
      case kGateUp:
        gemm_phase(on, D, static_cast<const bf16*>(L.w_gu), 2 * F, B, D, F / (BN / 2),
                   [F](int nb, int half) { return half * F + nb * (BN / 2); },
                   [&](const float* Cs, int m0, int nb) {
                     for (int i = threadIdx.x; i < BM * BN / 2; i += kThreads) {
                       const int r = i / (BN / 2), c = i % (BN / 2);
                       if (m0 + r >= B) continue;
                       const float g = Cs[r * LDC + c], u = Cs[r * LDC + BN / 2 + c];
                       h[static_cast<long long>(m0 + r) * F + nb * (BN / 2) + c] =
                           __float2bfloat16_rn(g * (1.f / (1.f + expf(-g))) * u);
                     }
                   },
                   smem);
        break;
      case kDownProj: {
        float* out = c ? L.part : L.y;
        const float* add = c ? nullptr : L.ores;
        gemm_phase(h, F, static_cast<const bf16*>(L.w_d), D, B, F, D / BN, plain_cols,
                   [&](const float* Cs, int m0, int nb) {
                     store_tile(Cs, m0, nb, B, out, add, D);
                   },
                   smem);
        break;
      }
      default:
        __trap();
    }
  }
}

template <typename KT, bool QUANT, bool PAGED>
__global__ void __launch_bounds__(kThreads, 1) mega_layer_kernel(const tdt::MegaLayerArgs L) {
  extern __shared__ __align__(128) char smem[];
  run_layer<KT, QUANT, PAGED>(L, nullptr, smem);
}

// The TP form: local rank blockIdx.z runs its layer L[blockIdx.z].
template <typename KT>
__global__ void __launch_bounds__(kThreads, 1)
    mega_tp_kernel(const __grid_constant__ tdt::MegaTpArgs P) {
  extern __shared__ __align__(128) char smem[];
  const tdt::CommArgs& c = P.c;
  const int me = tdt_shmem::my_pe(c);
  // the epoch barrier's arrival (its wait comes before the first push)
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int p = 0; p < c.n; ++p) tdt_shmem::signal_op(c.sig[p] + tdt_shmem::kBarrier + me, c.epoch);
  run_layer<KT, false, false>(P.L[blockIdx.z], &c, smem);
}

// Launch one layer as a cooperative grid of (blocks per SM) x (SMs) CTAs
// on the current device. Returns cudaErrorNotSupported without
// cooperative launch (no fallback), else the launch's own error, then
// cudaGetLastError(). The grid and the large shared-memory attribute are
// set per device, at its first launch: a mesh's cards each need them.
constexpr int kMaxDevices = 64;
template <typename KT, bool QUANT, bool PAGED>
cudaError_t launch_layer(const tdt::MegaLayerArgs& a, cudaStream_t stream) {
  auto kernel = mega_layer_kernel<KT, QUANT, PAGED>;
  static int grids[kMaxDevices] = {};  // per instantiation and device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (grids[dev] == 0) {
    int coop = 0, sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (!coop) return cudaErrorNotSupported;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      kSmemBytes);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    grids[dev] = per_sm * sms;
  }
  tdt::MegaLayerArgs args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grids[dev]),
                                  dim3(kThreads), params, kSmemBytes, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace tdt_mega
