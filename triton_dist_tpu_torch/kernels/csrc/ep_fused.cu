// Kernel F, the fused expert-parallel MoE: dispatch, the local experts'
// SwiGLU MLPs and the combine put in one kernel per rank.
//
// Replaces triton_dist_tpu/kernels/ep_fused.py `ep_moe_fused_device` (the
// pallas_call at :491, `_ep_fused_kernel` :68). Rank o's send buffer x_o
// [n, E, cap, D] holds in slab p its tokens for peer p's E local experts,
// grouped by expert (the layer plans one destination per global expert);
// an unused slot is a zero row. Afterwards y_back_o [n, E, cap, D] holds in
// slab p those tokens' results, computed on peer p as
//     swiglu(x @ w_gu[e]) @ w_d[e]
// with w_gu [E, D, 2I] packed [gate | up] and w_d [E, I, D] (bf16 or f32, or
// both int8 QuantW panels with per-expert per-column f32 scales: the
// gate/up scale applies to h before the SwiGLU, the down scale to the
// down product). The roundings are the Pallas kernel's: h in f32, the
// activation rounded to x's dtype, the down product in f32 rounded once.
//
// What bounds it: at the serving layer's shape (cap = 8 rows a global
// expert, E = 32 experts a rank, D = 2048, I = 768, bf16) the weight panels:
// each rank reads its 3 E D I weights once (151 MB bf16) against 6 n E cap
// D I flops, about 4 flops a byte.
//
// Design (a simple kernel that is right; no overlap of the phases yet):
// one cooperative launch per device over (ctas, 1, local ranks).
//   1. barrier_all, then CTA g puts slice g of slab p into rank p's
//      landing buffer recv_p [E, n*cap, D] at rows [me*cap, (me+1)*cap) of
//      each expert (p = me included), and raises flag `me` of region A in
//      every rank's pad.
//   2. Gate/up tiles over (peer q in arrival order me, me+1, ..., expert,
//      rows, columns of I): before the first tile of q the CTA waits for
//      every CTA of q (their slices together make q's slab); each tile is
//      two products of gemm_tile.cuh's RowTile (the gate columns, then the
//      up columns), scaled, silu(gate) * up, rounded into h [E, n*cap, I].
//   3. rank_barrier (region C): every CTA of the rank has written h.
//   4. Down tiles over (q, expert, rows, columns of D): h's rows of q @
//      w_d[e], scaled, rounded and stored straight into y_back of rank q,
//      slab me (the combine put from the GEMM epilogue); then flag `me` of
//      region B in every rank's pad, and the CTA waits for its flags from
//      every source: together the CTAs of a rank see every slab land.
// Every spin traps after its bound (csrc/shmem.cuh).
#include "gemm_tile.cuh"
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T, typename BT>
__global__ void __launch_bounds__(kThreads) ep_fused_kernel(tdt::EpFusedArgs f) {
  using Tl = tdt_gemm::RowTile<T, BT>;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned arrived;
  const CommArgs& a = f.c;
  const float* Cs = reinterpret_cast<const float*>(smem);
  float* Gs = reinterpret_cast<float*>(smem + Tl::kSmem);   // the gate tile
  const int me = my_pe(a), n = a.n;
  const int E = f.E, cap = f.cap, D = f.D, I = f.I;

  // 1. dispatch
  barrier_all(a);
  {
    const long long cv = static_cast<long long>(cap) * D / V;  // 16-byte vectors of (e, slab)
    long long lo, hi;
    split(E * cv, lo, hi);
    const uint4* x = static_cast<const uint4*>(a.in[me]);
    for (int s = 1; s <= n; ++s) {
      const int p = (me + s) % n;
      uint4* recv = static_cast<uint4*>(a.land[p]);
      const uint4* slab = x + p * E * cv;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
        const long long e = i / cv, j = i % cv;
        recv[(e * n + me) * cv + j] = slab[i];
      }
    }
    quiet();
    signal_all(a, kRegionA, me);
  }

  // 2. gate/up products and the SwiGLU
  if (threadIdx.x == 0) arrived = 0;
  __syncthreads();
  const T* recv = static_cast<const T*>(a.land[me]);
  T* h = static_cast<T*>(a.out2[me]);
  const BT* wgu = static_cast<const BT*>(a.in2[me]);
  const float* sgu = a.scale[me];
  const int tm = (cap + Tl::BM - 1) / Tl::BM;
  const int tn1 = (I + Tl::BN - 1) / Tl::BN, tn2 = (D + Tl::BN - 1) / Tl::BN;
  const int per1 = E * tm * tn1, per2 = E * tm * tn2;
  for (int t = blockIdx.x; t < n * per1; t += gridDim.x) {
    const int q = (me + t / per1) % n;
    int r = t % per1;
    const int e = r / (tm * tn1);
    r %= tm * tn1;
    const int m0 = (r / tn1) * Tl::BM, n0 = (r % tn1) * Tl::BN;
    if (threadIdx.x == 0 && !((arrived >> q) & 1u)) {
      signal_wait_rank(a, kRegionA, q);
      arrived |= 1u << q;
    }
    __syncthreads();
    const T* A = recv + (static_cast<long long>(e) * n + q) * cap * D;
    const BT* B = wgu + static_cast<long long>(e) * D * 2 * I;
    Tl::compute(A, B, cap, 2 * I, D, m0, n0, smem);
    for (int i = threadIdx.x; i < Tl::BM * Tl::LD; i += kThreads) Gs[i] = Cs[i];
    Tl::compute(A, B, cap, 2 * I, D, m0, I + n0, smem);
    const float* sg = sgu ? sgu + static_cast<long long>(e) * 2 * I : nullptr;
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int rr = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (m0 + rr >= cap || n0 + c >= I) continue;
      float act[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float g = Gs[rr * Tl::LD + c + v] * (sg ? sg[n0 + c + v] : 1.f);
        const float u = Cs[rr * Tl::LD + c + v] * (sg ? sg[I + n0 + c + v] : 1.f);
        act[v] = g / (1.f + __expf(-g)) * u;
      }
      store16<T>(h + ((static_cast<long long>(e) * n + q) * cap + m0 + rr) * I + n0 + c, act);
    }
  }

  // 3. every CTA of the rank has written its share of h
  rank_barrier(a, kRegionC);

  // 4. down products, stored into the origin's y_back
  const BT* wd = static_cast<const BT*>(f.wd[me]);
  const float* sd = f.sd[me];
  for (int t = blockIdx.x; t < n * per2; t += gridDim.x) {
    const int q = (me + t / per2) % n;
    int r = t % per2;
    const int e = r / (tm * tn2);
    r %= tm * tn2;
    const int m0 = (r / tn2) * Tl::BM, n0 = (r % tn2) * Tl::BN;
    const T* A = h + (static_cast<long long>(e) * n + q) * cap * I;
    Tl::compute(A, wd + static_cast<long long>(e) * I * D, cap, D, I, m0, n0, smem);
    T* yb = static_cast<T*>(a.out[q]) + (static_cast<long long>(me) * E + e) * cap * D;
    const float* s = sd ? sd + static_cast<long long>(e) * D : nullptr;
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int rr = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (m0 + rr >= cap || n0 + c >= D) continue;
      *reinterpret_cast<uint4*>(yb + static_cast<long long>(m0 + rr) * D + n0 + c) =
          tdt_gemm::tile_vec<T, Tl::LD>(Cs, rr, c, s, n0 + c);
    }
  }
  quiet();
  signal_all(a, kRegionB, me);
  wait_sources(a, kRegionB);
}

template <typename T, typename BT>
cudaError_t launch(const tdt::EpFusedArgs& f, int ctas, cudaStream_t stream) {
  tdt::EpFusedArgs args_v = f;
  void* args[] = {&args_v};
  using Tl = tdt_gemm::RowTile<T, BT>;
  return tdt::coop_launch(ep_fused_kernel<T, BT>, f.c, ctas,
                          Tl::kSmem + Tl::BM * Tl::LD * static_cast<int>(sizeof(float)), args,
                          stream);
}

}  // namespace

cudaError_t tdt::ep_moe_fused(int dtype, int w_dtype, const EpFusedArgs& f, int ctas,
                              cudaStream_t stream) {
  if (f.E < 1 || f.cap < 1 || f.c.n > 32) return cudaErrorInvalidValue;
  const int V = dtype == kBF16 ? 8 : 4;
  if (f.D % V || f.I % V) return cudaErrorInvalidValue;
  const bool quant = w_dtype == kI8;
  for (int r = 0; r < f.c.n; ++r)
    if (quant != (f.c.scale[r] != nullptr) || quant != (f.sd[r] != nullptr))
      return cudaErrorInvalidValue;
  if (dtype == kBF16 && w_dtype == kBF16) return launch<bf16, bf16>(f, ctas, stream);
  if (dtype == kBF16 && w_dtype == kI8) return launch<bf16, int8_t>(f, ctas, stream);
  if (dtype == kF32 && w_dtype == kF32) return launch<float, float>(f, ctas, stream);
  if (dtype == kF32 && w_dtype == kI8) return launch<float, int8_t>(f, ctas, stream);
  return cudaErrorInvalidValue;
}
