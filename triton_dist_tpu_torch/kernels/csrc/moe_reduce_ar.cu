// Kernel I, moe_reduce_ar over n ranks: per expert e, y[e] = sum over ranks
// of h_r[e] @ w_r[e], replicated on every rank, in one kernel. Rank r holds
// h_r [E, M, K] (its K-shard of the expert activations, bf16 or f32) and
// w_r [E, K, N] (its row shard of the down panels, in h's dtype; a strided
// view) and gets y [E, M, N] in h's dtype. The down products of the
// tensor-parallel MoE layer's decode form (TP_MoE.fwd_fused_ar).
//
// Replaces triton_dist_tpu/kernels/moe_reduce_ar.py `_moe_ar_kernel` (:42;
// the pallas_call of its `_call` at :215): each rank's expert partials in
// f32, rounded to h's dtype (:102-106) and pushed into slot me of every
// rank's landing buffer [n, E, M, N]; then every rank sums the n landed
// partials in rank order in f32 and rounds once (:133-141). Those are the
// TPU kernel's roundings, so the result differs from moe_reduce_ar_ref only
// by the products' summation order. The int8 QuantW panels of the TPU
// kernel are not ported here.
//
// What bounds it: at decode (M = 24 rows an expert, E = 128, K = 192, N =
// 2048, bf16) bytes, the rank's panel (2 E K N) and the n landed partials
// (2 n E M N); on four cards the pushes add (n - 1) E M N of NVLink traffic
// a rank.
//
// Design (as gemm_allreduce.cu): one cooperative launch per device over
// (ctas, 1, local ranks); persistent CTAs loop over the tiles of every
// expert (moe_tile.cuh), every rank's CTA g owning the same tiles. A CTA
// raises its barrier flag first and waits for its peers' after its first
// product, so the barrier hides under it; it pushes each rounded tile into
// every rank's landing slot me, then signals every peer and waits for CTA g
// of every rank before it reduces its tiles.
#include "moe_tile.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T>
__global__ void __launch_bounds__(kThreads) moe_ar_kernel(tdt::MoeCommArgs m) {
  using Tl = tdt_gemm::RowTile<T, T>;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const CommArgs& a = m.c;
  const int me = my_pe(a);
  const T* H = static_cast<const T*>(a.in[me]);
  const T* W = static_cast<const T*>(a.in2[me]);
  const long long slot = static_cast<long long>(m.E) * m.M * m.N;  // elements
  // barrier_all, split: arrive now, wait before the first put
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int p = 0; p < a.n; ++p) signal_op(a.sig[p] + kBarrier + me, a.epoch);
  bool entered = false;
  const int tiles = tdt_moe::tile_count<Tl>(m.E, m.M, m.N, m.N);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const tdt_moe::TileIx ix = tdt_moe::tile_at<Tl>(t, m.M, m.N, m.N);
    tdt_moe::tile_product<Tl>(ix, H, W, W, m.b_es[me], m.b_ld[me], m.M, m.K, smem);
    if (!entered) {
      wait_all(a, a.sig[me] + kBarrier, 1);
      entered = true;
    }
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (ix.m0 + r >= m.M || ix.n0 + c >= m.N) continue;
      // the partial, rounded to h's dtype
      const uint4 tile16 = tdt_gemm::tile_vec<T, Tl::LD>(Cs, r, c, nullptr, 0);
      const long long off = me * slot +
                            (static_cast<long long>(ix.e) * m.M + ix.m0 + r) * m.N + ix.n0 + c;
      for (int p = 0; p < a.n; ++p)
        *reinterpret_cast<uint4*>(static_cast<T*>(a.land[p]) + off) = tile16;
    }
  }
  if (!entered) wait_all(a, a.sig[me] + kBarrier, 1);
  quiet();
  signal_all(a, kRegionA, me);
  wait_sources(a, kRegionA);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const tdt_moe::TileIx ix = tdt_moe::tile_at<Tl>(t, m.M, m.N, m.N);
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (ix.m0 + r >= m.M || ix.n0 + c >= m.N) continue;
      reduce_landed<T>(static_cast<uint4*>(a.out[me]), static_cast<const uint4*>(a.land[me]),
                       slot / V, a.n,
                       ((static_cast<long long>(ix.e) * m.M + ix.m0 + r) * m.N + ix.n0 + c) / V);
    }
  }
}

template <typename T>
cudaError_t launch(const tdt::MoeCommArgs& m, int ctas, cudaStream_t stream) {
  tdt::MoeCommArgs args_v = m;
  void* args[] = {&args_v};
  return tdt::coop_launch(moe_ar_kernel<T>, m.c, ctas, tdt_gemm::RowTile<T, T>::kSmem, args,
                          stream);
}

}  // namespace

cudaError_t tdt::moe_reduce_ar(int dtype, const MoeCommArgs& m, int ctas, cudaStream_t stream) {
  if (m.E == 0 || m.M == 0 || m.N == 0) return cudaSuccess;
  if (m.c.n < 2 || m.split != m.N || m.b1[0]) return cudaErrorInvalidValue;
  if (!tdt::moe_shapes_ok(dtype, m)) return cudaErrorInvalidValue;
  if (dtype == kBF16) return launch<bf16>(m, ctas, stream);
  if (dtype == kF32) return launch<float>(m, ctas, stream);
  return cudaErrorInvalidValue;
}
