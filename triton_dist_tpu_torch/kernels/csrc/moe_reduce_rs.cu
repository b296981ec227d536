// Kernel H, moe_reduce_rs over n ranks: per expert e, y[e] =
// reduce_scatter(sum over ranks of h_r[e] @ w_r[e]) along the rows. Rank r
// holds h_r [E, M, K] (its K-shard of the expert activations, bf16 or f32)
// and w_r [E, K, N] (its row shard of the down panels, in h's dtype; a
// strided view) and gets rows [r M / n, (r + 1) M / n) of every expert of
// the sum, [E, M / n, N] in h's dtype. The down products of the
// tensor-parallel MoE layer's fused form (TP_MoE.fwd_fused).
//
// Replaces triton_dist_tpu/kernels/moe_reduce_rs.py `_moe_rs_kernel` (:38;
// the pallas_call of its `_call` at :293), with its roundings: each
// expert's partial in f32, rounded to h's dtype (:149-153); then the ring
// fold, which adds the landed slab in f32 and rounds at every hop
// (:191-193), chunk c (every expert's rows [c M / n, (c+1) M / n)) starting
// at rank c + 1 and ending at rank c. That is tdt_shmem::ring_reduce_scatter
// over the rounded partials laid out chunk-major, so the result differs
// from moe_reduce_rs_ref only by the products' summation order. The int8
// QuantW panels of the TPU kernel are not ported here.
//
// What bounds it: at decode (M = 32 rows an expert, E = 128, K = 192, N =
// 2048, bf16) bytes, the rank's panel (2 E K N); at prefill (M = 2080)
// operations. On four cards the ring moves (n - 1) / n of each rank's
// partial over NVLink.
//
// Design (as gemm_rs.cu): one cooperative launch per device over (ctas, 1,
// local ranks). A CTA raises its barrier flag first; the persistent tile
// loop (moe_tile.cuh) writes the rank's rounded partial into its local
// buffer chunk-major, [n, E, M / n, N], so that chunk c is one run of
// vectors; a rank_barrier follows, since CTA g's ring slice of a chunk spans
// tiles that other CTAs wrote; then every CTA waits for the peers' barrier
// flags and runs the ring. The products and the ring do not overlap yet.
#include "moe_tile.cuh"
#include "ring.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T>
__global__ void __launch_bounds__(kThreads) moe_rs_kernel(tdt::MoeCommArgs m, long long cvec) {
  using Tl = tdt_gemm::RowTile<T, T>;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const CommArgs& a = m.c;
  const int me = my_pe(a);
  // barrier_all, split: arrive now, wait before the first put
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int p = 0; p < a.n; ++p) signal_op(a.sig[p] + kBarrier + me, a.epoch);
  const T* H = static_cast<const T*>(a.in[me]);
  const T* W = static_cast<const T*>(a.in2[me]);
  T* P = static_cast<T*>(a.out2[me]);
  const int c = m.M / a.n;  // rows of an expert in a chunk
  const int tiles = tdt_moe::tile_count<Tl>(m.E, m.M, m.N, m.N);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const tdt_moe::TileIx ix = tdt_moe::tile_at<Tl>(t, m.M, m.N, m.N);
    tdt_moe::tile_product<Tl>(ix, H, W, W, m.b_es[me], m.b_ld[me], m.M, m.K, smem);
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), cc = (ch % (Tl::BN / V)) * V;
      const int row = ix.m0 + r;
      if (row >= m.M || ix.n0 + cc >= m.N) continue;
      const long long off =
          ((static_cast<long long>(row / c) * m.E + ix.e) * c + row % c) * m.N + ix.n0 + cc;
      *reinterpret_cast<uint4*>(P + off) = tdt_gemm::tile_vec<T, Tl::LD>(Cs, r, cc, nullptr, 0);
    }
  }
  rank_barrier(a, kRegionB);
  wait_all(a, a.sig[me] + kBarrier, 1);
  ring_reduce_scatter<T>(a, static_cast<const uint4*>(a.out2[me]),
                         static_cast<uint4*>(a.out[me]), cvec, kRegionA);
}

template <typename T>
cudaError_t launch(const tdt::MoeCommArgs& m, long long cvec, int ctas, cudaStream_t stream) {
  tdt::MoeCommArgs args_v = m;
  void* args[] = {&args_v, &cvec};
  return tdt::coop_launch(moe_rs_kernel<T>, m.c, ctas, tdt_gemm::RowTile<T, T>::kSmem, args,
                          stream);
}

}  // namespace

cudaError_t tdt::moe_reduce_rs(int dtype, const MoeCommArgs& m, long long cvec, int ctas,
                               cudaStream_t stream) {
  if (m.E == 0 || m.M == 0 || m.N == 0) return cudaSuccess;
  if (m.c.n < 2 || m.M % m.c.n || cvec < 1 || m.split != m.N || m.b1[0])
    return cudaErrorInvalidValue;
  if (!tdt::moe_shapes_ok(dtype, m)) return cudaErrorInvalidValue;
  if (dtype == kBF16) return launch<bf16>(m, cvec, ctas, stream);
  if (dtype == kF32) return launch<float>(m, cvec, ctas, stream);
  return cudaErrorInvalidValue;
}
