// Kernel G, ag_group_gemm over n ranks: per expert e, C_r[e] = allgather(x)[e]
// @ w_r[e]. Rank r holds its capacity chunk x_r [E, c, K] (rows [r c, (r+1)
// c) of every expert of the grouped tokens [E, n c, K]) and its column
// panel w_r [E, K, N_r] (bf16 or f32, in x's dtype; a strided view or two
// column blocks, [gate_r | up_r]), and gets C_r [E, n c, N_r] in x's dtype;
// the gathered tokens stay in the rank's symmetric buffer [E, n c, K]. The
// gate/up products of the tensor-parallel MoE layer's fused form
// (TP_MoE.fwd_fused).
//
// Replaces triton_dist_tpu/kernels/ag_group_gemm.py `_ag_group_gemm_kernel`
// (:46; the pallas_call of its `_call` at :285): a ring all-gather of the
// capacity chunks and, per chunk and expert, the product against the
// expert's local columns in f32, each tile rounded once to x's dtype
// (:176-180). The result is ag_group_gemm_ref's (the f32 product of the
// gathered tokens and w_r rounded once) up to the product's summation
// order. The int8 QuantW panels of the TPU kernel are not ported here.
//
// What bounds it: at decode (n c = 32 rows an expert, E = 128, K = 2048,
// N_r = 384, bf16) bytes, every rank's panel read once (2 E K N_r); at
// prefill (n c = 2080) operations. On four cards the ring moves (n - 1) E
// c K elements into each rank over NVLink.
//
// Design (as ag_gemm.cu: the ring, then the tiles, no overlap yet): one
// cooperative launch per device over (ctas, 1, local ranks). CTA g owns
// slice g of a chunk's E c K / V vectors, (expert, vector) = (i / cv, i %
// cv); it copies its slice of the local chunk into slot me of the gathered
// buffer (each expert's rows [me c, (me+1) c)), enters through barrier_all
// and forwards at ring step s the slice of chunk (me - s) % n to the right
// neighbour, waiting only for CTA g of its left one; a rank_barrier then
// tells every CTA that every slice has landed. The persistent tile loop
// (moe_tile.cuh) multiplies the gathered rows.
#include "moe_tile.cuh"

namespace {

using namespace tdt_shmem;
using bf16 = __nv_bfloat16;

template <typename T>
__global__ void __launch_bounds__(kThreads) ag_group_gemm_kernel(tdt::MoeCommArgs m,
                                                                 long long cv) {
  using Tl = tdt_gemm::RowTile<T, T>;
  constexpr int V = Vec16<T>::n;
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem);
  const CommArgs& a = m.c;
  const int me = my_pe(a), n = a.n;
  const long long ev = n * cv;  // vectors of one expert's gathered rows
  long long lo, hi;
  split(m.E * cv, lo, hi);
  // the local chunk first: only this rank's CTA g reads it back (the ring)
  {
    uint4* g = static_cast<uint4*>(a.out[me]);
    const uint4* x = static_cast<const uint4*>(a.in[me]);
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
      g[(i / cv) * ev + me * cv + i % cv] = x[i];
  }
  barrier_all(a);
  int left, right;
  ring_neighbors(a, left, right);
  const uint4* mine = static_cast<const uint4*>(a.out[me]);
  uint4* theirs = static_cast<uint4*>(a.out[right]);
  for (int s = 0; s < n - 1; ++s) {
    const long long src = (me - s + n) % n;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const long long o = (i / cv) * ev + src * cv + i % cv;
      theirs[o] = ld_peer(mine + o);
    }
    quiet();
    if (threadIdx.x == 0) {
      signal_op(flag(a.sig[right], kRegionA, s), a.epoch);
      signal_wait_until(flag(a.sig[me], kRegionA, s), a.epoch);  // chunk (me-s-1) % n
    }
    __syncthreads();
  }
  rank_barrier(a, kRegionB);
  const T* A = static_cast<const T*>(a.out[me]);
  const T* B0 = static_cast<const T*>(a.in2[me]);
  const T* B1 = static_cast<const T*>(m.b1[me]);
  T* C = static_cast<T*>(a.out2[me]);
  const int tiles = tdt_moe::tile_count<Tl>(m.E, m.M, m.N, m.split);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const tdt_moe::TileIx ix = tdt_moe::tile_at<Tl>(t, m.M, m.N, m.split);
    tdt_moe::tile_product<Tl>(ix, A, B0, B1, m.b_es[me], m.b_ld[me], m.M, m.K, smem);
    T* Ce = C + static_cast<long long>(ix.e) * m.M * m.N + ix.col0 + ix.n0;
    for (int ch = threadIdx.x; ch < Tl::BM * (Tl::BN / V); ch += kThreads) {
      const int r = ch / (Tl::BN / V), c = (ch % (Tl::BN / V)) * V;
      if (ix.m0 + r >= m.M || ix.n0 + c >= ix.cols) continue;
      *reinterpret_cast<uint4*>(Ce + static_cast<long long>(ix.m0 + r) * m.N + c) =
          tdt_gemm::tile_vec<T, Tl::LD>(Cs, r, c, nullptr, 0);
    }
  }
}

template <typename T>
cudaError_t launch(const tdt::MoeCommArgs& m, long long cv, int ctas, cudaStream_t stream) {
  tdt::MoeCommArgs args_v = m;
  void* args[] = {&args_v, &cv};
  return tdt::coop_launch(ag_group_gemm_kernel<T>, m.c, ctas, tdt_gemm::RowTile<T, T>::kSmem,
                          args, stream);
}

}  // namespace

cudaError_t tdt::ag_group_gemm(int dtype, const MoeCommArgs& m, long long cv, int ctas,
                               cudaStream_t stream) {
  if (m.E == 0 || m.M == 0 || m.N == 0) return cudaSuccess;
  if (m.c.n < 2 || m.M % m.c.n || cv < 1) return cudaErrorInvalidValue;
  if (!tdt::moe_shapes_ok(dtype, m)) return cudaErrorInvalidValue;
  if (dtype == kBF16) return launch<bf16>(m, cv, ctas, stream);
  if (dtype == kF32) return launch<float>(m, cv, ctas, stream);
  return cudaErrorInvalidValue;
}
