// The grouped tiles of the tensor-parallel MoE comm kernels
// (ag_group_gemm.cu, moe_reduce_rs.cu, moe_reduce_ar.cu): per expert e,
// C_e [M, N] = A_e [M, K] @ B_e [K, N] with A packed ([E, M, K]) and B a
// rank's strided panel (expert stride b_es, row stride b_ld), its columns
// [0, split) from block 0 and [split, N) from block 1 (ag_group_gemm's
// [gate_r | up_r], two views of the one-rank [gate | up] panel; one block
// when split == N). A tile is gemm_tile.cuh's RowTile (128 x 128 wmma for
// bf16, 64 x 64 FMA for f32) within one block, so a tile never straddles
// the two.
#pragma once

#include "gemm_tile.cuh"
#include "shmem.cuh"

namespace tdt_moe {

// tile t of the E experts x row tiles x column tiles of block 0 then 1
struct TileIx {
  int e, m0, n0;   // expert, first row, first column within the block
  int col0, cols;  // the block's first output column and its width
  bool second;     // block 1
};

template <typename Tl>
__device__ __forceinline__ int tile_count(int E, int M, int N, int split) {
  const int tm = (M + Tl::BM - 1) / Tl::BM;
  return E * tm * ((split + Tl::BN - 1) / Tl::BN + (N - split + Tl::BN - 1) / Tl::BN);
}

template <typename Tl>
__device__ __forceinline__ TileIx tile_at(int t, int M, int N, int split) {
  const int t0 = (split + Tl::BN - 1) / Tl::BN, t1 = (N - split + Tl::BN - 1) / Tl::BN;
  const int per = ((M + Tl::BM - 1) / Tl::BM) * (t0 + t1);
  TileIx ix;
  ix.e = t / per;
  const int r = t % per, c = r % (t0 + t1);
  ix.m0 = (r / (t0 + t1)) * Tl::BM;
  ix.second = c >= t0;
  ix.n0 = (ix.second ? c - t0 : c) * Tl::BN;
  ix.col0 = ix.second ? split : 0;
  ix.cols = ix.second ? N - split : split;
  return ix;
}

// the tile's product into shared memory: A_e = a + e * M * K (row stride
// K), B_e from block 0 (b0) or 1 (b1) at e * b_es, row stride b_ld
template <typename Tl, typename T>
__device__ __forceinline__ void tile_product(const TileIx& ix, const T* a, const T* b0,
                                             const T* b1, long long b_es, long long b_ld, int M,
                                             int K, unsigned char* smem) {
  const T* b = (ix.second ? b1 : b0) + ix.e * b_es;
  Tl::compute_ld(a + static_cast<long long>(ix.e) * M * K, K, b, b_ld, M, ix.cols, K, ix.m0,
                 ix.n0, smem);
}

}  // namespace tdt_moe
