// Kernel (row 25), kv_cache_scatter: the fill of a sequence-sharded KV
// cache from sequence-sharded new K or V, in place.
//
// Replaces triton_dist_tpu/kernels/sp_flash_decode.py `kv_cache_scatter`
// (the pallas_call of `_f` at :330, kernel `_kv_scatter_kernel`): rank me
// holds the s_loc new positions [me * s_loc, (me + 1) * s_loc) of every
// (batch, kv-head) stream and puts them straight into the window of their
// owner, rank (me * s_loc) / t_loc, at row (me * s_loc) % t_loc, then
// signals it; the owner waits for its arrivals (the blocks whose positions
// fall in its window, JAX :284-303's cnt). The rest of each window keeps
// its contents.
//
// What bounds it: bytes, each new row read once and written once (over
// NVLink when the owner is another card).
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all (csrc/shmem.cuh): no rank writes into a
// window its owner may still read from an earlier call. CTA g of every
// rank copies the same slice of its block (16-byte vectors), signals CTA
// g of the owner (region A, slot me) and waits for CTA g of each of its
// own sources, so the launch returns only once its window is complete.
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;

__global__ void __launch_bounds__(kThreads)
kv_scatter_kernel(CommArgs a, int BH, int s_loc, int t_loc, long long row_vec) {
  const int me = my_pe(a);
  const long long first = static_cast<long long>(me) * s_loc;
  const int owner = static_cast<int>(first / t_loc);
  const long long off = first % t_loc;
  const long long blk = s_loc * row_vec;  // vectors of one stream's block
  long long lo, hi;
  split(BH * blk, lo, hi);
  barrier_all(a);
  const uint4* src = static_cast<const uint4*>(a.in[me]);
  uint4* dst = static_cast<uint4*>(a.out[owner]);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const long long bh = i / blk, j = i % blk;
    dst[bh * t_loc * row_vec + off * row_vec + j] = ld_peer(src + i);
  }
  quiet();
  if (threadIdx.x == 0) {
    signal_op(flag(a.sig[owner], kRegionA, me), a.epoch);
    // the blocks landing in this rank's window
    for (int p = 0; p < a.n; ++p)
      if (static_cast<long long>(p) * s_loc / t_loc == me)
        signal_wait_until(flag(a.sig[me], kRegionA, p), a.epoch);
  }
  __syncthreads();
}

}  // namespace

cudaError_t tdt::kv_scatter(const CommArgs& a, int BH, int s_loc, int t_loc, long long row_vec,
                            int ctas, cudaStream_t stream) {
  if (BH < 0 || s_loc < 1 || t_loc < s_loc || t_loc % s_loc || row_vec < 1)
    return cudaErrorInvalidValue;
  if (BH == 0) return cudaSuccess;
  tdt::CommArgs args_v = a;
  void* args[] = {&args_v, &BH, &s_loc, &t_loc, &row_vec};
  return tdt::coop_launch(kv_scatter_kernel, a, ctas, 0, args, stream);
}
