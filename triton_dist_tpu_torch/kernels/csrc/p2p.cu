// Kernel (row 17), p2p_shift: the cyclic neighbour put. Rank r's buffer
// lands in rank (r + 1) % n's output ((r - 1) % n when reverse), raw
// bytes: the stage handoff of the pipeline (layers/pp.py PPipeline) and
// each hop of p2p_push_pages (kernels/p2p.py).
//
// Replaces triton_dist_tpu/kernels/p2p.py `_p2p_pallas` (the pallas_call
// at :48, `_p2p_shift_kernel` :30): a barrier, one put into the
// neighbour, the wait for the rank's own arrival. The buffer travels as
// raw words of the widest size that divides its bytes and every address
// (16, 8, 4, 2 or 1 bytes), whatever the dtype, so the result is bitwise
// the input.
//
// What bounds it: bytes. Each rank reads its buffer once and writes it
// once into its neighbour's output: on one card 2 B bytes of the card's
// memory a rank, across cards B bytes over NVLink a rank, every rank
// sending at once over its own link.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all (csrc/shmem.cuh): the neighbour has reached
// this call, so its stream is done with whatever its output's memory held
// before. CTA g copies slice g of the buffer straight into the
// neighbour's output (the one process passes its address by value),
// raises its flag `me` there (region A) and waits for CTA g of its own
// source, so the launch ends on a device only once every slice of its
// ranks' outputs has landed.
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;

template <typename W>
__global__ void __launch_bounds__(kThreads) p2p_kernel(CommArgs a, long long nw, int reverse) {
  const int me = my_pe(a);
  const int dst = (me + (reverse ? a.n - 1 : 1)) % a.n;
  const int src = (me + (reverse ? 1 : a.n - 1)) % a.n;
  barrier_all(a);
  long long lo, hi;
  split(nw, lo, hi);
  const W* from = static_cast<const W*>(a.in[me]);
  W* to = static_cast<W*>(a.out[dst]);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) to[i] = from[i];
  quiet();
  if (threadIdx.x == 0) {
    signal_op(flag(a.sig[dst], kRegionA, me), a.epoch);
    signal_wait_until(flag(a.sig[me], kRegionA, src), a.epoch);
  }
  __syncthreads();
}

}  // namespace

cudaError_t tdt::p2p_shift(const CommArgs& a, long long bytes, int reverse, int ctas,
                           cudaStream_t stream) {
  if (bytes < 0 || a.n < 2) return cudaErrorInvalidValue;
  if (bytes == 0) return cudaSuccess;
  tdt::CommArgs args_v = a;
  const int w = tdt::word_bytes(a, bytes);
  long long nw = bytes / w;
  void* args[] = {&args_v, &nw, &reverse};
  switch (w) {
    case 16: return tdt::coop_launch(p2p_kernel<uint4>, a, ctas, 0, args, stream);
    case 8: return tdt::coop_launch(p2p_kernel<uint2>, a, ctas, 0, args, stream);
    case 4: return tdt::coop_launch(p2p_kernel<unsigned>, a, ctas, 0, args, stream);
    case 2: return tdt::coop_launch(p2p_kernel<unsigned short>, a, ctas, 0, args, stream);
    default: return tdt::coop_launch(p2p_kernel<unsigned char>, a, ctas, 0, args, stream);
  }
}
