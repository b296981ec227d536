// Kernel D, reduce_scatter: n partials [M, cols] summed, rank r keeping rows
// [r*M/n, (r+1)*M/n), one-shot or ring.
//
// Replaces triton_dist_tpu/kernels/reduce_scatter.py `_rs_pallas` (the
// pallas_call at :192): `_one_shot_rs_kernel` (every rank puts its
// partial of chunk p into slot me of rank p's landing buffer; the owner
// sums the n landed chunks in rank order in f32 and rounds once) and
// `_ring_rs_kernel` (tdt_shmem::ring_reduce_scatter: a rounding at every
// hop, chunk c starting at rank c+1). The sums and roundings are the
// Pallas kernels', so the result equals reduce_scatter_ref bitwise.
//
// What bounds it: bytes. On four cards each rank sends (n-1)/n of its
// partial over NVLink (collective_sol_us "rs"); on one card every input
// is read once and every output written once through the card's memory.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all; CTA g owns slice g of each chunk. The
// landing buffers are symmetric (runtime/symm_mem.py): [n, M/n, cols]
// one-shot, [n-1, M/n, cols] ring (one slot per step, no credits).
#include "ring.cuh"

namespace {

using namespace tdt_shmem;

template <typename T>
__global__ void __launch_bounds__(kThreads) rs_one_shot(CommArgs a, long long cvec) {
  const int me = my_pe(a);
  long long lo, hi;
  split(cvec, lo, hi);
  barrier_all(a);
  const uint4* x = static_cast<const uint4*>(a.in[me]);
  for (int p = 0; p < a.n; ++p)
    putmem_nbi(static_cast<uint4*>(a.land[p]) + me * cvec, x + p * cvec, lo, hi);
  quiet();
  signal_all(a, kRegionA, me);
  wait_sources(a, kRegionA);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    reduce_landed<T>(static_cast<uint4*>(a.out[me]), static_cast<const uint4*>(a.land[me]),
                     cvec, a.n, i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) rs_ring(CommArgs a, long long cvec) {
  const int me = my_pe(a);
  barrier_all(a);
  ring_reduce_scatter<T>(a, static_cast<const uint4*>(a.in[me]), static_cast<uint4*>(a.out[me]),
                         cvec, kRegionA);
}

template <typename T>
cudaError_t launch(int method, const tdt::CommArgs& a, long long cvec, int ctas,
                   cudaStream_t stream) {
  tdt::CommArgs args_v = a;
  void* args[] = {&args_v, &cvec};
  return method == 0 ? tdt::coop_launch(rs_one_shot<T>, a, ctas, 0, args, stream)
                     : tdt::coop_launch(rs_ring<T>, a, ctas, 0, args, stream);
}

}  // namespace

cudaError_t tdt::reduce_scatter(int dtype, int method, const CommArgs& a, long long cvec,
                                int ctas, cudaStream_t stream) {
  if (cvec == 0) return cudaSuccess;
  if (method == 1 && a.n < 2) return cudaErrorInvalidValue;
  if (dtype == kF32) return launch<float>(method, a, cvec, ctas, stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(method, a, cvec, ctas, stream);
  return cudaErrorInvalidValue;
}
