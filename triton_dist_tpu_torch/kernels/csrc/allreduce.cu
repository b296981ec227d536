// Kernel A, all_reduce: the sum over ranks of n partials [M, cols],
// replicated, one-shot or two-shot.
//
// Replaces triton_dist_tpu/kernels/allreduce.py `_ar_pallas` (the
// pallas_call at :198): `_one_shot_ar_kernel` (every rank puts its whole
// partial into slot me of every rank's landing buffer, [n, M, cols]; each
// sums the n slots in rank order in f32 and rounds once) and
// `_two_shot_ar_kernel` (a ring reduce-scatter into this rank's chunk of
// the output, then a ring all-gather of the reduced chunks through the
// outputs: tdt_shmem::ring_reduce_scatter then ring_all_gather, the device
// functions of kernels D and C, not a third copy). The sums and roundings
// are the Pallas kernels', so the result equals all_reduce_ref bitwise and
// every rank's copy is the same.
//
// What bounds it: bytes. On four cards the two-shot sends 2(n-1)/n of the
// tensor per rank over NVLink (collective_sol_us "ar"), the one-shot
// (n-1) times it; on one card every input is read once and every output
// written once through the card's memory.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all (csrc/shmem.cuh); CTA g owns slice g of the
// tensor (one-shot) or of each chunk (two-shot). The two phases of the
// two-shot need no barrier between them: the all-gather writes only
// chunks that their owners' reduce-scatter never touches.
#include "ring.cuh"

namespace {

using namespace tdt_shmem;

template <typename T>
__global__ void __launch_bounds__(kThreads) ar_one_shot(CommArgs a, long long nvec) {
  const int me = my_pe(a);
  long long lo, hi;
  split(nvec, lo, hi);
  barrier_all(a);
  const uint4* x = static_cast<const uint4*>(a.in[me]);
  for (int p = 0; p < a.n; ++p)
    putmem_nbi(static_cast<uint4*>(a.land[p]) + me * nvec, x, lo, hi);
  quiet();
  signal_all(a, kRegionA, me);
  wait_sources(a, kRegionA);
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    reduce_landed<T>(static_cast<uint4*>(a.out[me]), static_cast<const uint4*>(a.land[me]),
                     nvec, a.n, i);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ar_two_shot(CommArgs a, long long cvec) {
  const int me = my_pe(a);
  barrier_all(a);
  ring_reduce_scatter<T>(a, static_cast<const uint4*>(a.in[me]),
                         static_cast<uint4*>(a.out[me]) + me * cvec, cvec, kRegionA);
  ring_all_gather(a, cvec, kRegionB);
}

template <typename T>
cudaError_t launch(int method, const tdt::CommArgs& a, long long nvec, int ctas,
                   cudaStream_t stream) {
  tdt::CommArgs args_v = a;
  if (method == 0) {
    void* args[] = {&args_v, &nvec};
    return tdt::coop_launch(ar_one_shot<T>, a, ctas, 0, args, stream);
  }
  if (a.n < 2 || nvec % a.n) return cudaErrorInvalidValue;
  long long cvec = nvec / a.n;
  void* args[] = {&args_v, &cvec};
  return tdt::coop_launch(ar_two_shot<T>, a, ctas, 0, args, stream);
}

}  // namespace

cudaError_t tdt::all_reduce(int dtype, int method, const CommArgs& a, long long nvec, int ctas,
                            cudaStream_t stream) {
  if (nvec == 0) return cudaSuccess;
  if (dtype == kF32) return launch<float>(method, a, nvec, ctas, stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(method, a, nvec, ctas, stream);
  return cudaErrorInvalidValue;
}
