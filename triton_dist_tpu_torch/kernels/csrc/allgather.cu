// Kernel C, all_gather: each rank's [m, cols] shard gathered to [n*m, cols]
// on every rank, one-shot or ring.
//
// Replaces triton_dist_tpu/kernels/allgather.py `_ag_pallas` (the
// pallas_call at :119): `_one_shot_kernel` (every rank puts its shard into
// slot me of every rank's output) and `_ring_kernel` (n - 1 neighbour
// steps, tdt_shmem::ring_all_gather). The shards travel as 16-byte
// vectors, whatever the dtype; the result is bitwise the concatenation.
//
// What bounds it: bytes. On four cards each rank sends (n-1)/n of the
// gathered tensor over NVLink (tools/perf_model.py collective_sol_us "ag");
// four ranks emulated on one card move every byte through the card's
// memory (each input read once, each output written once).
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all (csrc/shmem.cuh); CTA g owns slice g of each
// shard. Outputs are written in place on the peers: one process allocates
// every rank's output, and the kernel takes their addresses by value.
#include "ring.cuh"

namespace {

using namespace tdt_shmem;

__global__ void __launch_bounds__(kThreads) ag_one_shot(CommArgs a, long long svec) {
  const int me = my_pe(a);
  long long lo, hi;
  split(svec, lo, hi);
  barrier_all(a);
  const uint4* x = static_cast<const uint4*>(a.in[me]);
  for (int p = 0; p < a.n; ++p)
    putmem_nbi(static_cast<uint4*>(a.out[p]) + me * svec, x, lo, hi);
  quiet();
  signal_all(a, kRegionA, me);
  wait_sources(a, kRegionA);
}

__global__ void __launch_bounds__(kThreads) ag_ring(CommArgs a, long long svec) {
  const int me = my_pe(a);
  long long lo, hi;
  split(svec, lo, hi);
  // the local chunk first: only this rank's CTA g reads it back
  putmem_nbi(static_cast<uint4*>(a.out[me]) + me * svec, static_cast<const uint4*>(a.in[me]),
             lo, hi);
  barrier_all(a);
  ring_all_gather(a, svec, kRegionA);
}

}  // namespace

cudaError_t tdt::all_gather(int method, const CommArgs& a, long long svec, int ctas,
                            cudaStream_t stream) {
  CommArgs args_v = a;
  void* args[] = {&args_v, &svec};
  if (svec == 0) return cudaSuccess;
  return method == 0 ? coop_launch(ag_one_shot, a, ctas, 0, args, stream)
                     : coop_launch(ag_ring, a, ctas, 0, args, stream);
}
