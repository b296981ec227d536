// Kernel E, the one-shot all-to-all: each rank's buffer holds n chunks,
// chunk p addressed to rank p; afterwards chunk p of rank d's output is the
// chunk that rank p addressed to d (y[d][p] = x[p][d]). Two launchers share
// the kernel: `all_to_all` moves one buffer, `dispatch_a2a` moves the EP
// token payload and its [n*C, 2] int32 metadata (local expert id, valid)
// in the same launch.
//
// Replaces triton_dist_tpu/kernels/all_to_all.py `_a2a_pallas` (the
// pallas_call at :67, `_a2a_kernel` :35; reached by all_to_all,
// low_latency_all_to_all and ep_a2a.py combine_a2a) and
// triton_dist_tpu/kernels/ep_a2a.py `dispatch_a2a` (the pallas_call at
// :396, `_a2a_payload_kernel` :364). The chunks travel as raw words of the
// widest size that divides the chunk and every address (16, 8, 4, 2 or 1
// bytes), whatever the dtype, so the result is bitwise the exchange; the
// TPU kernels' lane and sublane padding is Mosaic's alignment and has no
// counterpart here.
//
// What bounds it: bytes. Each rank reads its n chunks once and writes each
// into its peer's output once; across cards (n-1)/n of them cross NVLink
// (tools/perf_model.py collective_sol_us "a2a"); four ranks emulated on one
// card move every byte through the card's memory.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks),
// entered through barrier_all (csrc/shmem.cuh), so no rank writes into an
// output that a peer still reads from its previous call; CTA g of every
// rank copies slice g of each chunk straight into the destination rank's
// output (one process allocates every rank's output and passes its
// address by value), destinations staggered from me + 1, then raises its
// flag `me` in every peer's pad and waits for CTA g of every source: the
// arrival of its slices.
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;

// chunk p of src (this rank's, cn words a chunk) -> chunk me of rank p's dst
template <typename W>
__device__ __forceinline__ void put_chunks(const CommArgs& a, const void* src_v,
                                           void* const* dst, long long cn) {
  const int me = my_pe(a);
  long long lo, hi;
  split(cn, lo, hi);
  const W* src = static_cast<const W*>(src_v);
  for (int s = 1; s <= a.n; ++s) {
    const int p = (me + s) % a.n;
    W* to = static_cast<W*>(dst[p]) + me * cn;
    const W* from = src + p * cn;
    for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) to[i] = from[i];
  }
}

// x: in -> out, cn words of W a chunk; meta (mn > 0): in2 -> out2, mn
// 8-byte words a chunk
template <typename W>
__global__ void __launch_bounds__(kThreads) a2a_kernel(CommArgs a, long long cn, long long mn) {
  const int me = my_pe(a);
  barrier_all(a);
  put_chunks<W>(a, a.in[me], a.out, cn);
  if (mn > 0) put_chunks<uint2>(a, a.in2[me], a.out2, mn);
  quiet();
  signal_all(a, kRegionA, me);
  wait_sources(a, kRegionA);
}

cudaError_t launch(const tdt::CommArgs& a, long long chunk_bytes, long long meta_bytes,
                   int ctas, cudaStream_t stream) {
  if (chunk_bytes < 0 || meta_bytes < 0 || meta_bytes % 8) return cudaErrorInvalidValue;
  for (int r = 0; r < a.n && meta_bytes; ++r)
    if (reinterpret_cast<uintptr_t>(a.in2[r]) % 8 || reinterpret_cast<uintptr_t>(a.out2[r]) % 8)
      return cudaErrorInvalidValue;
  if (chunk_bytes == 0 && meta_bytes == 0) return cudaSuccess;
  tdt::CommArgs args_v = a;
  const int w = tdt::word_bytes(a, chunk_bytes);
  long long cn = chunk_bytes / w, mn = meta_bytes / 8;
  void* args[] = {&args_v, &cn, &mn};
  switch (w) {
    case 16: return tdt::coop_launch(a2a_kernel<uint4>, a, ctas, 0, args, stream);
    case 8: return tdt::coop_launch(a2a_kernel<uint2>, a, ctas, 0, args, stream);
    case 4: return tdt::coop_launch(a2a_kernel<unsigned>, a, ctas, 0, args, stream);
    case 2: return tdt::coop_launch(a2a_kernel<unsigned short>, a, ctas, 0, args, stream);
    default: return tdt::coop_launch(a2a_kernel<unsigned char>, a, ctas, 0, args, stream);
  }
}

}  // namespace

cudaError_t tdt::all_to_all(const CommArgs& a, long long chunk_bytes, int ctas,
                            cudaStream_t stream) {
  return launch(a, chunk_bytes, 0, ctas, stream);
}

cudaError_t tdt::dispatch_a2a(const CommArgs& a, long long chunk_bytes, long long meta_bytes,
                              int ctas, cudaStream_t stream) {
  return launch(a, chunk_bytes, meta_bytes, ctas, stream);
}
