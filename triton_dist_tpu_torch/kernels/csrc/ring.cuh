// The two rings of the port's collectives, as device functions: the ring
// all-gather of allgather.cu (kernel C) and the ring reduce-scatter of
// reduce_scatter.cu (kernel D). allreduce.cu's two-shot method (kernel A)
// is the second followed by the first, from these same functions.
//
// Counterparts of triton_dist_tpu/kernels/allgather.py `_ring_kernel` and
// reduce_scatter.py `_ring_rs_kernel` (and so of allreduce.py
// `_two_shot_ar_kernel`, their fusion). The data is n chunks of `cvec`
// 16-byte vectors; CTA g of every rank owns the same slice of each chunk
// (tdt_shmem::split) and signals and waits for CTA g of its neighbours.
//
// Where the Pallas kernels double-buffer their landing slots and throttle
// them with credit semaphores (a TPU's HBM scratch is an extra output of
// the call), the reduce-scatter here lands step s of the ring in its own
// slot s of an (n - 1)-slot buffer: every slot is written once per call,
// so no credit is needed. The sums and roundings are the Pallas ones:
// chunk c starts as rank c+1's partial, and every hop adds the local
// partial in f32 and rounds to the dtype, ending at rank c.
#pragma once

#include "shmem.cuh"

namespace tdt_shmem {

// The ring all-gather: chunk me of out[me] holds this rank's data (this
// CTA's slice written by this CTA, or by an earlier call of the grid); on
// return every chunk of out[me] does. Step s forwards chunk (me - s) % n,
// the one that arrived at step s - 1, to the right neighbour's out.
__device__ __forceinline__ void ring_all_gather(const CommArgs& a, long long cvec, int region) {
  const int me = my_pe(a);
  int left, right;
  ring_neighbors(a, left, right);
  long long lo, hi;
  split(cvec, lo, hi);
  for (int s = 0; s < a.n - 1; ++s) {
    const int src = (me - s + a.n) % a.n;
    putmem_nbi(static_cast<uint4*>(a.out[right]) + src * cvec,
               static_cast<const uint4*>(a.out[me]) + src * cvec, lo, hi);
    quiet();
    if (threadIdx.x == 0) {
      signal_op(flag(a.sig[right], region, s), a.epoch);
      signal_wait_until(flag(a.sig[me], region, s), a.epoch);  // chunk (me-s-1) % n
    }
    __syncthreads();
  }
}

// The ring reduce-scatter of x (n chunks) into dst (one chunk, local):
// dst = the sum of every rank's chunk me, rounded to T at every hop.
// a.land[r] holds n - 1 slots of cvec vectors.
template <typename T>
__device__ __forceinline__ void ring_reduce_scatter(const CommArgs& a, const uint4* x, uint4* dst,
                                                    long long cvec, int region) {
  const int me = my_pe(a);
  int left, right;
  ring_neighbors(a, left, right);
  long long lo, hi;
  split(cvec, lo, hi);
  uint4* land_right = static_cast<uint4*>(a.land[right]);
  const uint4* land_me = static_cast<const uint4*>(a.land[me]);
  for (int s = 0; s < a.n - 1; ++s) {
    const int c = (me - s - 1 + 2 * a.n) % a.n;
    uint4* to = land_right + s * cvec;
    if (s == 0) {
      putmem_nbi(to, x + c * cvec, lo, hi);      // the plain local partial
    } else {
      if (threadIdx.x == 0) signal_wait_until(flag(a.sig[me], region, s - 1), a.epoch);
      __syncthreads();
      const uint4* from = land_me + (s - 1) * cvec;
      for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
        to[i] = add_round<T>(ld_peer(from + i), ld_peer(x + c * cvec + i));
    }
    quiet();
    if (threadIdx.x == 0) signal_op(flag(a.sig[right], region, s), a.epoch);
  }
  if (threadIdx.x == 0) signal_wait_until(flag(a.sig[me], region, a.n - 2), a.epoch);
  __syncthreads();
  const uint4* from = land_me + (a.n - 2) * cvec;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    dst[i] = add_round<T>(ld_peer(from + i), ld_peer(x + me * cvec + i));
}

}  // namespace tdt_shmem
