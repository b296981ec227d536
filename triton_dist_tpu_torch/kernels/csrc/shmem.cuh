// The device side of the port's one-sided communication: counterpart of
// triton_dist_tpu/language/shmem_device.py (`my_pe`, `n_pes`,
// `ring_neighbors`, `putmem_nbi`, `signal_op`, `signal_wait_until`,
// `quiet`, `barrier_all`) under the same names, plus the launch and data
// partition the collectives share.
//
// One launch per distinct device covers the ranks it holds: blockIdx.z is
// the local rank, so my_pe = CommArgs::first_rank + blockIdx.z, and the
// device code is the same on one card (four ranks in one grid) and on
// four (one each). Every rank's CTA g owns the same slice of the data
// (split), so CTA g of a rank signals and waits for CTA g of its peers
// only. The launch is cooperative (cudaLaunchCooperativeKernel), which
// refuses a grid whose CTAs cannot all be resident at once: on one card
// a rank that waits on a peer whose CTAs were never scheduled would hang.
//
// Memory model. A put is a vectorised copy into a peer's buffer through
// its device pointer (peer access over NVLink between cards, a plain
// pointer on one card). A signal is __threadfence_system() then
// atomicMax_system of the call's epoch into the flag: every store the
// CTA made before it is visible to the system before the flag, and a
// flag never goes back to an older epoch. A wait is one thread's
// ld.acquire.sys loop until the flag reaches the epoch, then
// __syncthreads; data a peer wrote is read with ld.global.cg (through L2,
// never a stale L1 line, since a ring reads one buffer at several steps).
// Every spin traps after kSpinTimeoutNs of global time, so a lost signal
// fails the launch instead of hanging the card.
//
// Epochs (runtime/bootstrap.py Mesh.next_epoch): flags are zeroed once and
// compared with the call's epoch, never reset. Every collective enters
// through barrier_all: rank r's first CTA raises its flag in every peer's
// pad, and every CTA waits for all n flags before it writes into a peer,
// so no rank overwrites a landing buffer, or an output, that a peer still
// reads from the previous call (kernels of one device run in stream
// order, so a rank's flag means all its earlier work is done).
#pragma once

#include "common.cuh"

namespace tdt_shmem {

using tdt::CommArgs;
using tdt::kMaxRanks;

constexpr int kThreads = 256;
constexpr int kMaxCtas = 256;                     // per rank
constexpr int kBarrier = 0;                       // slots [0, kMaxRanks)
constexpr int kRegionA = 64;                      // kMaxRanks * kMaxCtas flags
constexpr int kRegionB = kRegionA + kMaxRanks * kMaxCtas;
constexpr int kRegionC = kRegionB + kMaxRanks * kMaxCtas;
constexpr long long kSpinTimeoutNs = 20ll * 1000 * 1000 * 1000;

__device__ __forceinline__ int my_pe(const CommArgs& a) { return a.first_rank + blockIdx.z; }
__device__ __forceinline__ int n_pes(const CommArgs& a) { return a.n; }
__device__ __forceinline__ void ring_neighbors(const CommArgs& a, int& left, int& right) {
  const int me = my_pe(a);
  left = (me + a.n - 1) % a.n;
  right = (me + 1) % a.n;
}

// CTA g's half-open range [lo, hi) of `count` items
__device__ __forceinline__ void split(long long count, long long& lo, long long& hi) {
  const long long per = (count + gridDim.x - 1) / gridDim.x;
  lo = min(count, per * blockIdx.x);
  hi = min(count, lo + per);
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// a peer-written 16-byte vector, through L2
__device__ __forceinline__ uint4 ld_peer(const uint4* p) { return __ldcg(p); }

// the CTA's threads copy vectors [lo, hi) of src to dst (dst may be a
// peer's buffer); completion is only guaranteed by quiet()
__device__ __forceinline__ void putmem_nbi(uint4* dst, const uint4* src, long long lo,
                                           long long hi) {
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x) dst[i] = ld_peer(src + i);
}

// every store this CTA made is visible to the system, and every thread
// of the CTA has made its stores
__device__ __forceinline__ void quiet() {
  __threadfence_system();
  __syncthreads();
}

// one thread: raise `flag` (a peer's or our own) to the epoch
__device__ __forceinline__ void signal_op(unsigned* flag, unsigned epoch) {
  __threadfence_system();
  atomicMax_system(flag, epoch);
}

// one thread: wait until `flag` reaches the epoch; traps after the bound
__device__ __forceinline__ void signal_wait_until(const unsigned* flag, unsigned epoch) {
  if (ld_acquire(flag) >= epoch) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(flag) < epoch) {
    __nanosleep(64);
    if (global_ns() - t0 > kSpinTimeoutNs) __trap();  // a peer never signalled
  }
}

// the CTA waits for flags[src * stride] >= epoch for every rank src
__device__ __forceinline__ void wait_all(const CommArgs& a, const unsigned* flags, int stride) {
  if (threadIdx.x == 0)
    for (int src = 0; src < a.n; ++src) signal_wait_until(flags + src * stride, a.epoch);
  __syncthreads();
}

// the epoch barrier every collective enters through (see the header)
__device__ __forceinline__ void barrier_all(const CommArgs& a) {
  const int me = my_pe(a);
  if (threadIdx.x == 0 && blockIdx.x == 0)
    for (int p = 0; p < a.n; ++p) signal_op(a.sig[p] + kBarrier + me, a.epoch);
  wait_all(a, a.sig[me] + kBarrier, 1);
}

// The rank's CTAs wait for one another (every store each made before it is
// visible to all after it): each raises its own flag in the rank's pad at
// `region`, then waits for all gridDim.x of them. It holds a kernel whose
// CTA g reads what other CTAs of its rank wrote or received (ag_gemm.cu's
// tiles over the gathered A, gemm_rs.cu's ring slices over the tiles).
__device__ __forceinline__ void rank_barrier(const CommArgs& a, int region) {
  unsigned* pad = a.sig[my_pe(a)] + region;
  quiet();
  if (threadIdx.x == 0) {
    signal_op(pad + blockIdx.x, a.epoch);
    for (int g = 0; g < gridDim.x; ++g) signal_wait_until(pad + g, a.epoch);
  }
  __syncthreads();
}

// this CTA's data flag for `slot` (a source rank or a ring step) in a region
__device__ __forceinline__ unsigned* flag(unsigned* pad, int region, int slot) {
  return pad + region + slot * gridDim.x + blockIdx.x;
}

// signal every peer's flag `slot` of this CTA after a quiet()
__device__ __forceinline__ void signal_all(const CommArgs& a, int region, int slot) {
  if (threadIdx.x == 0)
    for (int p = 0; p < a.n; ++p) signal_op(flag(a.sig[p], region, slot), a.epoch);
}

// the CTA waits for its flags of every source rank in a region
__device__ __forceinline__ void wait_sources(const CommArgs& a, int region) {
  wait_all(a, flag(a.sig[my_pe(a)], region, 0), gridDim.x);
}

// one thread: wait until every CTA of rank `src` has signalled this
// rank's flags `src` of a region (signal_all(a, region, src) by each)
__device__ __forceinline__ void signal_wait_rank(const CommArgs& a, int region, int src) {
  const unsigned* pad = a.sig[my_pe(a)] + region + src * gridDim.x;
  for (int g = 0; g < gridDim.x; ++g) signal_wait_until(pad + g, a.epoch);
}

// f32 sum of 16-byte vector i of n landed contributions (land + src *
// stride), in rank order, rounded once to T and stored at dst
template <typename T>
__device__ __forceinline__ void reduce_landed(uint4* dst, const uint4* land, long long stride,
                                              int n, long long i) {
  constexpr int V = Vec16<T>::n;
  float acc[V], v[V];
  uint4 raw = ld_peer(land + i);
  load16<T>(reinterpret_cast<const T*>(&raw), acc);
  for (int s = 1; s < n; ++s) {
    raw = ld_peer(land + s * stride + i);
    load16<T>(reinterpret_cast<const T*>(&raw), v);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] += v[e];
  }
  store16<T>(reinterpret_cast<T*>(dst + i), acc);
}

// (f32(x) + f32(y)) rounded to T, for two 16-byte vectors
template <typename T> __device__ __forceinline__ uint4 add_round(uint4 x, uint4 y) {
  constexpr int V = Vec16<T>::n;
  float a[V], b[V];
  load16<T>(reinterpret_cast<const T*>(&x), a);
  load16<T>(reinterpret_cast<const T*>(&y), b);
#pragma unroll
  for (int e = 0; e < V; ++e) a[e] += b[e];
  uint4 out;
  store16<T>(reinterpret_cast<T*>(&out), a);
  return out;
}

}  // namespace tdt_shmem

namespace tdt {

// Whether (kernel, device) is recorded, recording it when `record`: the
// large shared-memory attribute is set once per kernel and device, not at
// every launch.
inline bool attr_set(const void* fn, int dev, bool record) {
  static const void* fns[64];
  static int devs[64];
  static int count = 0;
  for (int i = 0; i < count; ++i)
    if (fns[i] == fn && devs[i] == dev) return true;
  if (record && count < 64) {
    fns[count] = fn;
    devs[count] = dev;
    ++count;
  }
  return false;
}

// the widest word (16, 8, 4, 2, 1 bytes) dividing `bytes` and every rank's
// input and output address: the raw-byte movers (a2a.cu, p2p.cu) copy in it
inline int word_bytes(const CommArgs& a, long long bytes) {
  for (int w = 16; w > 1; w >>= 1) {
    bool ok = bytes % w == 0;
    for (int r = 0; r < a.n && ok; ++r)
      ok = reinterpret_cast<uintptr_t>(a.in[r]) % w == 0 &&
           reinterpret_cast<uintptr_t>(a.out[r]) % w == 0;
    if (ok) return w;
  }
  return 1;
}

// A cooperative launch of `kernel` over (ctas, 1, n_local) CTAs of
// tdt_shmem::kThreads threads; cudaErrorInvalidValue for a grid the pad's
// layout cannot hold, and the runtime's cudaErrorCooperativeLaunchTooLarge
// where the CTAs cannot all be resident.
template <typename Kernel>
cudaError_t coop_launch(Kernel kernel, const CommArgs& a, int ctas, int smem, void** args,
                        cudaStream_t stream) {
  if (ctas < 1 || ctas > tdt_shmem::kMaxCtas || a.n < 1 || a.n > kMaxRanks ||
      a.n_local < 1 || a.first_rank + a.n_local > a.n)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const void* fn = reinterpret_cast<const void*>(kernel);
    if (!attr_set(fn, dev, false)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      attr_set(fn, dev, true);
    }
  }
  const dim3 grid(ctas, 1, a.n_local);
  cudaError_t err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                                dim3(tdt_shmem::kThreads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace tdt
