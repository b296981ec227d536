// Kernel (row 26), sp_ring_attention(mode="ring_shmem"): one-kernel ring
// attention over sequence shards, the KV blocks rotating by neighbour puts
// under an online softmax.
//
// Replaces triton_dist_tpu/kernels/sp_attention.py `_ring_attn_shmem` (the
// pallas_call at :385, kernel `_ring_attn_kernel` at :220). Rank me holds
// the queries and keys of positions [me * s_loc, (me + 1) * s_loc), folded
// by kv head: q [X, rows, HD] (X = B * Hkv streams, rows = s_loc * rep, row
// r is position r / rep), k and v [X, s_loc, HD]. At ring step r = 0 .. n-1
// it holds the block of rank src = (me - r) mod n; its query tiles fold the
// block into their running (acc, m, l) with the causal mask by global
// position (key j of src attends query row r when j <= (me - src) * s_loc
// + r / rep; src > me contributes nothing), and meanwhile the block goes
// on into the right neighbour's landing slot (r + 1) % 2. A per-step flag
// says a block landed; a credit from the right neighbour says its slot is
// free again before it is overwritten two steps later. Returns the
// unnormalised (acc, m, l) in f32; the caller normalises, as in JAX.
//
// What bounds it: operations (QK^T and PV, 4 HD per causal query-key
// pair) at prefill lengths; bytes for a short shard.
//
// Design: one cooperative launch per device over (ctas, 1, local ranks), up
// to kCtasPerSm CTAs an SM, every CTA of every rank resident (the grid fits
// the card; coop_launch refuses one that does not), so waits on peers cannot
// deadlock: a step's waits depend only on a neighbour's earlier steps.
// Entered through barrier_all (csrc/shmem.cuh), so no put lands in a slot a
// peer still reads from the previous call. CTA g of every rank forwards the
// same slice of the block (16-byte vectors) and signals CTA g's flag of the
// step in the right neighbour's pad (region A); every CTA of the receiver
// waits for all the left neighbour's CTAs before it reads the slot, since
// each query tile reads the whole block. Credits go the other way (region
// B), once a rank's CTAs have consumed and forwarded a step's slot. Each CTA
// owns the same query tiles (kR rows of one stream) at every step and keeps
// their state in the f32 outputs between steps; within a tile the loop is
// flash_tile.cuh's: 32-key tiles staged in shared memory as f32, lane j
// owning key j for QK^T, P broadcast by shuffles for PV, P rounded to the
// input dtype before PV, plain FMA. Landed blocks are read through L2
// (ld.global.cg): a slot is read again two steps later with new data.
#include "shmem.cuh"

namespace {

using namespace tdt_shmem;
using tdt::RingAttnArgs;

constexpr int kWarps = kThreads / 32;
constexpr int kCtasPerSm = 4;         // CTAs an SM, where the occupancy allows
constexpr int kRPW = 2;               // query rows per warp
constexpr int kR = kWarps * kRPW;     // query rows per tile
constexpr int kBT = 32;               // keys per tile == warp width

template <typename T>
__device__ __forceinline__ void load16_cg(const T* p, float* out) {
  const uint4 raw = __ldcg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::n; ++i) out[i] = to_f<T>(e[i]);
}

// every CTA of the rank waits until all gridDim.x CTAs of a peer raised
// `slot` of `region` in this rank's pad
__device__ __forceinline__ void wait_step(const tdt::CommArgs& a, int region, int slot) {
  if (threadIdx.x == 0) {
    const unsigned* pad = a.sig[my_pe(a)] + region + slot * gridDim.x;
    for (int g = 0; g < gridDim.x; ++g) signal_wait_until(pad + g, a.epoch);
  }
  __syncthreads();
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) ring_attn_kernel(RingAttnArgs ra) {
  constexpr int DPL = HD / 32;
  constexpr int VN = Vec16<T>::n;
  __shared__ __align__(16) float q_s[kR][HD];
  __shared__ float k_s[kBT][HD + 1];  // +1: lane j reads row j without bank conflicts
  __shared__ float v_s[kBT][HD];

  const tdt::CommArgs& a = ra.c;
  const int me = my_pe(a);
  int left, right;
  ring_neighbors(a, left, right);
  const int X = ra.X, rows = ra.rows, s_loc = ra.s_loc, rep = ra.rep;
  const long long blk = static_cast<long long>(X) * s_loc * HD;  // elements of a block
  const int nrb = (rows + kR - 1) / kR;
  const long long tiles = static_cast<long long>(X) * nrb;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* q = static_cast<const T*>(a.in[me]);
  float* acc_o = static_cast<float*>(a.out[me]);
  float* m_o = ra.m[me];
  float* l_o = ra.l[me];
  long long vlo, vhi;
  split(blk / VN, vlo, vhi);

  barrier_all(a);
  for (int r = 0; r < a.n; ++r) {
    const int src = (me - r + a.n) % a.n;
    const int cur = r % 2, nxt = (r + 1) % 2;
    const T* kb = r == 0 ? static_cast<const T*>(a.in2[me])
                         : static_cast<const T*>(a.land[me]) + cur * blk;
    const T* vb = r == 0 ? static_cast<const T*>(ra.v[me])
                         : static_cast<const T*>(ra.land_v[me]) + cur * blk;
    if (r >= 1) wait_step(a, kRegionA, r - 1);  // the block of step r landed
    if (r < a.n - 1) {
      // the right neighbour read slot nxt at its step r - 1
      if (r >= 2) wait_step(a, kRegionB, r - 1);
      putmem_nbi(reinterpret_cast<uint4*>(static_cast<T*>(a.land[right]) + nxt * blk),
                 reinterpret_cast<const uint4*>(kb), vlo, vhi);
      putmem_nbi(reinterpret_cast<uint4*>(static_cast<T*>(ra.land_v[right]) + nxt * blk),
                 reinterpret_cast<const uint4*>(vb), vlo, vhi);
      quiet();
      if (tid == 0) signal_op(flag(a.sig[right], kRegionA, r), a.epoch);
    }
    // keys of this block that any query may see, and query row 0's frontier
    const int valid = ra.causal ? (src <= me ? s_loc : 0) : s_loc;
    const int q_off = ra.causal ? (me - src) * s_loc : s_loc - 1;
    for (long long t = blockIdx.x; valid > 0 && t < tiles; t += gridDim.x) {
      const int x = static_cast<int>(t / nrb);
      const int r0 = static_cast<int>(t % nrb) * kR;
      const int walk_end = min(valid, q_off + (min(r0 + kR, rows) - 1) / rep + 1);
      __syncthreads();  // the previous tile is consumed
      for (int idx = tid; idx < kR * HD; idx += kThreads) {
        const int rr = idx / HD, c = idx % HD, row = r0 + rr;
        q_s[rr][c] = row < rows ? to_f<T>(q[(static_cast<long long>(x) * rows + row) * HD + c])
                                : 0.f;
      }
      const int wr0 = r0 + warp * kRPW;
      const int w_last = min(wr0 + kRPW, rows) - 1;
      const int w_front = w_last >= wr0 ? q_off + w_last / rep : -1;
      float m[kRPW], l[kRPW], acc[kRPW][DPL];
#pragma unroll
      for (int i = 0; i < kRPW; ++i) {
        const int row = wr0 + i;
        const long long xr = static_cast<long long>(x) * rows + row;
        const bool load = r > 0 && row < rows;
        m[i] = load ? m_o[xr] : -1e30f;
        l[i] = load ? l_o[xr] : 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = load ? acc_o[xr * HD + lane + 32 * e] : 0.f;
      }
      for (int t0 = 0; t0 < walk_end; t0 += kBT) {
        __syncthreads();  // q_s staged, the previous key tile consumed
        for (int idx = tid; idx < kBT * (HD / VN); idx += kThreads) {
          const int j = idx / (HD / VN), c0 = (idx % (HD / VN)) * VN;
          float kf[VN], vf[VN];
          if (t0 + j < walk_end) {
            const long long off = (static_cast<long long>(x) * s_loc + t0 + j) * HD + c0;
            load16_cg<T>(kb + off, kf);
            load16_cg<T>(vb + off, vf);
          } else {
#pragma unroll
            for (int e = 0; e < VN; ++e) kf[e] = vf[e] = 0.f;
          }
#pragma unroll
          for (int e = 0; e < VN; ++e) {
            k_s[j][c0 + e] = kf[e];
            v_s[j][c0 + e] = vf[e];
          }
        }
        __syncthreads();
        if (t0 > w_front) continue;  // every row of this warp lies before the tile
        const int j = t0 + lane;
        float dot[kRPW];
#pragma unroll
        for (int i = 0; i < kRPW; ++i) dot[i] = 0.f;
#pragma unroll 8
        for (int c = 0; c < HD; c += 4) {
          const float k0 = k_s[lane][c], k1 = k_s[lane][c + 1];
          const float k2 = k_s[lane][c + 2], k3 = k_s[lane][c + 3];
#pragma unroll
          for (int i = 0; i < kRPW; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(&q_s[warp * kRPW + i][c]);
            dot[i] = fmaf(qv.x, k0, dot[i]);
            dot[i] = fmaf(qv.y, k1, dot[i]);
            dot[i] = fmaf(qv.z, k2, dot[i]);
            dot[i] = fmaf(qv.w, k3, dot[i]);
          }
        }
        float p[kRPW];
#pragma unroll
        for (int i = 0; i < kRPW; ++i) {
          const int row = wr0 + i;
          const bool ok = row < rows && j < walk_end && j <= q_off + row / rep;
          const float s = dot[i] * ra.scale;
          const float m_new = fmaxf(m[i], warp_max(ok ? s : -1e30f));
          const float alpha = expf(m[i] - m_new);
          const float pi = ok ? expf(s - m_new) : 0.f;
          l[i] = l[i] * alpha + warp_sum(pi);
          p[i] = round_to<T>(pi);
          m[i] = m_new;
#pragma unroll
          for (int e = 0; e < DPL; ++e) acc[i][e] *= alpha;
        }
#pragma unroll 4
        for (int jj = 0; jj < kBT; ++jj) {
          float vv[DPL];
#pragma unroll
          for (int e = 0; e < DPL; ++e) vv[e] = v_s[jj][lane + 32 * e];
#pragma unroll
          for (int i = 0; i < kRPW; ++i) {
            const float pj = __shfl_sync(0xffffffffu, p[i], jj);
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pj, vv[e], acc[i][e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRPW; ++i) {
        const int row = wr0 + i;
        if (row >= rows) break;
        const long long xr = static_cast<long long>(x) * rows + row;
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc_o[xr * HD + lane + 32 * e] = acc[i][e];
        if (lane == 0) {
          m_o[xr] = m[i];
          l_o[xr] = l[i];
        }
      }
    }
    if (r >= 1 && r <= a.n - 3) {
      // this step's slot is consumed and forwarded: the left neighbour may
      // overwrite it at its step r + 1
      __syncthreads();
      if (tid == 0) signal_op(flag(a.sig[left], kRegionB, r), a.epoch);
    }
  }
}

// ctas: CTAs a rank at one an SM; the tile loop hides its shared-memory
// latency with more warps, so each rank takes up to kCtasPerSm times as
// many, as far as the occupancy lets every CTA of the grid be resident
template <typename T, int HD>
cudaError_t launch_hd(const RingAttnArgs& r, int ctas, cudaStream_t stream) {
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, ring_attn_kernel<T, HD>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const int g = min(kMaxCtas, ctas * max(1, min(per_sm, kCtasPerSm)));
  RingAttnArgs args_v = r;
  void* args[] = {&args_v};
  return tdt::coop_launch(ring_attn_kernel<T, HD>, r.c, g, 0, args, stream);
}

template <typename T>
cudaError_t launch(int HD, const RingAttnArgs& r, int ctas, cudaStream_t stream) {
  if (HD == 128) return launch_hd<T, 128>(r, ctas, stream);
  if (HD == 64) return launch_hd<T, 64>(r, ctas, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t tdt::ring_attn(int dtype, int HD, const RingAttnArgs& r, int ctas,
                           cudaStream_t stream) {
  if (r.X < 1 || r.rows < 1 || r.s_loc < 1 || r.rep < 1 || r.rows != r.s_loc * r.rep ||
      (static_cast<long long>(r.X) * r.s_loc * HD) % 8)
    return cudaErrorInvalidValue;
  if (dtype == kF32) return launch<float>(HD, r, ctas, stream);
  if (dtype == kBF16) return launch<__nv_bfloat16>(HD, r, ctas, stream);
  return cudaErrorInvalidValue;
}
