// The flash-attention backward of the training path: dq, and dk with dv.
//
// Replaces the two TPU kernels of triton_dist_tpu/kernels/flash_attn_train.py
// `_flash_bwd_call`: `_dq_kernel` (the pallas_call at :266) and
// `_dkdv_kernel` (the pallas_call at :283). Same contract, in the folded
// GQA layout, all contiguous:
//   q, do, dq [X, R, d] (X = B * Hkv streams, R = S * rep rows: row r of a
//   stream is query position q_off + r / rep of its kv group); k, v, dk, dv
//   [X, T, d]; lse and D = rowsum(dO * O) [X, R] f32.
// Row r attends key t iff t <= q_off + r / rep and t < min(valid_len, T);
// valid_len and q_off are run-time arguments, as the TPU kernels' scalar
// prefetch, so the sequence-parallel ring backward can reuse both kernels
// for every (query block, KV block) pair.
//
// The recompute formula, with the TPU kernels' roundings:
//   s = scale * q.k (f32),  p = exp(s - lse) (masked to 0),
//   dp = do.v (f32),  ds = p * (dp - D),
//   dq = scale * sum_t round(ds) k,  dv = sum_r round(p) do,
//   dk = scale * sum_r round(ds) q,
// where round() is to the input dtype (bf16 or f32), every sum is in f32,
// and the outputs are rounded once to the input dtype.
//
// What bounds it on an H100: at the training shape (X = 32, R = 2048,
// T = 1024, d = 128, causal) the two kernels do ~60 GFLOP a layer against
// ~40 MB of inputs and outputs, so operations bound the work; this design
// runs them on the FMA units (plain f32 FMA, as flash_tile.cuh), not the
// tensor cores, so it runs far from that bound (PERF.md has its times).
//
// Design. Both kernels walk the causal triangle from one side, as the
// TPU grids do with their innermost axis; a loop inside the CTA takes the
// place of that sequential axis, so nothing is carried between CTAs and no
// atomics are used: every output element is summed by one thread in one
// fixed order, and the rep query heads of a kv group are rows of one
// stream, so dk/dv sum over the group by construction.
//   dq: one CTA per (stream, 16 query rows), 4 warps of 4 rows. It walks
//     32-key tiles of K and V (staged in shared memory, f32) up to the
//     block's causal frontier. Lane j owns key j of the tile for the two
//     dot products (s and dp); ds is then broadcast by shuffles for the dq
//     product, whose output dims c = lane + 32 * e sit in the lane's
//     registers (the PV loop of flash_tile.cuh).
//   dk/dv: one CTA per (stream, 16 keys), 4 warps of 4 keys, those keys'
//     K and V rows staged once. It walks 32-row blocks of q, do, lse and D
//     from the first row that can see its first key to R. Lane i owns
//     query row i of the block for the dot products; p and ds are
//     broadcast by shuffles for the dv and dk products.
// Both keep their operand tiles in dynamic shared memory (49 KB at
// d = 128), rows that lanes read across padded by one float so that the
// 32 lanes hit 32 banks. A warp whose rows (keys) lie wholly outside the
// tile's causal band skips its arithmetic, as the TPU kernels skip a
// masked tile.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;  // keys (dq) or query rows (dk/dv) per step: one per lane
constexpr int kPer = 4;    // rows (dq) or keys (dk/dv) per warp
constexpr int kBlock = kWarps * kPer;  // rows (dq) or keys (dk/dv) per CTA

// floats of dynamic shared memory: two [kBlock][HD] tiles and two padded
// [kTile][HD + 1] tiles (+ lse and D of the tile's rows for dk/dv)
template <int HD> constexpr int smem_floats() {
  return 2 * kBlock * HD + 2 * kTile * (HD + 1) + 2 * kTile;
}

// rows [r0, r0 + n) of a [*, HD] array (row r at src + r * HD) into a
// shared tile with row stride LD, rows past `limit` zero
template <typename T, int HD, int LD>
__device__ void stage(float* dst, const T* src, int r0, int n, int limit) {
  constexpr int VN = Vec16<T>::n;
  for (int idx = threadIdx.x; idx < n * (HD / VN); idx += kThreads) {
    const int rr = idx / (HD / VN), c0 = (idx % (HD / VN)) * VN;
    float vals[VN];
    if (r0 + rr < limit) {
      load16<T>(src + static_cast<long long>(r0 + rr) * HD + c0, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[rr * LD + c0 + e] = vals[e];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq, int R, int T_,
                    int rep, int valid_len, int q_off, float scale, int fault) {
  constexpr int DPL = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                    // [kBlock][HD]
  float* do_s = q_s + kBlock * HD;      // [kBlock][HD]
  float* k_s = do_s + kBlock * HD;      // [kTile][HD + 1]
  float* v_s = k_s + kTile * (HD + 1);  // [kTile][HD + 1]

  const int x = blockIdx.x;
  const int r0 = blockIdx.y * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long xr = static_cast<long long>(x) * R;
  const T* kx = k + static_cast<long long>(x) * T_ * HD;
  const T* vx = v + static_cast<long long>(x) * T_ * HD;

  stage<T, HD, HD>(q_s, q + xr * HD, r0, kBlock, R);
  stage<T, HD, HD>(do_s, dout + xr * HD, r0, kBlock, R);

  const int lim = min(valid_len, T_);
  const int last_row = min(r0 + kBlock, R) - 1;
  const int walk_end = min(lim, q_off + last_row / rep + 1);
  // planted fault 1 (tools/fault_margin.py --train): stop one tile short
  const int stop = fault == 1 ? (walk_end - 1) / kTile * kTile : walk_end;

  const int wr0 = r0 + warp * kPer;
  const int w_last = min(wr0 + kPer, R) - 1;
  const int w_front = w_last >= wr0 ? q_off + w_last / rep : -1;
  float lse_r[kPer], d_r[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = min(wr0 + i, R - 1);
    lse_r[i] = lse[xr + r];
    d_r[i] = dvec[xr + r];
  }
  float acc[kPer][DPL];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;

  for (int t0 = 0; t0 < stop; t0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and q_s, do_s are staged)
    stage<T, HD, HD + 1>(k_s, kx, t0, kTile, walk_end);
    stage<T, HD, HD + 1>(v_s, vx, t0, kTile, walk_end);
    __syncthreads();
    if (t0 > w_front) continue;  // every row of this warp lies before this tile

    const int j = t0 + lane;
    float sd[kPer], pd[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) sd[i] = pd[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float* kr = k_s + lane * (HD + 1) + c;
      const float* vr = v_s + lane * (HD + 1) + c;
      const float k0 = kr[0], k1 = kr[1], k2 = kr[2], k3 = kr[3];
      const float v0 = vr[0], v1 = vr[1], v2 = vr[2], v3 = vr[3];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(q_s + (warp * kPer + i) * HD + c);
        const float4 dv = *reinterpret_cast<const float4*>(do_s + (warp * kPer + i) * HD + c);
        sd[i] = fmaf(qv.x, k0, fmaf(qv.y, k1, fmaf(qv.z, k2, fmaf(qv.w, k3, sd[i]))));
        pd[i] = fmaf(dv.x, v0, fmaf(dv.y, v1, fmaf(dv.z, v2, fmaf(dv.w, v3, pd[i]))));
      }
    }
    float ds[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = wr0 + i;
      const bool valid = r < R && j <= q_off + r / rep && j < lim;
      const float p = valid ? expf(sd[i] * scale - lse_r[i]) : 0.f;
      ds[i] = round_to<T>(p * (pd[i] - d_r[i]));
    }
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float kk[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) kk[e] = k_s[jj * (HD + 1) + lane + 32 * e];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const float dsj = __shfl_sync(0xffffffffu, ds[i], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(dsj, kk[e], acc[i][e]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = wr0 + i;
    if (r >= R) break;
    T* row = dq + (xr + r) * HD;
#pragma unroll
    for (int e = 0; e < DPL; ++e) row[lane + 32 * e] = from_f<T>(acc[i][e] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ dvec,
                      T* __restrict__ dk, T* __restrict__ dv, int R, int T_, int rep,
                      int valid_len, int q_off, float scale, int fault) {
  constexpr int DPL = HD / 32;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                     // [kBlock][HD]: this CTA's keys
  float* v_s = k_s + kBlock * HD;        // [kBlock][HD]
  float* q_s = v_s + kBlock * HD;        // [kTile][HD + 1]
  float* do_s = q_s + kTile * (HD + 1);  // [kTile][HD + 1]
  float* lse_s = do_s + kTile * (HD + 1);
  float* d_s = lse_s + kTile;

  const int x = blockIdx.x;
  const int t0 = blockIdx.y * kBlock;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long xr = static_cast<long long>(x) * R;
  const long long xt = static_cast<long long>(x) * T_;
  const int lim = min(valid_len, T_);

  stage<T, HD, HD>(k_s, k + xt * HD, t0, kBlock, lim);
  stage<T, HD, HD>(v_s, v + xt * HD, t0, kBlock, lim);

  // this warp's keys t0 + warp * kPer + kk; the first is seen last
  const int wk0 = t0 + warp * kPer;
  float dk_acc[kPer][DPL], dv_acc[kPer][DPL];
#pragma unroll
  for (int kk = 0; kk < kPer; ++kk)
#pragma unroll
    for (int e = 0; e < DPL; ++e) dk_acc[kk][e] = dv_acc[kk][e] = 0.f;

  // the first row that sees key t0 (q_off + r / rep >= t0), rounded down to a block
  const int ahead = t0 - q_off;
  const long long first = ahead > 0 ? static_cast<long long>(ahead) * rep : 0;
  const int rb0 = t0 < lim && first < R ? static_cast<int>(first) / kTile * kTile : R;
  for (int r0 = rb0; r0 < R; r0 += kTile) {
    __syncthreads();  // the previous block is consumed (and k_s, v_s are staged)
    stage<T, HD, HD + 1>(q_s, q + xr * HD, r0, kTile, R);
    stage<T, HD, HD + 1>(do_s, dout + xr * HD, r0, kTile, R);
    if (threadIdx.x < kTile) {
      const int r = min(r0 + threadIdx.x, R - 1);
      lse_s[threadIdx.x] = lse[xr + r];
      d_s[threadIdx.x] = dvec[xr + r];
    }
    __syncthreads();
    // planted fault 2 (tools/fault_margin.py --train): skip the first block
    if (fault == 2 && r0 == rb0) continue;
    // every key of this warp lies past the block's last row's frontier
    if (wk0 > q_off + (min(r0 + kTile, R) - 1) / rep) continue;

    const int r = r0 + lane;
    float sd[kPer], pd[kPer];
#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) sd[kk] = pd[kk] = 0.f;
#pragma unroll 4
    for (int c = 0; c < HD; c += 4) {
      const float* qr = q_s + lane * (HD + 1) + c;
      const float* dr = do_s + lane * (HD + 1) + c;
      const float q0 = qr[0], q1 = qr[1], q2 = qr[2], q3 = qr[3];
      const float d0 = dr[0], d1 = dr[1], d2 = dr[2], d3 = dr[3];
#pragma unroll
      for (int kk = 0; kk < kPer; ++kk) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + (warp * kPer + kk) * HD + c);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + (warp * kPer + kk) * HD + c);
        sd[kk] = fmaf(kv.x, q0, fmaf(kv.y, q1, fmaf(kv.z, q2, fmaf(kv.w, q3, sd[kk]))));
        pd[kk] = fmaf(vv.x, d0, fmaf(vv.y, d1, fmaf(vv.z, d2, fmaf(vv.w, d3, pd[kk]))));
      }
    }
    float p[kPer], ds[kPer];
#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) {
      const int j = wk0 + kk;
      const bool valid = r < R && j <= q_off + r / rep && j < lim;
      const float pr = valid ? expf(sd[kk] * scale - lse_s[lane]) : 0.f;
      p[kk] = round_to<T>(pr);
      ds[kk] = round_to<T>(pr * (pd[kk] - d_s[lane]));
    }
#pragma unroll 4
    for (int ii = 0; ii < kTile; ++ii) {
      float qq[DPL], dd[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) {
        qq[e] = q_s[ii * (HD + 1) + lane + 32 * e];
        dd[e] = do_s[ii * (HD + 1) + lane + 32 * e];
      }
#pragma unroll
      for (int kk = 0; kk < kPer; ++kk) {
        const float pj = __shfl_sync(0xffffffffu, p[kk], ii);
        const float dsj = __shfl_sync(0xffffffffu, ds[kk], ii);
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          dv_acc[kk][e] = fmaf(pj, dd[e], dv_acc[kk][e]);
          dk_acc[kk][e] = fmaf(dsj, qq[e], dk_acc[kk][e]);
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kPer; ++kk) {
    const int j = wk0 + kk;
    if (j >= T_) break;
    T* krow = dk + (xt + j) * HD;
    T* vrow = dv + (xt + j) * HD;
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      krow[lane + 32 * e] = from_f<T>(dk_acc[kk][e] * scale);
      vrow[lane + 32 * e] = from_f<T>(dv_acc[kk][e]);
    }
  }
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int HD>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* dvec, void* dq, int X, int R, int T_,
                      int rep, int valid_len, int q_off, float scale, int fault,
                      cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * 4;
  cudaError_t err = prepare(flash_bwd_dq_kernel<T, HD>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(X, (R + kBlock - 1) / kBlock);
  flash_bwd_dq_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dvec, static_cast<T*>(dq), R, T_, rep, valid_len,
      q_off, scale, fault);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                        const float* lse, const float* dvec, void* dk, void* dv, int X, int R,
                        int T_, int rep, int valid_len, int q_off, float scale, int fault,
                        cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * 4;
  cudaError_t err = prepare(flash_bwd_dkdv_kernel<T, HD>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(X, (T_ + kBlock - 1) / kBlock);
  flash_bwd_dkdv_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), lse, dvec, static_cast<T*>(dk), static_cast<T*>(dv), R, T_,
      rep, valid_len, q_off, scale, fault);
  return cudaGetLastError();
}

// one instance per (dtype, head dim)
#define TDT_BWD_DISPATCH(FN, ...)                                                   \
  if (dtype == kF32 && HD == 128) return FN<float, 128>(__VA_ARGS__);                \
  if (dtype == kF32 && HD == 64) return FN<float, 64>(__VA_ARGS__);                  \
  if (dtype == kBF16 && HD == 128) return FN<__nv_bfloat16, 128>(__VA_ARGS__);       \
  if (dtype == kBF16 && HD == 64) return FN<__nv_bfloat16, 64>(__VA_ARGS__);         \
  return cudaErrorInvalidValue;

}  // namespace

cudaError_t tdt::flash_attn_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                                   const void* dout, const float* lse, const float* dvec,
                                   void* dq, int X, int R, int T, int HD, int rep,
                                   int valid_len, int q_off, float scale, int fault,
                                   cudaStream_t stream) {
  if (X == 0 || R == 0) return cudaSuccess;
  TDT_BWD_DISPATCH(launch_dq, q, k, v, dout, lse, dvec, dq, X, R, T, rep, valid_len, q_off,
                   scale, fault, stream)
}

cudaError_t tdt::flash_attn_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                                     const void* dout, const float* lse, const float* dvec,
                                     void* dk, void* dv, int X, int R, int T, int HD, int rep,
                                     int valid_len, int q_off, float scale, int fault,
                                     cudaStream_t stream) {
  if (X == 0 || T == 0) return cudaSuccess;
  TDT_BWD_DISPATCH(launch_dkdv, q, k, v, dout, lse, dvec, dk, dv, X, R, T, rep, valid_len,
                   q_off, scale, fault, stream)
}
