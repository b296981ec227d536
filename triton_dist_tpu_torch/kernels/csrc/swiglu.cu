// Fused SwiGLU activation over a packed [gate | up] matrix.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/swiglu.py `_swiglu_kernel`
// (the pallas_call at swiglu.py:51): out[m, j] = silu(x[m, j]) * x[m, I + j]
// for x [M, 2I] (row stride given, columns contiguous), out [M, I]
// contiguous, bf16 or f32. Rounding follows the TPU kernel: the sigmoid is
// computed in f32 and rounded to the input dtype, then g * sigmoid(g) and
// that times u are each rounded to the input dtype.
//
// What bounds it on an H100: bytes. It reads 2I and writes I elements per
// row and does a handful of flops per element. Design: each thread handles
// one 16-byte vector of gate columns, the matching vector of up columns
// (column j pairs with column j + I) and one 16-byte output vector, so a
// warp reads and writes contiguous 512-byte runs; a grid-stride loop
// covers any M.
#include "common.cuh"

namespace {

template <typename T>
__global__ void swiglu_kernel(const T* __restrict__ x, T* __restrict__ out, long long M,
                              int I, long long ld) {
  constexpr int VN = Vec16<T>::n;
  const int vpr = I / VN;  // vectors per output row
  const long long total = M * vpr;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / vpr;
    const int c = static_cast<int>(i % vpr) * VN;
    float g[VN], u[VN], y[VN];
    load16<T>(x + row * ld + c, g);
    load16<T>(x + row * ld + I + c, u);
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      const float sig = round_to<T>(1.f / (1.f + expf(-g[e])));
      y[e] = round_to<T>(g[e] * sig) * u[e];
    }
    store16<T>(out + row * I + c, y);
  }
}

template <typename T>
cudaError_t launch(const void* x, void* out, long long M, int I, long long ld,
                   cudaStream_t stream) {
  const long long total = M * (I / Vec16<T>::n);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 32 ? want : 132 * 32);
  swiglu_kernel<T><<<blocks, threads, 0, stream>>>(static_cast<const T*>(x),
                                                   static_cast<T*>(out), M, I, ld);
  return cudaGetLastError();
}

}  // namespace

cudaError_t tdt::swiglu(int dtype, const void* x, void* out, long long M, int I,
                        long long ld, cudaStream_t stream) {
  if (dtype == kBF16) return launch<__nv_bfloat16>(x, out, M, I, ld, stream);
  if (dtype == kF32) return launch<float>(x, out, M, I, ld, stream);
  return cudaErrorInvalidValue;
}
