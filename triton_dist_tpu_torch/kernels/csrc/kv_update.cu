// In-place insert of new K or V rows into a contiguous KV cache.
//
// Replaces the TPU kernel triton_dist_tpu/kernels/flash_attn.py `kv_update`
// (the aliased one-DMA pallas_call at flash_attn.py:448):
//   cache[:, :, pos : pos + S, :] = new
// for cache [B, H, T, d] (contiguous, any dtype) and new [B, H, S, d]
// (strides given, d contiguous). The TPU kernel wrote whole 8-row tiles at
// an 8-aligned row because Mosaic had to prove the sublane start aligned;
// nothing here needs that, so any row offset is taken and the attention
// layer uses this kernel for every K/V insert, prefill and decode alike.
//
// What bounds it on an H100: bytes. It moves B*H*S*d elements once (read
// once, written once) and computes nothing. Design: one thread per 16-byte
// chunk of a row, so neighbouring threads touch neighbouring addresses in
// both the source and the cache row; a grid-stride loop covers any size.
// An offset outside [0, T - S] writes nothing (the wrapper rejects it
// before launching).
#include "common.cuh"

namespace {

__global__ void kv_update_kernel(char* __restrict__ cache, const char* __restrict__ src,
                                 int pos, int H, int T, int S,
                                 int row_bytes, long long total, long long src_sb,
                                 long long src_sh, long long src_ss) {
  if (pos < 0 || pos + S > T) return;
  const int row_vecs = row_bytes / 16;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = static_cast<int>(i % row_vecs);
    long long rest = i / row_vecs;
    const int s = static_cast<int>(rest % S);
    rest /= S;
    const int h = static_cast<int>(rest % H);
    const long long b = rest / H;
    const uint4* sp =
        reinterpret_cast<const uint4*>(src + b * src_sb + h * src_sh + s * src_ss) + c;
    uint4* dp = reinterpret_cast<uint4*>(cache + ((b * H + h) * T + pos + s) * row_bytes) + c;
    *dp = *sp;
  }
}

}  // namespace

cudaError_t tdt::kv_update(void* cache, const void* src, int pos, int B, int H, int T,
                           int S, int row_bytes, long long src_sb, long long src_sh,
                           long long src_ss, cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * H * S * (row_bytes / 16);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  kv_update_kernel<<<blocks, threads, 0, stream>>>(
      static_cast<char*>(cache), static_cast<const char*>(src), pos, H, T, S, row_bytes,
      total, src_sb, src_sh, src_ss);
  return cudaGetLastError();
}
