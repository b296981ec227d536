// Python binding of the kernels' launchers (csrc/launchers.h): the one
// source of the extension that includes PyTorch's headers. Pointers and
// the stream arrive as integers from the Python wrappers, which check
// device, dtype, shape and alignment first; each launch is followed by
// C10_CUDA_CHECK of the launch's cudaGetLastError(), which is what
// C10_CUDA_KERNEL_LAUNCH_CHECK() expands to.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>

#include "launchers.h"

namespace {

template <typename P> P* ptr(int64_t p) { return reinterpret_cast<P*>(p); }

cudaStream_t stream(int64_t s) { return reinterpret_cast<cudaStream_t>(s); }

void flash_decode(int q_dtype, int kv_dtype, int64_t q, int64_t k, int64_t v, int64_t ks,
                  int64_t vs, int64_t kv_lens, int64_t o, int kv_len, int B, int S, int Hq,
                  int Hkv, int T, int HD, double scale, int64_t q_sb, int64_t q_ss,
                  int64_t q_sh, int64_t kv_sb, int64_t kv_sh, int64_t kv_st, int64_t sc_sb,
                  int64_t sc_sh, int64_t st) {
  const long long s[8] = {q_sb, q_ss, q_sh, kv_sb, kv_sh, kv_st, sc_sb, sc_sh};
  C10_CUDA_CHECK(tdt::flash_decode(q_dtype, kv_dtype, ptr<const void>(q),
                                   ptr<const void>(k), ptr<const void>(v),
                                   ptr<const void>(ks), ptr<const void>(vs),
                                   ptr<const int>(kv_lens), ptr<void>(o), kv_len, B, S, Hq,
                                   Hkv, T, HD, static_cast<float>(scale), s, stream(st)));
}

void flash_decode_paged(int q_dtype, int kv_dtype, int64_t q, int64_t k, int64_t v,
                        int64_t ks, int64_t vs, int64_t table, int64_t kv_lens, int64_t o,
                        int B, int Hq, int Hkv, int maxp, int page, int HD, double scale,
                        int64_t q_sb, int64_t q_sh, int64_t pg_st, int64_t row_st,
                        int64_t spg_st, int64_t st) {
  const long long s[5] = {q_sb, q_sh, pg_st, row_st, spg_st};
  C10_CUDA_CHECK(tdt::flash_decode_paged(
      q_dtype, kv_dtype, ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
      ptr<const void>(ks), ptr<const void>(vs), ptr<const int>(table),
      ptr<const int>(kv_lens), ptr<void>(o), B, Hq, Hkv, maxp, page, HD,
      static_cast<float>(scale), s, stream(st)));
}

void kv_update(int64_t cache, int64_t src, int pos, int B, int H, int T, int S,
               int row_bytes, int64_t src_sb, int64_t src_sh, int64_t src_ss,
               int64_t st) {
  C10_CUDA_CHECK(tdt::kv_update(ptr<void>(cache), ptr<const void>(src), pos, B, H, T, S,
                                row_bytes, src_sb, src_sh, src_ss, stream(st)));
}

void swiglu(int dtype, int64_t x, int64_t out, int64_t M, int I, int64_t ld, int64_t st) {
  C10_CUDA_CHECK(tdt::swiglu(dtype, ptr<const void>(x), ptr<void>(out), M, I, ld,
                             stream(st)));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_decode", &flash_decode);
  m.def("flash_decode_paged", &flash_decode_paged);
  m.def("kv_update", &kv_update);
  m.def("swiglu", &swiglu);
}
