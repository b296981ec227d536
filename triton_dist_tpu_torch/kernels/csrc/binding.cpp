// Python binding of the kernels' launchers (csrc/launchers.h): the one
// source of the extension that includes PyTorch's headers. Pointers and
// the stream arrive as integers from the Python wrappers, which check
// device, dtype, shape and alignment first; each launch is followed by
// C10_CUDA_CHECK of the launch's cudaGetLastError(), which is what
// C10_CUDA_KERNEL_LAUNCH_CHECK() expands to.
#include <torch/extension.h>
#include <c10/cuda/CUDAException.h>
#include <pybind11/stl.h>

#include <vector>

#include "launchers.h"

namespace {

template <typename P> P* ptr(int64_t p) { return reinterpret_cast<P*>(p); }

cudaStream_t stream(int64_t s) { return reinterpret_cast<cudaStream_t>(s); }

void flash_decode(int q_dtype, int kv_dtype, int64_t q, int64_t k, int64_t v, int64_t ks,
                  int64_t vs, int64_t kv_lens, int64_t q_lens, int64_t o, int kv_len, int B,
                  int S, int Hq, int Hkv, int T, int HD, double scale, int64_t q_sb,
                  int64_t q_ss, int64_t q_sh, int64_t kv_sb, int64_t kv_sh, int64_t kv_st,
                  int64_t sc_sb, int64_t sc_sh, int64_t st) {
  const long long s[8] = {q_sb, q_ss, q_sh, kv_sb, kv_sh, kv_st, sc_sb, sc_sh};
  C10_CUDA_CHECK(tdt::flash_decode(q_dtype, kv_dtype, ptr<const void>(q),
                                   ptr<const void>(k), ptr<const void>(v),
                                   ptr<const void>(ks), ptr<const void>(vs),
                                   ptr<const int>(kv_lens), ptr<const int>(q_lens),
                                   ptr<void>(o), kv_len, B, S, Hq, Hkv, T, HD,
                                   static_cast<float>(scale), s, stream(st)));
}

void flash_decode_partial(int dtype, int64_t q, int64_t k, int64_t v, int64_t acc, int64_t m,
                          int64_t l, int kv_len, int q_off, int B, int S, int Hq, int Hkv,
                          int T, int HD, double scale, int64_t q_sb, int64_t q_ss,
                          int64_t q_sh, int64_t kv_sb, int64_t kv_sh, int64_t kv_st,
                          int64_t st) {
  const long long s[6] = {q_sb, q_ss, q_sh, kv_sb, kv_sh, kv_st};
  C10_CUDA_CHECK(tdt::flash_decode_partial(
      dtype, ptr<const void>(q), ptr<const void>(k), ptr<const void>(v), ptr<float>(acc),
      ptr<float>(m), ptr<float>(l), kv_len, q_off, B, S, Hq, Hkv, T, HD,
      static_cast<float>(scale), s, stream(st)));
}

void flash_attn_bwd_dq(int dtype, int64_t q, int64_t k, int64_t v, int64_t dout, int64_t lse,
                       int64_t dvec, int64_t dq, int X, int R, int T, int HD, int rep,
                       int valid_len, int q_off, double scale, int fault, int64_t st) {
  C10_CUDA_CHECK(tdt::flash_attn_bwd_dq(
      dtype, ptr<const void>(q), ptr<const void>(k), ptr<const void>(v), ptr<const void>(dout),
      ptr<const float>(lse), ptr<const float>(dvec), ptr<void>(dq), X, R, T, HD, rep,
      valid_len, q_off, static_cast<float>(scale), fault, stream(st)));
}

void flash_attn_bwd_dkdv(int dtype, int64_t q, int64_t k, int64_t v, int64_t dout,
                         int64_t lse, int64_t dvec, int64_t dk, int64_t dv, int X, int R,
                         int T, int HD, int rep, int valid_len, int q_off, double scale,
                         int fault, int64_t st) {
  C10_CUDA_CHECK(tdt::flash_attn_bwd_dkdv(
      dtype, ptr<const void>(q), ptr<const void>(k), ptr<const void>(v), ptr<const void>(dout),
      ptr<const float>(lse), ptr<const float>(dvec), ptr<void>(dk), ptr<void>(dv), X, R, T,
      HD, rep, valid_len, q_off, static_cast<float>(scale), fault, stream(st)));
}

void gemm(int dtype, int b_dtype, int64_t a, int64_t sam, int64_t sak, int64_t b, int64_t sbk,
          int64_t sbn, int64_t scale, int64_t c, int M, int N, int K, int64_t st) {
  C10_CUDA_CHECK(tdt::gemm(dtype, b_dtype, ptr<const void>(a), sam, sak, ptr<const void>(b), sbk,
                           sbn, ptr<const float>(scale), ptr<void>(c), M, N, K, stream(st)));
}

void flash_decode_paged(int q_dtype, int kv_dtype, int64_t q, int64_t k, int64_t v,
                        int64_t ks, int64_t vs, int64_t table, int64_t kv_lens,
                        int64_t q_lens, int64_t o, int B, int S, int Hq, int Hkv, int maxp,
                        int page, int HD, double scale, int64_t q_sb, int64_t q_ss,
                        int64_t q_sh, int64_t pg_st, int64_t row_st, int64_t spg_st,
                        int64_t st) {
  const long long s[6] = {q_sb, q_ss, q_sh, pg_st, row_st, spg_st};
  C10_CUDA_CHECK(tdt::flash_decode_paged(
      q_dtype, kv_dtype, ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
      ptr<const void>(ks), ptr<const void>(vs), ptr<const int>(table),
      ptr<const int>(kv_lens), ptr<const int>(q_lens), ptr<void>(o), B, S, Hq, Hkv, maxp,
      page, HD, static_cast<float>(scale), s, stream(st)));
}

void flash_decode_paged_partial(int q_dtype, int kv_dtype, int64_t q, int64_t k, int64_t v,
                                int64_t ks, int64_t vs, int64_t table, int64_t kv_lens,
                                int64_t q_lens, int64_t owned, int64_t acc, int64_t m,
                                int64_t l, int B, int S, int Hq, int Hkv, int maxp, int page,
                                int HD, double scale, int64_t q_sb, int64_t q_ss,
                                int64_t q_sh, int64_t pg_st, int64_t row_st, int64_t spg_st,
                                int64_t st) {
  const long long s[6] = {q_sb, q_ss, q_sh, pg_st, row_st, spg_st};
  C10_CUDA_CHECK(tdt::flash_decode_paged_partial(
      q_dtype, kv_dtype, ptr<const void>(q), ptr<const void>(k), ptr<const void>(v),
      ptr<const void>(ks), ptr<const void>(vs), ptr<const int>(table),
      ptr<const int>(kv_lens), ptr<const int>(q_lens), ptr<const int>(owned),
      ptr<float>(acc), ptr<float>(m), ptr<float>(l), B, S, Hq, Hkv, maxp, page, HD,
      static_cast<float>(scale), s, stream(st)));
}

void gdn_fwd(int dtype, int64_t q, int64_t k, int64_t v, int64_t g, int64_t beta, int64_t s0,
             int64_t o, int64_t sT, int BH, int T, int DK, int DV, int C, int64_t st) {
  C10_CUDA_CHECK(tdt::gdn_fwd(dtype, ptr<const void>(q), ptr<const void>(k),
                              ptr<const void>(v), ptr<const float>(g), ptr<const float>(beta),
                              ptr<const float>(s0), ptr<void>(o), ptr<float>(sT), BH, T, DK,
                              DV, C, stream(st)));
}

void grouped_gemm(int64_t x, int64_t x_es, int64_t w, int64_t w1, int64_t w_es, int64_t w_ld,
                  int split, int64_t out, int E, int C, int D, int F, int64_t st) {
  C10_CUDA_CHECK(tdt::grouped_gemm(ptr<const void>(x), x_es, ptr<const void>(w),
                                   ptr<const void>(w1), w_es, w_ld, split, ptr<void>(out), E, C,
                                   D, F, stream(st)));
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

// The MegaLayerArgs of one launch from three flat lists, in the order
// of mega/decode_layer.py's _launch: ptrs {x, y, w_ln1, w_qkv, q_norm,
// k_norm, w_o, w_ln2, w_gu, w_d, cos, sin, k, v, ks, vs, table, pos_dev,
// xn, qkv, attn, ores, on, h, barrier, part}; ints {cs_stride, pos, T, maxp,
// page, kv_sb, kv_sh, kv_st, pg_st, row_st, spg_st, B, D, F, Hq, Hkv, hd,
// qk_norm, kv_dtype, fault}; the phase codes.
tdt::MegaLayerArgs mega_args(const std::vector<int64_t>& p, const std::vector<int64_t>& n,
                             double eps, double scale, const std::vector<int64_t>& phases) {
  TORCH_CHECK(p.size() == 26 && n.size() == 20 &&
                  phases.size() <= static_cast<size_t>(tdt::kMaxPhases),
              "mega layer: argument lists of the wrong length");
  tdt::MegaLayerArgs a{};
  a.x = ptr<const float>(p[0]);
  a.y = ptr<float>(p[1]);
  a.w_ln1 = ptr<const float>(p[2]);
  a.w_qkv = ptr<const void>(p[3]);
  a.q_norm = ptr<const float>(p[4]);
  a.k_norm = ptr<const float>(p[5]);
  a.w_o = ptr<const void>(p[6]);
  a.w_ln2 = ptr<const float>(p[7]);
  a.w_gu = ptr<const void>(p[8]);
  a.w_d = ptr<const void>(p[9]);
  a.cos = ptr<const float>(p[10]);
  a.sin = ptr<const float>(p[11]);
  a.k = ptr<void>(p[12]);
  a.v = ptr<void>(p[13]);
  a.ks = ptr<float>(p[14]);
  a.vs = ptr<float>(p[15]);
  a.table = ptr<const int>(p[16]);
  a.pos_dev = ptr<const int>(p[17]);
  a.xn = ptr<void>(p[18]);
  a.qkv = ptr<float>(p[19]);
  a.attn = ptr<void>(p[20]);
  a.ores = ptr<float>(p[21]);
  a.on = ptr<void>(p[22]);
  a.h = ptr<void>(p[23]);
  a.barrier = ptr<unsigned int>(p[24]);
  a.part = ptr<float>(p[25]);
  a.cs_stride = n[0];
  a.pos = static_cast<int>(n[1]);
  a.T = static_cast<int>(n[2]);
  a.maxp = static_cast<int>(n[3]);
  a.page = static_cast<int>(n[4]);
  a.kv_sb = n[5];
  a.kv_sh = n[6];
  a.kv_st = n[7];
  a.pg_st = n[8];
  a.row_st = n[9];
  a.spg_st = n[10];
  a.B = static_cast<int>(n[11]);
  a.D = static_cast<int>(n[12]);
  a.F = static_cast<int>(n[13]);
  a.Hq = static_cast<int>(n[14]);
  a.Hkv = static_cast<int>(n[15]);
  a.hd = static_cast<int>(n[16]);
  a.qk_norm = static_cast<int>(n[17]);
  a.kv_dtype = static_cast<int>(n[18]);
  a.fault = static_cast<int>(n[19]);
  a.eps = static_cast<float>(eps);
  a.scale = static_cast<float>(scale);
  a.n_phases = static_cast<int>(phases.size());
  for (size_t i = 0; i < phases.size(); ++i) a.phases[i] = static_cast<int>(phases[i]);
  return a;
}

void mega_decode(const std::vector<int64_t>& p, const std::vector<int64_t>& n, double eps,
                 double scale, const std::vector<int64_t>& phases, int64_t st) {
  C10_CUDA_CHECK(tdt::mega_decode(mega_args(p, n, eps, scale, phases), stream(st)));
}

void mega_paged_decode(const std::vector<int64_t>& p, const std::vector<int64_t>& n,
                       double eps, double scale, const std::vector<int64_t>& phases,
                       int64_t st) {
  C10_CUDA_CHECK(tdt::mega_paged_decode(mega_args(p, n, eps, scale, phases), stream(st)));
}

tdt::CommArgs comm_args(const std::vector<int64_t>& in, const std::vector<int64_t>& in2,
                        const std::vector<int64_t>& scale, const std::vector<int64_t>& out,
                        const std::vector<int64_t>& out2, const std::vector<int64_t>& land,
                        const std::vector<int64_t>& sig, int first_rank, int n_local,
                        int64_t epoch) {
  const int n = static_cast<int>(sig.size());
  TORCH_CHECK(n >= 1 && n <= tdt::kMaxRanks, "collectives take 1-", tdt::kMaxRanks, " ranks");
  TORCH_CHECK(epoch > 0 && epoch < (int64_t(1) << 31), "bad epoch ", epoch);
  tdt::CommArgs a{};
  auto check = [n](const std::vector<int64_t>& v, const char* what) {
    TORCH_CHECK(v.empty() || static_cast<int>(v.size()) == n, what, ": one pointer per rank");
  };
  check(in, "in");
  check(in2, "in2");
  check(scale, "scale");
  check(out, "out");
  check(out2, "out2");
  check(land, "land");
  for (size_t r = 0; r < in.size(); ++r) a.in[r] = ptr<const void>(in[r]);
  for (size_t r = 0; r < in2.size(); ++r) a.in2[r] = ptr<const void>(in2[r]);
  for (size_t r = 0; r < scale.size(); ++r) a.scale[r] = ptr<const float>(scale[r]);
  for (size_t r = 0; r < out.size(); ++r) a.out[r] = ptr<void>(out[r]);
  for (size_t r = 0; r < out2.size(); ++r) a.out2[r] = ptr<void>(out2[r]);
  for (size_t r = 0; r < land.size(); ++r) a.land[r] = ptr<void>(land[r]);
  for (int r = 0; r < n; ++r) a.sig[r] = ptr<unsigned>(sig[r]);
  a.n = n;
  a.first_rank = first_rank;
  a.n_local = n_local;
  a.epoch = static_cast<unsigned>(epoch);
  return a;
}

using Ptrs = std::vector<int64_t>;

// The TP form of mega_decode: one launch for the device's local ranks,
// p[i] and n[i] local rank i's mega_args lists.
void mega_decode_tp(const std::vector<Ptrs>& p, const std::vector<Ptrs>& n, double eps,
                    double scale, const Ptrs& phases, const Ptrs& land, const Ptrs& sig,
                    int first_rank, int n_local, int64_t epoch, int ctas, int64_t st) {
  TORCH_CHECK(static_cast<int>(p.size()) == n_local && p.size() == n.size() &&
                  n_local <= tdt::kMaxRanks,
              "mega_decode_tp: one argument list per local rank");
  tdt::MegaTpArgs a{};
  for (int i = 0; i < n_local; ++i) a.L[i] = mega_args(p[i], n[i], eps, scale, phases);
  a.c = comm_args({}, {}, {}, {}, {}, land, sig, first_rank, n_local, epoch);
  C10_CUDA_CHECK(tdt::mega_decode_tp(a, ctas, stream(st)));
}

void all_gather(int method, const Ptrs& in, const Ptrs& out, const Ptrs& sig, int first_rank,
                int n_local, int64_t epoch, int64_t svec, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::all_gather(
      method, comm_args(in, {}, {}, out, {}, {}, sig, first_rank, n_local, epoch), svec, ctas,
      stream(st)));
}

void reduce_scatter(int dtype, int method, const Ptrs& in, const Ptrs& out, const Ptrs& land,
                    const Ptrs& sig, int first_rank, int n_local, int64_t epoch, int64_t cvec,
                    int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::reduce_scatter(
      dtype, method, comm_args(in, {}, {}, out, {}, land, sig, first_rank, n_local, epoch), cvec,
      ctas, stream(st)));
}

void all_reduce(int dtype, int method, const Ptrs& in, const Ptrs& out, const Ptrs& land,
                const Ptrs& sig, int first_rank, int n_local, int64_t epoch, int64_t nvec,
                int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::all_reduce(
      dtype, method, comm_args(in, {}, {}, out, {}, land, sig, first_rank, n_local, epoch), nvec,
      ctas, stream(st)));
}

void gemm_allreduce(int a_dtype, int b_dtype, const Ptrs& a, const Ptrs& b, const Ptrs& scale,
                    const Ptrs& out, const Ptrs& land, const Ptrs& sig, int first_rank,
                    int n_local, int64_t epoch, int M, int N, int K, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::gemm_allreduce(
      a_dtype, b_dtype, comm_args(a, b, scale, out, {}, land, sig, first_rank, n_local, epoch), M,
      N, K, ctas, stream(st)));
}

void ag_gemm(int a_dtype, int b_dtype, const Ptrs& a, const Ptrs& b, const Ptrs& scale,
             const Ptrs& gathered, const Ptrs& c, const Ptrs& sig, int first_rank, int n_local,
             int64_t epoch, int64_t cvec, int M, int N, int K, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::ag_gemm(
      a_dtype, b_dtype,
      comm_args(a, b, scale, gathered, c, {}, sig, first_rank, n_local, epoch), cvec, M, N, K,
      ctas, stream(st)));
}

void gemm_rs(int a_dtype, int b_dtype, const Ptrs& a, const Ptrs& b, const Ptrs& scale,
             const Ptrs& out, const Ptrs& partial, const Ptrs& land, const Ptrs& sig,
             int first_rank, int n_local, int64_t epoch, int64_t cvec, int M, int N, int K,
             int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::gemm_rs(
      a_dtype, b_dtype,
      comm_args(a, b, scale, out, partial, land, sig, first_rank, n_local, epoch), cvec, M, N,
      K, ctas, stream(st)));
}

void all_to_all(const Ptrs& in, const Ptrs& out, const Ptrs& sig, int first_rank, int n_local,
                int64_t epoch, int64_t chunk_bytes, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::all_to_all(
      comm_args(in, {}, {}, out, {}, {}, sig, first_rank, n_local, epoch), chunk_bytes, ctas,
      stream(st)));
}

void dispatch_a2a(const Ptrs& x, const Ptrs& meta, const Ptrs& out, const Ptrs& meta_out,
                  const Ptrs& sig, int first_rank, int n_local, int64_t epoch,
                  int64_t chunk_bytes, int64_t meta_bytes, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::dispatch_a2a(
      comm_args(x, meta, {}, out, meta_out, {}, sig, first_rank, n_local, epoch), chunk_bytes,
      meta_bytes, ctas, stream(st)));
}

void ep_moe_fused(int dtype, int w_dtype, const Ptrs& x, const Ptrs& wgu, const Ptrs& sgu,
                  const Ptrs& wd, const Ptrs& sd, const Ptrs& recv, const Ptrs& h,
                  const Ptrs& yback, const Ptrs& sig, int first_rank, int n_local,
                  int64_t epoch, int E, int cap, int D, int I, int ctas, int64_t st) {
  tdt::EpFusedArgs f{};
  f.c = comm_args(x, wgu, sgu, yback, h, recv, sig, first_rank, n_local, epoch);
  TORCH_CHECK(static_cast<int>(wd.size()) == f.c.n && (sd.empty() || static_cast<int>(
                  sd.size()) == f.c.n), "ep_moe_fused: one w_d (and scale) pointer per rank");
  for (size_t r = 0; r < wd.size(); ++r) f.wd[r] = ptr<const void>(wd[r]);
  for (size_t r = 0; r < sd.size(); ++r) f.sd[r] = ptr<const float>(sd[r]);
  f.E = E;
  f.cap = cap;
  f.D = D;
  f.I = I;
  C10_CUDA_CHECK(tdt::ep_moe_fused(dtype, w_dtype, f, ctas, stream(st)));
}

tdt::MoeCommArgs moe_args(const Ptrs& in, const Ptrs& b0, const Ptrs& b1, const Ptrs& b_es,
                          const Ptrs& b_ld, const Ptrs& out, const Ptrs& out2, const Ptrs& land,
                          const Ptrs& sig, int first_rank, int n_local, int64_t epoch, int E,
                          int M, int N, int K, int split) {
  tdt::MoeCommArgs m{};
  m.c = comm_args(in, b0, {}, out, out2, land, sig, first_rank, n_local, epoch);
  TORCH_CHECK((b1.empty() || static_cast<int>(b1.size()) == m.c.n) &&
                  static_cast<int>(b_es.size()) == m.c.n && static_cast<int>(b_ld.size()) == m.c.n,
              "moe comm GEMM: one B block and stride pair per rank");
  for (size_t r = 0; r < b1.size(); ++r) m.b1[r] = ptr<const void>(b1[r]);
  for (int r = 0; r < m.c.n; ++r) {
    m.b_es[r] = b_es[r];
    m.b_ld[r] = b_ld[r];
  }
  m.E = E;
  m.M = M;
  m.N = N;
  m.K = K;
  m.split = split;
  return m;
}

void ag_group_gemm(int dtype, const Ptrs& x, const Ptrs& b0, const Ptrs& b1, const Ptrs& b_es,
                   const Ptrs& b_ld, const Ptrs& gathered, const Ptrs& c, const Ptrs& sig,
                   int first_rank, int n_local, int64_t epoch, int E, int M, int N, int K,
                   int split, int64_t cv, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::ag_group_gemm(
      dtype, moe_args(x, b0, b1, b_es, b_ld, gathered, c, {}, sig, first_rank, n_local, epoch, E,
                      M, N, K, split),
      cv, ctas, stream(st)));
}

void moe_reduce_rs(int dtype, const Ptrs& h, const Ptrs& w, const Ptrs& w_es, const Ptrs& w_ld,
                   const Ptrs& out, const Ptrs& partial, const Ptrs& land, const Ptrs& sig,
                   int first_rank, int n_local, int64_t epoch, int E, int M, int N, int K,
                   int64_t cvec, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::moe_reduce_rs(
      dtype, moe_args(h, w, {}, w_es, w_ld, out, partial, land, sig, first_rank, n_local, epoch,
                      E, M, N, K, N),
      cvec, ctas, stream(st)));
}

void moe_reduce_ar(int dtype, const Ptrs& h, const Ptrs& w, const Ptrs& w_es, const Ptrs& w_ld,
                   const Ptrs& out, const Ptrs& land, const Ptrs& sig, int first_rank,
                   int n_local, int64_t epoch, int E, int M, int N, int K, int ctas,
                   int64_t st) {
  C10_CUDA_CHECK(tdt::moe_reduce_ar(
      dtype, moe_args(h, w, {}, w_es, w_ld, out, {}, land, sig, first_rank, n_local, epoch, E,
                      M, N, K, N),
      ctas, stream(st)));
}

void lse_combine(const Ptrs& acc, const Ptrs& st, const Ptrs& out, const Ptrs& land,
                 const Ptrs& land_st, const Ptrs& sig, int first_rank, int n_local,
                 int64_t epoch, int R, int d, int ctas, int64_t st_) {
  C10_CUDA_CHECK(tdt::lse_combine(
      comm_args(acc, st, {}, out, land_st, land, sig, first_rank, n_local, epoch), R, d, ctas,
      stream(st_)));
}

void kv_scatter(const Ptrs& src, const Ptrs& cache, const Ptrs& sig, int first_rank,
                int n_local, int64_t epoch, int BH, int s_loc, int t_loc, int64_t row_vec,
                int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::kv_scatter(
      comm_args(src, {}, {}, cache, {}, {}, sig, first_rank, n_local, epoch), BH, s_loc, t_loc,
      row_vec, ctas, stream(st)));
}

void ring_attn(int dtype, int HD, const Ptrs& q, const Ptrs& k, const Ptrs& v, const Ptrs& acc,
               const Ptrs& m, const Ptrs& l, const Ptrs& land_k, const Ptrs& land_v,
               const Ptrs& sig, int first_rank, int n_local, int64_t epoch, int X, int rows,
               int s_loc, int rep, int causal, double scale, int ctas, int64_t st) {
  tdt::RingAttnArgs r{};
  r.c = comm_args(q, k, {}, acc, {}, land_k, sig, first_rank, n_local, epoch);
  const int n = r.c.n;
  TORCH_CHECK(static_cast<int>(v.size()) == n && static_cast<int>(m.size()) == n &&
                  static_cast<int>(l.size()) == n && static_cast<int>(land_v.size()) == n,
              "ring_attn: one v, m, l and v landing pointer per rank");
  for (int i = 0; i < n; ++i) {
    r.v[i] = ptr<const void>(v[i]);
    r.land_v[i] = ptr<void>(land_v[i]);
    r.m[i] = ptr<float>(m[i]);
    r.l[i] = ptr<float>(l[i]);
  }
  r.X = X;
  r.rows = rows;
  r.s_loc = s_loc;
  r.rep = rep;
  r.causal = causal;
  r.scale = static_cast<float>(scale);
  C10_CUDA_CHECK(tdt::ring_attn(dtype, HD, r, ctas, stream(st)));
}

void p2p_shift(const Ptrs& in, const Ptrs& out, const Ptrs& sig, int first_rank, int n_local,
               int64_t epoch, int64_t bytes, int reverse, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::p2p_shift(
      comm_args(in, {}, {}, out, {}, {}, sig, first_rank, n_local, epoch), bytes, reverse,
      ctas, stream(st)));
}

void gemm_all_to_all(int dtype, const Ptrs& a, const Ptrs& w, const Ptrs& out,
                     const Ptrs& sig, int first_rank, int n_local, int64_t epoch, int m,
                     int Nc, int K, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::gemm_all_to_all(
      dtype, comm_args(a, w, {}, out, {}, {}, sig, first_rank, n_local, epoch), m, Nc, K, ctas,
      stream(st)));
}

void o_a2a_gemm(int dtype, const Ptrs& x, const Ptrs& w, const Ptrs& out, const Ptrs& land,
                const Ptrs& sig, int first_rank, int n_local, int64_t epoch, int m, int Nc,
                int D, int ctas, int64_t st) {
  C10_CUDA_CHECK(tdt::o_a2a_gemm(
      dtype, comm_args(x, w, {}, out, {}, land, sig, first_rank, n_local, epoch), m, Nc, D,
      ctas, stream(st)));
}

// peer access from device `dev` to `peer` (a mesh of distinct cards);
// enabling it twice is not an error
void enable_peer_access(int dev, int peer) {
  int prev = 0;
  C10_CUDA_CHECK(cudaGetDevice(&prev));
  C10_CUDA_CHECK(cudaSetDevice(dev));
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    (void)cudaGetLastError();
  } else {
    C10_CUDA_CHECK(err);
  }
  C10_CUDA_CHECK(cudaSetDevice(prev));
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("flash_decode", &flash_decode);
  m.def("flash_decode_partial", &flash_decode_partial);
  m.def("flash_attn_bwd_dq", &flash_attn_bwd_dq);
  m.def("flash_attn_bwd_dkdv", &flash_attn_bwd_dkdv);
  m.def("flash_decode_paged", &flash_decode_paged);
  m.def("flash_decode_paged_partial", &flash_decode_paged_partial);
  m.def("gdn_fwd", &gdn_fwd);
  m.def("gemm", &gemm);
  m.def("grouped_gemm", &grouped_gemm);
  m.def("kv_update", &kv_update);
  m.def("mega_decode", &mega_decode);
  m.def("mega_paged_decode", &mega_paged_decode);
  m.def("mega_decode_tp", &mega_decode_tp);
  m.def("swiglu", &swiglu);
  m.def("all_gather", &all_gather);
  m.def("reduce_scatter", &reduce_scatter);
  m.def("all_reduce", &all_reduce);
  m.def("gemm_allreduce", &gemm_allreduce);
  m.def("ag_gemm", &ag_gemm);
  m.def("gemm_rs", &gemm_rs);
  m.def("all_to_all", &all_to_all);
  m.def("dispatch_a2a", &dispatch_a2a);
  m.def("ep_moe_fused", &ep_moe_fused);
  m.def("ag_group_gemm", &ag_group_gemm);
  m.def("moe_reduce_rs", &moe_reduce_rs);
  m.def("moe_reduce_ar", &moe_reduce_ar);
  m.def("lse_combine", &lse_combine);
  m.def("kv_scatter", &kv_scatter);
  m.def("ring_attn", &ring_attn);
  m.def("p2p_shift", &p2p_shift);
  m.def("gemm_all_to_all", &gemm_all_to_all);
  m.def("o_a2a_gemm", &o_a2a_gemm);
  m.def("enable_peer_access", &enable_peer_access);
}
