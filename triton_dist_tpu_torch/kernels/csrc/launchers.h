// Host launchers of the package's CUDA kernels, declared once for the
// kernel sources that define them and for binding.cpp that binds them,
// so that a mismatch between the two fails to compile.
//
// Each launcher takes raw device pointers, strides and sizes, launches on
// the given stream, allocates nothing, and returns cudaGetLastError()
// after its launch, or cudaErrorInvalidValue without launching for a
// dtype code or head dim it has no instance for.
#pragma once

#include <cuda_runtime.h>

namespace tdt {

// dtype codes shared with the Python wrappers (kernels/_build.py DTYPE_CODES)
enum Dtype { kF32 = 0, kBF16 = 1, kI8 = 2 };

// csrc/flash_decode.cu. Strides in elements: st = {q_sb, q_ss, q_sh, kv_sb,
// kv_sh, kv_st, sc_sb, sc_sh}; ks/vs are null for a bf16/f32 cache;
// kv_lens is null (every row uses kv_len) or per-batch-row lengths [B]
// int32 on the device (then S must be 1 unless q_lens is given); q_lens
// is null or per-batch-row query windows [B] int32 on the device.
cudaError_t flash_decode(int q_dtype, int kv_dtype, const void* q, const void* k,
                         const void* v, const void* ks, const void* vs,
                         const int* kv_lens, const int* q_lens, void* o, int kv_len, int B,
                         int S, int Hq, int Hkv, int T, int HD, float scale,
                         const long long* st, cudaStream_t stream);

// csrc/flash_decode.cu, the partial form (the training forward). q as
// above (st[0..2]), k/v [B, Hkv, T, d] (st[3..5]), bf16 or f32 alike;
// outputs acc [B*Hkv, S*rep, d], m and l [B*Hkv, S*rep] f32, contiguous;
// query row s sits at position q_off + s and attends keys <= that, below
// min(kv_len, T).
cudaError_t flash_decode_partial(int dtype, const void* q, const void* k, const void* v,
                                 float* acc, float* m, float* l, int kv_len, int q_off, int B,
                                 int S, int Hq, int Hkv, int T, int HD, float scale,
                                 const long long* st, cudaStream_t stream);

// csrc/flash_attn_bwd.cu. Folded GQA layout, contiguous: q, dout, dq [X, R,
// HD]; k, v, dk, dv [X, T, HD]; lse, dvec [X, R] f32; row r attends keys
// <= q_off + r / rep below min(valid_len, T). fault: 0, or a planted fault
// for tools/fault_margin.py --train (1: dq stops one KV tile short; 2:
// dk/dv skips the first query block of its walk).
cudaError_t flash_attn_bwd_dq(int dtype, const void* q, const void* k, const void* v,
                              const void* dout, const float* lse, const float* dvec, void* dq,
                              int X, int R, int T, int HD, int rep, int valid_len, int q_off,
                              float scale, int fault, cudaStream_t stream);
cudaError_t flash_attn_bwd_dkdv(int dtype, const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* dvec,
                                void* dk, void* dv, int X, int R, int T, int HD, int rep,
                                int valid_len, int q_off, float scale, int fault,
                                cudaStream_t stream);

// csrc/gemm.cu. c [M, N] contiguous = a [M, K] @ b [K, N] in a's dtype (bf16
// or f32), f32 accumulation; strides in elements. bf16: each operand has a
// unit stride in one dimension, K and N are multiples of 8 (M too for a
// column-major a), leading strides multiples of 8. b_dtype: a's, or int8
// under a bf16 a (a QuantW panel: b row-major, scale [N] f32 applied per
// column after the product; null otherwise).
cudaError_t gemm(int dtype, int b_dtype, const void* a, long long sam, long long sak,
                 const void* b, long long sbk, long long sbn, const float* scale, void* c,
                 int M, int N, int K, cudaStream_t stream);

// csrc/flash_decode_paged.cu. q [B, S, Hq, HD]; pools [NP, 1, page, HD];
// strides in elements: st = {q_sb, q_ss, q_sh, page stride and row stride
// of the pools, page stride of the scale pools}; ks/vs are null for a
// bf16/f32 pool; table [B*Hkv, maxp] and kv_lens [B] int32 on the device;
// q_lens [B] int32 on the device, or null (then S must be 1).
cudaError_t flash_decode_paged(int q_dtype, int kv_dtype, const void* q, const void* k,
                               const void* v, const void* ks, const void* vs,
                               const int* table, const int* kv_lens, const int* q_lens,
                               void* o, int B, int S, int Hq, int Hkv, int maxp, int page,
                               int HD, float scale, const long long* st,
                               cudaStream_t stream);

// csrc/flash_decode_paged.cu, the partial form (the sequence-parallel
// split-KV walk over one rank's pool shard). Arguments as
// flash_decode_paged, with the rank's pool and its local table, plus
// owned [B*Hkv, maxp] int32 on the device (non-zero: the rank holds that
// logical page); outputs acc [B*Hkv, S*rep, HD], m and l [B*Hkv, S*rep]
// f32, contiguous.
cudaError_t flash_decode_paged_partial(int q_dtype, int kv_dtype, const void* q, const void* k,
                                       const void* v, const void* ks, const void* vs,
                                       const int* table, const int* kv_lens,
                                       const int* q_lens, const int* owned, float* acc,
                                       float* m, float* l, int B, int S, int Hq, int Hkv,
                                       int maxp, int page, int HD, float scale,
                                       const long long* st, cudaStream_t stream);

// csrc/gdn.cu. q, k [BH, T, DK], v [BH, T, DV] contiguous, of one dtype (bf16
// or f32); g, beta [BH, T] f32; s0 [BH, DK, DV] f32 or null (zeros); outputs
// o [BH, T, DV] in q's dtype and sT [BH, DK, DV] f32. DK and DV in {64, 128},
// chunk C in {32, 64}.
cudaError_t gdn_fwd(int dtype, const void* q, const void* k, const void* v, const float* g,
                    const float* beta, const float* s0, void* o, float* sT, int BH, int T,
                    int DK, int DV, int C, cudaStream_t stream);

// csrc/kv_update.cu. cache: [B, H, T, row_bytes] contiguous bytes; src
// strides in bytes.
cudaError_t kv_update(void* cache, const void* src, int pos, int B, int H, int T, int S,
                      int row_bytes, long long src_sb, long long src_sh,
                      long long src_ss, cudaStream_t stream);

// csrc/swiglu.cu. x: [M, 2I] with row stride ld (elements); out: [M, I].
cudaError_t swiglu(int dtype, const void* x, void* out, long long M, int I, long long ld,
                   cudaStream_t stream);

// csrc/grouped_gemm.cu. x: [E, C, D] bf16, rows contiguous, expert stride
// x_es (elements); out: [E, C, F] bf16 contiguous; w: expert e's [D, F]
// panel at w + e * w_es, rows at stride w_ld, its columns [0, split) there
// and, when w1 is not null, [split, F) from w1 (same strides; split == F
// otherwise). D a multiple of 32; F, split, w_es and w_ld of 8.
cudaError_t grouped_gemm(const void* x, long long x_es, const void* w, const void* w1,
                         long long w_es, long long w_ld, int split, void* out, int E, int C,
                         int D, int F, cudaStream_t stream);

// One decode layer per launch (csrc/mega_layer.cuh; mega_decode.cu over
// the contiguous cache, mega_paged_decode.cu over the page pool). All
// pointers are device pointers; weights bf16 row-major, norms f32, rope
// rows f32 (row b at cos + b * cs_stride; cs_stride 0 shares one row).
// Strides in elements. The scratch (xn, qkv, attn, ores, on, h, the TP
// form's part and the two-word grid barrier, zeroed once) belongs to the
// caller and is reused by every launch on the stream. phases: the layer's
// tasks in the order the host validated (tdt_mega::Phase codes).
constexpr int kMaxPhases = 12;
struct MegaLayerArgs {
  const float* x;
  float* y;
  const float* w_ln1;
  const void* w_qkv;
  const float* q_norm;
  const float* k_norm;
  const void* w_o;
  const float* w_ln2;
  const void* w_gu;
  const void* w_d;
  const float* cos;
  const float* sin;
  void* k;              // cache or pool payload (bf16 or int8)
  void* v;
  float* ks;            // int8 pools: scale pages [NP, 1, page]
  float* vs;
  const int* table;     // paged: [B*Hkv, maxp] int32
  const int* pos_dev;   // paged: [B] int32, slot b's new token sits at pos_dev[b]
  void* xn;             // scratch: bf16 [B, D]
  float* qkv;           // f32 [B, (Hq + 2*Hkv) * hd]
  void* attn;           // bf16 [B, Hq * hd]
  float* ores;          // f32 [B, D]
  void* on;             // bf16 [B, D]
  void* h;              // bf16 [B, F]
  unsigned int* barrier;
  float* part;          // f32 [B, D]: the TP form stages the rank's partials here
  long long cs_stride;
  int pos, T;           // contiguous: the shared position and the capacity
  int maxp, page;       // paged
  long long kv_sb, kv_sh, kv_st;     // contiguous cache [B, Hkv, T, hd]
  long long pg_st, row_st, spg_st;   // pools [NP, 1, page, hd], scales [NP, 1, page]
  int B, D, F, Hq, Hkv, hd, qk_norm, kv_dtype;
  int fault;            // 0; a planted fault for tools/fault_margin.py: 1 drops the
                        // newest key from the walk, 2 leaves out the o_proj residual;
                        // TP form, both all-reduce sections: 3 folds without rank
                        // me + 1's partial, 4 folds before its pushes and its arrival
                        // wait, 5 folds rank me + 1's partial twice
  float eps, scale;
  int n_phases;
  int phases[kMaxPhases];
};

cudaError_t mega_decode(const MegaLayerArgs& a, cudaStream_t stream);
cudaError_t mega_paged_decode(const MegaLayerArgs& a, cudaStream_t stream);

// The collectives (csrc/shmem.cuh, ring.cuh; allgather.cu, reduce_scatter.cu,
// allreduce.cu, gemm_allreduce.cu, ag_gemm.cu, gemm_rs.cu). One launch
// covers the n_local ranks [first_rank, first_rank + n_local) of one device;
// every pointer of all n ranks comes by value. in: each rank's input (A for
// the GEMMs); in2/scale: the GEMMs' B panels and their per-column f32
// scales (null for bf16 panels); out: each rank's output; out2: a second
// buffer of each rank (ag_gemm's product, gemm_rs's partial); land: each
// rank's symmetric landing buffer (unused by all_gather); sig: each rank's
// signal pad (runtime/symm_mem.py SIGNAL_SLOTS int32 flags); epoch: the call's,
// from the mesh (never 0, never reused).
constexpr int kMaxRanks = 8;
struct CommArgs {
  const void* in[kMaxRanks];
  const void* in2[kMaxRanks];
  const float* scale[kMaxRanks];
  void* out[kMaxRanks];
  void* out2[kMaxRanks];
  void* land[kMaxRanks];
  unsigned* sig[kMaxRanks];
  int n, first_rank, n_local;
  unsigned epoch;
};

// The tensor-parallel decode layer (mega_decode.cu's TP form): one
// cooperative launch per device over (ctas, 1, n_local) CTAs; L[i] is
// local rank i's layer (its shards, cache, scratch with part, output y),
// c the call's comm arguments: land = each rank's symmetric f32 landing
// buffer [2, n, B, D] (section, source rank), sig the signal pads, epoch
// the launch's. ctas: CTAs per rank, the same on every device.
struct MegaTpArgs {
  MegaLayerArgs L[kMaxRanks];
  CommArgs c;
};
cudaError_t mega_decode_tp(const MegaTpArgs& a, int ctas, cudaStream_t stream);

// method 0 one-shot, 1 ring; sizes in 16-byte vectors (svec: one rank's
// shard; cvec: one rank's chunk, the input holding n of them; nvec: the
// whole tensor, n | nvec for the two-shot); ctas: CTAs per rank, the same
// on every device (the ranks' CTA g own the same slice). Launched
// cooperatively; cudaErrorCooperativeLaunchTooLarge where the grid cannot
// be resident at once.
cudaError_t all_gather(int method, const CommArgs& a, long long svec, int ctas,
                       cudaStream_t stream);
cudaError_t reduce_scatter(int dtype, int method, const CommArgs& a, long long cvec, int ctas,
                           cudaStream_t stream);
cudaError_t all_reduce(int dtype, int method, const CommArgs& a, long long nvec, int ctas,
                       cudaStream_t stream);
// A [M, K] and B [K, N] row-major contiguous per rank; a_dtype bf16 with a
// bf16 or int8 B (K, N multiples of 8), or f32 with f32 (N a multiple of 4);
// out [M, N] and land [n, M, N] in A's dtype.
cudaError_t gemm_allreduce(int a_dtype, int b_dtype, const CommArgs& a, int M, int N, int K,
                           int ctas, cudaStream_t stream);
// The ring GEMMs, on the same operand types as gemm_allreduce (A [*, K] and
// B [K, N] row-major contiguous per rank; N a multiple of 8 in bf16, of 4
// in f32), cvec the 16-byte vectors of one rank's chunk. ag_gemm: in = A_r
// [m, K], M = n * m; out = each rank's symmetric gathered A [M, K]; out2 =
// each rank's C_r [M, N] = gathered A @ B_r. gemm_rs: in = A_r [M, K]; out2
// = each rank's partial [M, N] (local); land = each rank's symmetric (n -
// 1)-slot landing buffer [n - 1, M / n, N]; out = each rank's [M / n, N]
// rows of the sum.
cudaError_t ag_gemm(int a_dtype, int b_dtype, const CommArgs& a, long long cvec, int M, int N,
                    int K, int ctas, cudaStream_t stream);
cudaError_t gemm_rs(int a_dtype, int b_dtype, const CommArgs& a, long long cvec, int M, int N,
                    int K, int ctas, cudaStream_t stream);

// csrc/a2a.cu, the one-shot all-to-all: in = each rank's n chunks of
// chunk_bytes (chunk p for rank p), out = each rank's output of the same
// size (chunk p from rank p). dispatch_a2a also moves in2 -> out2, n chunks
// of meta_bytes (a multiple of 8, 8-byte aligned), in the same launch.
cudaError_t all_to_all(const CommArgs& a, long long chunk_bytes, int ctas, cudaStream_t stream);
cudaError_t dispatch_a2a(const CommArgs& a, long long chunk_bytes, long long meta_bytes,
                         int ctas, cudaStream_t stream);

// csrc/ep_fused.cu, the fused EP-MoE. In c: in = each rank's send slabs x
// [n, E, cap, D] (dtype: bf16 or f32), in2 = w_gu [E, D, 2I] (w_dtype: x's,
// or int8 panels with scale = s_gu [E, 2I] f32; null scales otherwise), out
// = each rank's y_back [n, E, cap, D], out2 = each rank's h [E, n*cap, I]
// (scratch), land = each rank's landing buffer recv [E, n*cap, D]; wd =
// w_d [E, I, D] (w_dtype) and sd = its scales [E, D] f32 (int8 panels).
// All contiguous; D and I multiples of 8 (bf16) or 4 (f32).
struct EpFusedArgs {
  CommArgs c;
  const void* wd[kMaxRanks];
  const float* sd[kMaxRanks];
  int E, cap, D, I;
};
cudaError_t ep_moe_fused(int dtype, int w_dtype, const EpFusedArgs& a, int ctas,
                         cudaStream_t stream);

// The tensor-parallel MoE comm GEMMs (csrc/moe_tile.cuh; ag_group_gemm.cu,
// moe_reduce_rs.cu, moe_reduce_ar.cu), per expert e C_e = A_e [M, K] @ B_e
// [K, N] in one dtype (bf16 or f32), A packed [E, M, K]. c.in2[r] is rank r's
// B: expert e's panel at e * b_es[r], rows at stride b_ld[r] (elements), its
// columns [0, split) there and [split, N) from b1[r] (ag_group_gemm's two
// column blocks; split == N and b1 null otherwise).
// ag_group_gemm: c.in = each rank's chunk [E, M / n, K] (cv: the 16-byte
// vectors of one expert's chunk); c.out = each rank's symmetric gathered
// [E, M, K]; c.out2 = each rank's C [E, M, N].
// moe_reduce_rs: c.in = each rank's A; c.out2 = its partial [n, E, M / n,
// N] (local); c.land = its symmetric (n - 1)-slot landing buffer; c.out =
// its rows of the sum [E, M / n, N] (cvec: the vectors of one chunk, E M N
// / n of them).
// moe_reduce_ar: c.in = each rank's A; c.land = its symmetric landing
// buffer [n, E, M, N]; c.out = each rank's sum [E, M, N].
struct MoeCommArgs {
  CommArgs c;
  const void* b1[kMaxRanks];
  long long b_es[kMaxRanks], b_ld[kMaxRanks];
  int E, M, N, K, split;
};
// the shapes they take: N, split and N - split multiples of the 16-byte
// vector (8 bf16, 4 f32), and in bf16 K and the B strides multiples of 8
inline bool moe_shapes_ok(int dtype, const MoeCommArgs& m) {
  const int v = dtype == kBF16 ? 8 : 4;
  if (m.N % v || m.split % v || m.split < 1 || m.split > m.N || m.K < 1) return false;
  if (dtype != kBF16) return true;
  if (m.K % 8) return false;
  for (int r = 0; r < m.c.n; ++r)
    if (m.b_es[r] % 8 || m.b_ld[r] % 8) return false;
  return true;
}
cudaError_t ag_group_gemm(int dtype, const MoeCommArgs& m, long long cv, int ctas,
                          cudaStream_t stream);
cudaError_t moe_reduce_rs(int dtype, const MoeCommArgs& m, long long cvec, int ctas,
                          cudaStream_t stream);
cudaError_t moe_reduce_ar(int dtype, const MoeCommArgs& m, int ctas, cudaStream_t stream);

// The sequence-parallel kernels.
// csrc/lse_combine.cu, the one-shot LSE merge of split-KV partials: in =
// each rank's acc [R, d] f32, in2 = its stats [2, R] f32 (row 0 m, row 1 l);
// land = each rank's symmetric landing buffer [n, R, d] f32, out2 = its
// symmetric stats landing [n, 2, R] f32; out = each rank's merged [R, d]
// f32. d a multiple of 4, every pointer 16-byte aligned.
cudaError_t lse_combine(const CommArgs& a, int R, int d, int ctas, cudaStream_t stream);
// csrc/kv_scatter.cu, the fill of a sequence-sharded cache: in = each rank's
// block [BH, s_loc, row] of new K or V, out = each rank's cache window [BH,
// t_loc, row] (updated in place); rows of row_vec 16-byte vectors;
// t_loc a multiple of s_loc, n * s_loc <= n * t_loc.
cudaError_t kv_scatter(const CommArgs& a, int BH, int s_loc, int t_loc, long long row_vec,
                       int ctas, cudaStream_t stream);
// csrc/ring_attn.cu, causal (or full) ring attention over sequence shards:
// c.in = each rank's folded q [X, rows, HD] (rows = s_loc * rep), c.in2 =
// its k [X, s_loc, HD], v = its v; c.land / land_v = each rank's symmetric
// double-buffered landing slots [2, X, s_loc, HD] for k and v; outputs
// (unnormalised, f32) c.out = acc [X, rows, HD], m, l [X, rows]. dtype bf16
// or f32 (q, k, v, the slots alike); HD 64 or 128.
struct RingAttnArgs {
  CommArgs c;
  const void* v[kMaxRanks];
  void* land_v[kMaxRanks];
  float* m[kMaxRanks];
  float* l[kMaxRanks];
  int X, rows, s_loc, rep, causal;
  float scale;
};
cudaError_t ring_attn(int dtype, int HD, const RingAttnArgs& r, int ctas, cudaStream_t stream);

// The pipeline handoff and the Ulysses kernels.
// csrc/p2p.cu, the cyclic neighbour put: in = each rank's buffer of `bytes`,
// out = each rank's output of the same size; rank r's buffer lands in rank
// (r + 1) % n's output ((r - 1) % n when reverse), as raw bytes.
cudaError_t p2p_shift(const CommArgs& a, long long bytes, int reverse, int ctas,
                      cudaStream_t stream);
// csrc/gemm_a2a.cu, the QKV projection fused with the Ulysses dispatch: in =
// each rank's a [m, K], in2 = its w [K, n * Nc], out = each rank's [n, m, Nc]
// (slot p: rank p's rows times the rank's column chunk), all row-major and
// contiguous; dtype bf16 (K and Nc multiples of 8) or f32 (Nc of 4).
cudaError_t gemm_all_to_all(int dtype, const CommArgs& a, int m, int Nc, int K, int ctas,
                            cudaStream_t stream);
// csrc/a2a_gemm.cu, the Ulysses combine fused with the O projection: in = each
// rank's x [n, m, Nc] (chunk p for rank p), in2 = its w [n * Nc, D], land =
// each rank's symmetric landing buffer [n, m, Nc], out = each rank's y [m, D],
// all row-major and contiguous; dtype bf16 (Nc and D multiples of 8) or f32
// (Nc of 4).
cudaError_t o_a2a_gemm(int dtype, const CommArgs& a, int m, int Nc, int D, int ctas,
                       cudaStream_t stream);

}  // namespace tdt
