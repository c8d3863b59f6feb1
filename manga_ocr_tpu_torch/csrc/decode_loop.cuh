// Whole greedy decode in one launch (kernel C): the kernel, included by one
// source per form (decode_loop_{bf16,int8}{,_fuse}.cu, so the build's
// parallel nvcc runs compile the forms side by side); the C entry point is
// decode_loop.cu.
//
// Replaces (Pallas, TPU): manga_ocr_tpu/ops/decode_loop.py greedy_decode_loop
// -> _loop_call -> _decode_loop_kernel, in each of its forms: bf16 or int8
// (W8A8, ``int8_w``) decoder projections; precomputed bf16 cross-K/V slabs,
// or the slabs computed inside the launch from the raw encoder output
// (``fuse_kv``); the ``ablate`` stage mask; the MLP's erf or sigmoid GELU.
// The TPU's scheduling knobs (chains, vocab tiles, batch groups) have no
// counterpart: both head forms keep the first maximum.
//
// Greedy decode is batch-parallel: row b's token at step t depends only on
// row b's history.  So each block owns R rows (R = 1, 2, 4 or 8, chosen by
// the wrapper) and runs EVERY step for them, with
// no grid-wide synchronisation.  Per-row activations live in shared memory
// (x, the q|k|v or MLP hidden row, the attention context, the per-head
// scores, the int8 rows of int8_w); the self-attention K/V cache [L, B,
// steps, D] and the cross slabs [L, B, S, D] live in device memory; a block
// stops once all its rows are done.
//
// fuse_kv: before its first step, each block computes the slabs of its own
// rows, layer by layer, into a per-call buffer the wrapper allocates: the
// encoder's final LN of each raw row (f32 statistics, the decoder's eps),
// rounded to bf16, then the cross k and v projections as bf16 GEMVs over
// tiles of 8 encoder rows, plus the f32 bias, rounded to bf16.  A block reads
// only its own rows' slabs, so no grid-wide sync is needed; the slabs are
// never read before they are written, so no cache holds a stale line.  Only
// the s_valid real rows are computed and attended.
//
// Bound on the H100: every block re-reads all decoder weights (~44 MB bf16
// at full width, ~24 MB with int8 projections: two layers, the head
// transform and the 6144-wide vocab matrix) every step, from L2, and runs
// ~22 M multiply-adds per row per step on the CUDA cores.  The design keeps
// the weights in their [K, N] layout (int8: [K/4, N] words of four k) so
// each warp reads contiguous bytes per k, and unrolls k so each thread keeps
// 16 loads in flight (with 4 the loop was bound by load latency).  Past that
// the per-row work binds: the time grows about linearly with R (measured:
// 326, 548, 836 ms for R = 1, 2, 4 at B=32), so the wrapper picks the
// smallest R that fits the grid in one wave of two blocks per SM.  The
// fuse_kv prologue adds ~465 M multiply-adds per row (2 layers x K and V x
// 197 x 768^2) on the same GEMV.  Tensor-core products over a block's rows,
// and splitting the weights across a thread-block cluster, are the next steps.
//
// Numerics mirror the JAX kernel where greedy tokens depend on them:
//   - embedding: tok + pos rounded to bf16, then + type rounded to bf16;
//     LN in f32, cast to bf16 (a row gather replaces the TPU's one-hot
//     matmul, which is exact anyway; a token id past the vocab, which only
//     ablate "head" makes, embeds as a zero row, as the one-hot does);
//   - a bf16 projection: input rounded to bf16, f32 sum of exact bf16
//     products, then the f32 bias; an int8 projection: quant_rows of the
//     f32 input (the attention context and the GELU output are NOT rounded
//     to bf16 first), exact int32 sums, (acc * sx) * scale + bias;
//   - attention: q rounded to bf16, f32 scores scaled by 1/sqrt(dh) after the
//     sum, softmax exp(s - max) * (1/sum), p rounded to bf16, f32 PV;
//   - residual x + bf16(out) in bf16, LN in f32, cast to bf16;
//   - the MLP's GELU is the A&S erf polynomial or the sigmoid form; the
//     head's is erf;
//   - argmax keeps the first maximum; PAD after EOS; lengths count BOS and
//     EOS; the optional ``stops`` force done at t + 2 >= stops[b]; under
//     ablate "head" the next token is prev + 1.
#pragma once

#include <algorithm>

#include "rows.cuh"

namespace mocr {

typedef __nv_bfloat16 bf16;

constexpr int MAX_LAYERS = 4;
constexpr int DEC_THREADS = ROW_THREADS;
constexpr int DEC_WARPS = ROW_WARPS;
constexpr int KV_TILE = 8;  // fuse_kv: encoder rows per projection tile
// ablate bits (ops/decode_loop.py _STAGES)
constexpr int ABL_SELF = 1, ABL_CROSS = 2, ABL_MLP = 4, ABL_HEAD = 8;

// A projection's weight is bf16 [K, N] (bf16 form, scale null) or int8
// packed [K/4, N, 4] with f32 per-column scales (int8_w).
struct LayerW {
  const void* wqkv; const float* sqkv; const float* bqkv;  // [D, 3D], [3D], [3D]
  const void* wo;   const float* so;   const float* bo;    // [D, D]
  const float* slns; const float* slnb;
  const void* cwq;  const float* csq;  const float* cbq;
  const void* cwo;  const float* cso;  const float* cbo;
  const float* clns; const float* clnb;
  const void* w1;   const float* s1;   const float* b1;    // [D, I]
  const void* w2;   const float* s2;   const float* b2;    // [I, D]
  const float* mlns; const float* mlnb;
  const bf16* cwk; const float* cbk; const bf16* cwv; const float* cbv;  // fuse_kv, [D, D]
};
constexpr int LAYER_PTRS = 28;
constexpr int COMMON_PTRS = 19;
constexpr int N_INTS = 17;

struct DecodeParams {
  const bf16* tok_emb;   // [V, D]
  const bf16* pos_emb;   // [>= steps, D]
  const bf16* tok_type;  // [D]
  const float* elns; const float* elnb;
  const bf16* twt; const float* tbt;  // head transform [D, D]
  const float* hlns; const float* hlnb;
  const bf16* wp; const float* bp;    // vocab projection [D, V]
  bf16* cross_k; bf16* cross_v;       // [L, B, S, D]; written by the fuse_kv prologue
  bf16* cache_k; bf16* cache_v;       // [L, B, steps, D]
  const int* stops;                   // [B] or null
  const bf16* enc;                    // fuse_kv: [B, S_enc, D] raw encoder output
  const float* fns; const float* fnb; // fuse_kv: the encoder's final LN, or null
  LayerW layers[MAX_LAYERS];
  int B, D, H, I, V, L, S, steps, bos, eos, pad, S_enc, ablate, gelu_sigmoid;
  float scale, eps;
};

}  // namespace mocr

namespace {

using namespace mocr;

// ctx[d] = sum_j softmax_j(q_h . K[j, h] * scale) V[j, d] for one row, over
// keys j < n_keys; K/V rows have stride D.  q (f32) is rounded to bf16 in
// place first; ``scores`` is [H][>= n_keys] shared scratch.
__device__ void attend(float* q, const bf16* __restrict__ Kp, const bf16* __restrict__ Vp,
                       int n_keys, int D, int H, float scale, float* scores, int ld_scores,
                       float* ctx) {
  const int dh = D / H;
  for (int d = threadIdx.x; d < D; d += blockDim.x) q[d] = bf16_round(q[d]);
  __syncthreads();
  for (int idx = threadIdx.x; idx < H * n_keys; idx += blockDim.x) {
    const int h = idx / n_keys, j = idx % n_keys;
    const uint4* kr = reinterpret_cast<const uint4*>(Kp + (long)j * D + h * dh);
    const float* qh = q + h * dh;
    float s = 0.0f;
    for (int c = 0; c < dh / 8; ++c) {
      const uint4 u = kr[c];
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 kv = __bfloat1622float2(k2[e]);
        s += qh[8 * c + 2 * e] * kv.x;
        s += qh[8 * c + 2 * e + 1] * kv.y;
      }
    }
    scores[h * ld_scores + j] = __fmul_rn(s, scale);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = warp; h < H; h += DEC_WARPS) {
    float* sc = scores + h * ld_scores;
    float mx = -INFINITY;
    for (int j = lane; j < n_keys; j += 32) mx = fmaxf(mx, sc[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n_keys; j += 32) {
      const float e = expf(sc[j] - mx);
      sc[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int j = lane; j < n_keys; j += 32) sc[j] = bf16_round(__fmul_rn(sc[j], inv));
  }
  __syncthreads();
  for (int p = threadIdx.x; p < D / 2; p += blockDim.x) {
    const int h = (2 * p) / dh;  // dh is even: both lanes of a pair share h
    const float* sc = scores + h * ld_scores;
    const __nv_bfloat162* V2 = reinterpret_cast<const __nv_bfloat162*>(Vp) + p;
    float a0 = 0.0f, a1 = 0.0f;
    for (int j = 0; j < n_keys; ++j) {
      const float2 v = __bfloat1622float2(V2[(long)j * (D / 2)]);
      a0 += sc[j] * v.x;
      a1 += sc[j] * v.y;
    }
    ctx[2 * p] = a0;
    ctx[2 * p + 1] = a1;
  }
  __syncthreads();
}

// x = bf16(LN(bf16(x + bf16(add)))) for one row.
__device__ void residual_ln(float* x, const float* add, int D, const float* scale,
                            const float* bias, float eps, float* red) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) x[d] = bf16_round(x[d] + bf16_round(add[d]));
  __syncthreads();
  block_layer_norm(x, x, D, scale, bias, eps, red);
  for (int d = threadIdx.x; d < D; d += blockDim.x) x[d] = bf16_round(x[d]);
  __syncthreads();
}

__device__ void round_rows(float* buf, int ld, int n, int rows) {
  for (int idx = threadIdx.x; idx < rows * n; idx += blockDim.x) {
    float* v = buf + (idx / n) * ld + idx % n;
    *v = bf16_round(*v);
  }
  __syncthreads();
}

// The int8 rows of gemv_i8: [R][ld] bytes after the f32 buffers.
struct I8Scratch {
  int8_t* q;
  int ld;
  float* sx;
  float* red;
};

// out = in . W (+ bias) in the layer's form: gemv on bf16-valued inputs, or
// gemv_i8 on f32 ones.
template <int R, bool INT8>
__device__ void project(const float* in, int ld_in, const void* W, const float* s, const float* b,
                        int K, int N, float* out, int ld_out, const I8Scratch& i8) {
  if constexpr (INT8)
    gemv_i8<R>(in, ld_in, static_cast<const int8_t*>(W), s, b, K, N, out, ld_out, i8.q, i8.ld,
               i8.sx, i8.red);
  else
    gemv<R>(in, ld_in, static_cast<const bf16*>(W), b, K, N, out, ld_out);
}

// fuse_kv prologue: the cross-K/V slabs of rows [row0, row0 + nrows) for
// every layer, from the raw encoder rows, in tiles of KV_TILE positions.
// ``sm`` holds two [KV_TILE][D] f32 tiles.
__device__ void cross_kv_prologue(const DecodeParams& p, int row0, int nrows, float* sm,
                                  float* red) {
  const int D = p.D;
  float* in = sm;
  float* out = sm + KV_TILE * D;
  for (int r = 0; r < nrows; ++r) {
    const long b = row0 + r;
    for (int j0 = 0; j0 < p.S; j0 += KV_TILE) {
      const int n = min(KV_TILE, p.S - j0);
      for (int idx = threadIdx.x; idx < KV_TILE * D; idx += blockDim.x) {
        const int i = idx / D;
        in[idx] = i < n ? __bfloat162float(p.enc[(b * p.S_enc + j0 + i) * D + idx % D]) : 0.0f;
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        if (p.fns) block_layer_norm(in + i * D, in + i * D, D, p.fns, p.fnb, p.eps, red);
        for (int d = threadIdx.x; d < D; d += blockDim.x) in[i * D + d] = bf16_round(in[i * D + d]);
        __syncthreads();
      }
      for (int l = 0; l < p.L; ++l) {
        const LayerW& w = p.layers[l];
        for (int kv = 0; kv < 2; ++kv) {
          gemv<KV_TILE>(in, D, kv ? w.cwv : w.cwk, kv ? w.cbv : w.cbk, D, D, out, D);
          bf16* slab = (kv ? p.cross_v : p.cross_k) + ((l * p.B + b) * p.S + j0) * D;
          for (int idx = threadIdx.x; idx < n * D; idx += blockDim.x)
            slab[idx] = __float2bfloat16_rn(out[idx]);
          __syncthreads();
        }
      }
    }
  }
}

// FUSE and OPTS compile the fuse_kv prologue and the run-time ablate / GELU
// choice only into the kernels that use them: present in every kernel, they
// slowed the default bf16 loop by 4-14% (measured on the H100).  No minimum
// of blocks per SM: ptxas keeps the R = 1 kernels within 64 registers (two
// blocks per SM, as the wrapper's row choice assumes) by itself, and a cap of
// 64 slowed them by 3%; an explicit minimum of one let them take ~110
// registers (one block per SM, two waves at B=256).  Some int8_w and fuse_kv
// kernels of R >= 2 rows take more than 64 registers (ptxas -v, printed by
// chip_smoke.py): one block per SM there.
template <int R, bool INT8, bool FUSE, bool OPTS>
__global__ void __launch_bounds__(DEC_THREADS)
decode_loop_kernel(DecodeParams p, int big_n, int ld_scores, int* __restrict__ tokens,
                   int* __restrict__ lengths) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  __shared__ float red_v[R * DEC_WARPS];
  __shared__ int red_i[R * DEC_WARPS];
  __shared__ int prev[R], done[R], lens[R], best[R];
  __shared__ float best_v[R], qsx[R];
  const int D = p.D;
  float* xs = sm;                  // [R][D]  residual stream (bf16 values)
  float* big = xs + R * D;         // [R][big_n]  q|k|v, MLP hidden, head hidden
  float* ctx = big + R * big_n;    // [R][D]  attention context / MLP output
  float* scores = ctx + R * D;     // [H][ld_scores]
  const I8Scratch i8{reinterpret_cast<int8_t*>(scores + p.H * ld_scores), big_n, qsx, red};
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, p.B - row0);
  const int T = p.steps, S = p.S;

  if constexpr (FUSE) {
    cross_kv_prologue(p, row0, nrows, sm, red);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < R * (2 * D + big_n); i += blockDim.x) sm[i] = 0.0f;
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    prev[r] = p.bos;
    done[r] = r < nrows ? 0 : 1;
    lens[r] = 1;
  }
  for (int idx = threadIdx.x; idx < nrows * (T + 1); idx += blockDim.x) {
    const int r = idx / (T + 1), c = idx % (T + 1);
    tokens[(long)(row0 + r) * (T + 1) + c] = c == 0 ? p.bos : p.pad;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    bool all_done = true;
    for (int r = 0; r < R; ++r) all_done = all_done && done[r];
    if (all_done) break;  // uniform: every thread reads the same flags

    // -- embedding + LN --------------------------------------------------
    for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
      const int r = idx / D, d = idx % D;
      // only ablate "head" makes an id past the vocab
      const float tok = !OPTS || prev[r] < p.V ? __bfloat162float(p.tok_emb[(long)prev[r] * D + d])
                                               : 0.0f;
      float e = bf16_round(tok + __bfloat162float(p.pos_emb[(long)t * D + d]));
      xs[r * D + d] = bf16_round(e + __bfloat162float(p.tok_type[d]));
    }
    __syncthreads();
    for (int r = 0; r < nrows; ++r) {
      block_layer_norm(xs + r * D, xs + r * D, D, p.elns, p.elnb, p.eps, red);
      for (int d = threadIdx.x; d < D; d += blockDim.x) xs[r * D + d] = bf16_round(xs[r * D + d]);
      __syncthreads();
    }

    for (int l = 0; l < p.L; ++l) {
      const LayerW& w = p.layers[l];
      // -- self-attention over the cache ---------------------------------
      if (!(OPTS && (p.ablate & ABL_SELF))) {
        project<R, INT8>(xs, D, w.wqkv, w.sqkv, w.bqkv, D, 3 * D, big, big_n, i8);
        for (int idx = threadIdx.x; idx < nrows * D; idx += blockDim.x) {
          const int r = idx / D, d = idx % D;
          const long o = (((long)l * p.B + row0 + r) * T + t) * D + d;
          p.cache_k[o] = __float2bfloat16_rn(big[r * big_n + D + d]);
          p.cache_v[o] = __float2bfloat16_rn(big[r * big_n + 2 * D + d]);
        }
        __syncthreads();
        for (int r = 0; r < nrows; ++r) {
          const long base = ((long)l * p.B + row0 + r) * T * D;
          attend(big + r * big_n, p.cache_k + base, p.cache_v + base, t + 1, D, p.H, p.scale,
                 scores, ld_scores, ctx + r * D);
        }
        if (!INT8) round_rows(ctx, D, D, R);
        project<R, INT8>(ctx, D, w.wo, w.so, w.bo, D, D, big, big_n, i8);
        for (int r = 0; r < nrows; ++r)
          residual_ln(xs + r * D, big + r * big_n, D, w.slns, w.slnb, p.eps, red);
      }

      // -- cross-attention over the encoder slabs -------------------------
      if (!(OPTS && (p.ablate & ABL_CROSS))) {
        project<R, INT8>(xs, D, w.cwq, w.csq, w.cbq, D, D, big, big_n, i8);
        for (int r = 0; r < nrows; ++r) {
          const long base = ((long)l * p.B + row0 + r) * S * D;
          attend(big + r * big_n, p.cross_k + base, p.cross_v + base, S, D, p.H, p.scale, scores,
                 ld_scores, ctx + r * D);
        }
        if (!INT8) round_rows(ctx, D, D, R);
        project<R, INT8>(ctx, D, w.cwo, w.cso, w.cbo, D, D, big, big_n, i8);
        for (int r = 0; r < nrows; ++r)
          residual_ln(xs + r * D, big + r * big_n, D, w.clns, w.clnb, p.eps, red);
      }

      // -- MLP (erf or sigmoid GELU) --------------------------------------
      if (!(OPTS && (p.ablate & ABL_MLP))) {
        project<R, INT8>(xs, D, w.w1, w.s1, w.b1, D, p.I, big, big_n, i8);
        for (int idx = threadIdx.x; idx < R * p.I; idx += blockDim.x) {
          float* v = big + (idx / p.I) * big_n + idx % p.I;
          const float g = OPTS && p.gelu_sigmoid ? gelu_sigmoid(*v) : gelu_erf(*v);
          *v = INT8 ? g : bf16_round(g);
        }
        __syncthreads();
        project<R, INT8>(big, big_n, w.w2, w.s2, w.b2, p.I, D, ctx, D, i8);
        for (int r = 0; r < nrows; ++r)
          residual_ln(xs + r * D, ctx + r * D, D, w.mlns, w.mlnb, p.eps, red);
      }
    }

    // -- head: transform, erf GELU, LN, vocab matmul + first-max argmax -------
    if (OPTS && (p.ablate & ABL_HEAD)) {
      if (threadIdx.x < R) best[threadIdx.x] = prev[threadIdx.x] + 1;
      __syncthreads();
    } else {
      head_hidden<R>(xs, D, nrows, p.twt, p.tbt, p.hlns, p.hlnb, D, p.eps, big, big_n, ctx, D,
                     red);
      gemv_argmax<R>(ctx, D, p.wp, p.V, p.bp, D, 0, p.V, best, best_v, red_v, red_i);
    }

    // -- bookkeeping -------------------------------------------------------
    if (threadIdx.x < nrows) {
      const int r = threadIdx.x, row = row0 + r;
      const int nxt = done[r] ? p.pad : best[r];
      tokens[(long)row * (T + 1) + t + 1] = nxt;
      if (!done[r]) lens[r] += 1;
      prev[r] = nxt;
      bool newly = nxt == p.eos;
      if (p.stops) newly = newly || (t + 2 >= p.stops[row]);
      done[r] = done[r] || newly;
    }
    __syncthreads();
  }
  if (threadIdx.x < nrows) lengths[row0 + threadIdx.x] = lens[threadIdx.x];
}

// Dynamic shared memory in floats (ops/decode_loop.py _smem_bytes).
size_t smem_floats(int R, const DecodeParams& p, int big_n, int ld_scores, bool int8) {
  const size_t main = (size_t)R * (2 * p.D + big_n) + (size_t)p.H * ld_scores +
                      (int8 ? (size_t)R * big_n / 4 : 0);
  return p.enc ? std::max(main, (size_t)2 * KV_TILE * p.D) : main;
}

template <int R, bool INT8, bool FUSE, bool OPTS>
int launch(const DecodeParams& p, int big_n, int ld_scores, int* tokens, int* lengths,
           cudaStream_t stream) {
  const size_t smem = smem_floats(R, p, big_n, ld_scores, INT8) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_loop_kernel<R, INT8, FUSE, OPTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (p.B + R - 1) / R;
  decode_loop_kernel<R, INT8, FUSE, OPTS><<<grid, DEC_THREADS, smem, stream>>>(
      p, big_n, ld_scores, tokens, lengths);
  return (int)cudaGetLastError();
}

template <bool INT8, bool FUSE, bool OPTS>
int launch_rows(int rows, const DecodeParams& p, int big_n, int ld_scores, int* tok, int* len,
                cudaStream_t st) {
  switch (rows) {
    case 1: return launch<1, INT8, FUSE, OPTS>(p, big_n, ld_scores, tok, len, st);
    case 2: return launch<2, INT8, FUSE, OPTS>(p, big_n, ld_scores, tok, len, st);
    case 4: return launch<4, INT8, FUSE, OPTS>(p, big_n, ld_scores, tok, len, st);
    case 8: return launch<8, INT8, FUSE, OPTS>(p, big_n, ld_scores, tok, len, st);
    default: return (int)cudaErrorInvalidValue;
  }
}


}  // namespace

namespace mocr {

// One form of kernel C (INT8: int8 decoder weights; FUSE: the fuse_kv
// prologue).  ``opts`` (an ablate mask or the sigmoid GELU) selects the
// kernel that reads them at run time, built for one row per block only.
template <bool INT8, bool FUSE>
int launch_decode_loop(bool opts, int rows, const DecodeParams& p, int big_n, int ld_scores,
                       int* tokens, int* lengths, cudaStream_t stream) {
  if (opts)
    return rows == 1 ? launch<1, INT8, FUSE, true>(p, big_n, ld_scores, tokens, lengths, stream)
                     : (int)cudaErrorInvalidValue;
  return launch_rows<INT8, FUSE, false>(rows, p, big_n, ld_scores, tokens, lengths, stream);
}

}  // namespace mocr
