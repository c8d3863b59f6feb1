// Whole greedy decode in one launch (kernel C).
//
// Replaces (Pallas, TPU): manga_ocr_tpu/ops/decode_loop.py greedy_decode_loop
// -> _loop_call -> _decode_loop_kernel, in its serving form: bf16 weights,
// bf16 cross-K/V slabs, phased head (first maximum wins), one chain, no
// in-kernel cross-K/V projection.
//
// Greedy decode is batch-parallel: row b's token at step t depends only on
// row b's history.  So each block owns R rows (R = 1, 2, 4 or 8, chosen by
// the wrapper) and runs EVERY step for them, with
// no grid-wide synchronisation.  Per-row activations live in shared memory
// (x, the q|k|v or MLP hidden row, the attention context, the per-head
// scores); the self-attention K/V cache [L, B, steps, D] and the cross slabs
// [L, B, S, D] live in device memory; a block stops once all its rows are
// done.
//
// Bound on the H100: every block re-reads all decoder weights (~44 MB bf16
// at full width: two layers, the head transform and the 6144-wide vocab
// matrix) every step, from L2, and runs ~22 M multiply-adds per row per
// step on the CUDA cores.  The design keeps the weights in their [K, N]
// layout so each warp reads 128 contiguous bytes per k, and unrolls k so
// each thread keeps 16 loads in flight (with 4 the loop was bound by load
// latency).  Past that the per-row work binds: the time grows about
// linearly with R (measured: 326, 548, 836 ms for R = 1, 2, 4 at B=32), so
// the wrapper picks the smallest R that fits the grid in one wave of two
// blocks per SM.  Tensor-core products over a block's rows, and splitting
// the weights across a thread-block cluster, are the next steps.
//
// Numerics mirror the JAX kernel where greedy tokens depend on them:
//   - embedding: tok + pos rounded to bf16, then + type rounded to bf16;
//     LN in f32, cast to bf16 (a row gather replaces the TPU's one-hot
//     matmul, which is exact anyway);
//   - every projection: input rounded to bf16, f32 sum of exact bf16
//     products, then the f32 bias;
//   - attention: q rounded to bf16, f32 scores scaled by 1/sqrt(dh) after the
//     sum, softmax exp(s - max) * (1/sum), p rounded to bf16, f32 PV;
//   - residual x + bf16(out) in bf16, LN in f32, cast to bf16;
//   - both GELUs (MLP and head) are the A&S erf polynomial;
//   - argmax keeps the first maximum; PAD after EOS; lengths count BOS and
//     EOS; the optional ``stops`` force done at t + 2 >= stops[b].
#include <algorithm>

#include "rows.cuh"

using namespace mocr;

namespace {

constexpr int MAX_LAYERS = 4;
constexpr int DEC_THREADS = ROW_THREADS;
constexpr int DEC_WARPS = ROW_WARPS;

typedef __nv_bfloat16 bf16;

struct LayerW {
  const bf16* wqkv; const float* bqkv;  // [D, 3D], [3D]
  const bf16* wo;   const float* bo;    // [D, D]
  const float* slns; const float* slnb;
  const bf16* cwq;  const float* cbq;
  const bf16* cwo;  const float* cbo;
  const float* clns; const float* clnb;
  const bf16* w1;   const float* b1;    // [D, I]
  const bf16* w2;   const float* b2;    // [I, D]
  const float* mlns; const float* mlnb;
};
constexpr int LAYER_PTRS = 18;
constexpr int COMMON_PTRS = 16;

struct DecodeParams {
  const bf16* tok_emb;   // [V, D]
  const bf16* pos_emb;   // [>= steps, D]
  const bf16* tok_type;  // [D]
  const float* elns; const float* elnb;
  const bf16* twt; const float* tbt;  // head transform [D, D]
  const float* hlns; const float* hlnb;
  const bf16* wp; const float* bp;    // vocab projection [D, V]
  const bf16* cross_k; const bf16* cross_v;  // [L, B, S, D]
  bf16* cache_k; bf16* cache_v;              // [L, B, steps, D]
  const int* stops;                          // [B] or null
  LayerW layers[MAX_LAYERS];
  int B, D, H, I, V, L, S, steps, bos, eos, pad;
  float scale, eps;
};

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

template <int R>
__global__ void __launch_bounds__(DEC_THREADS)
decode_loop_kernel(DecodeParams p, int big_n, int ld_scores, int* __restrict__ tokens,
                   int* __restrict__ lengths) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  __shared__ float red_v[R * DEC_WARPS];
  __shared__ int red_i[R * DEC_WARPS];
  __shared__ int prev[R], done[R], lens[R], best[R];
  __shared__ float best_v[R];
  const int D = p.D;
  float* xs = sm;                  // [R][D]  residual stream (bf16 values)
  float* big = xs + R * D;         // [R][big_n]  q|k|v, MLP hidden, head hidden
  float* ctx = big + R * big_n;    // [R][D]  attention context / MLP output
  float* scores = ctx + R * D;     // [H][ld_scores]
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, p.B - row0);
  const int T = p.steps, S = p.S;

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
      float e = bf16_round(__bfloat162float(p.tok_emb[(long)prev[r] * D + d]) +
                           __bfloat162float(p.pos_emb[(long)t * D + d]));
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
      gemv<R>(xs, D, w.wqkv, w.bqkv, D, 3 * D, big, big_n);
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
      round_rows(ctx, D, D, R);
      gemv<R>(ctx, D, w.wo, w.bo, D, D, big, big_n);
      for (int r = 0; r < nrows; ++r)
        residual_ln(xs + r * D, big + r * big_n, D, w.slns, w.slnb, p.eps, red);

      // -- cross-attention over the encoder slabs -------------------------
      gemv<R>(xs, D, w.cwq, w.cbq, D, D, big, big_n);
      for (int r = 0; r < nrows; ++r) {
        const long base = ((long)l * p.B + row0 + r) * S * D;
        attend(big + r * big_n, p.cross_k + base, p.cross_v + base, S, D, p.H, p.scale, scores,
               ld_scores, ctx + r * D);
      }
      round_rows(ctx, D, D, R);
      gemv<R>(ctx, D, w.cwo, w.cbo, D, D, big, big_n);
      for (int r = 0; r < nrows; ++r)
        residual_ln(xs + r * D, big + r * big_n, D, w.clns, w.clnb, p.eps, red);

      // -- MLP (erf GELU) --------------------------------------------------
      gemv<R>(xs, D, w.w1, w.b1, D, p.I, big, big_n);
      for (int idx = threadIdx.x; idx < R * p.I; idx += blockDim.x) {
        float* v = big + (idx / p.I) * big_n + idx % p.I;
        *v = bf16_round(gelu_erf(*v));
      }
      __syncthreads();
      gemv<R>(big, big_n, w.w2, w.b2, p.I, D, ctx, D);
      for (int r = 0; r < nrows; ++r)
        residual_ln(xs + r * D, ctx + r * D, D, w.mlns, w.mlnb, p.eps, red);
    }

    // -- head: transform, erf GELU, LN, vocab matmul + first-max argmax -------
    head_hidden<R>(xs, D, nrows, p.twt, p.tbt, p.hlns, p.hlnb, D, p.eps, big, big_n, ctx, D, red);
    gemv_argmax<R>(ctx, D, p.wp, p.V, p.bp, D, 0, p.V, best, best_v, red_v, red_i);

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

template <int R>
int launch(const DecodeParams& p, int big_n, int ld_scores, int* tokens, int* lengths,
           cudaStream_t stream) {
  const size_t smem = ((size_t)R * (2 * p.D + big_n) + (size_t)p.H * ld_scores) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_loop_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (p.B + R - 1) / R;
  decode_loop_kernel<R><<<grid, DEC_THREADS, smem, stream>>>(p, big_n, ld_scores, tokens, lengths);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: COMMON_PTRS pointers (tok_emb, pos_emb, tok_type, elns, elnb, twt, tbt,
// hlns, hlnb, wp, bp, cross_k, cross_v, cache_k, cache_v, stops-or-null) then
// LAYER_PTRS per layer in LayerW order.  ints: B, D, H, I, V, L, S, steps,
// bos, eos, pad, rows_per_block.
int mocr_decode_loop(void** ptrs, int n_ptrs, int* ints, int n_ints, float scale, float eps,
                     void* tokens, void* lengths, void* stream) {
  if (n_ints != 12) return (int)cudaErrorInvalidValue;
  DecodeParams p = {};
  p.B = ints[0]; p.D = ints[1]; p.H = ints[2]; p.I = ints[3]; p.V = ints[4]; p.L = ints[5];
  p.S = ints[6]; p.steps = ints[7]; p.bos = ints[8]; p.eos = ints[9]; p.pad = ints[10];
  const int rows = ints[11];
  if (p.L > MAX_LAYERS || n_ptrs != COMMON_PTRS + LAYER_PTRS * p.L) return (int)cudaErrorInvalidValue;
  p.scale = scale;
  p.eps = eps;
  p.tok_emb = (const bf16*)ptrs[0]; p.pos_emb = (const bf16*)ptrs[1];
  p.tok_type = (const bf16*)ptrs[2]; p.elns = (const float*)ptrs[3];
  p.elnb = (const float*)ptrs[4]; p.twt = (const bf16*)ptrs[5]; p.tbt = (const float*)ptrs[6];
  p.hlns = (const float*)ptrs[7]; p.hlnb = (const float*)ptrs[8]; p.wp = (const bf16*)ptrs[9];
  p.bp = (const float*)ptrs[10]; p.cross_k = (const bf16*)ptrs[11];
  p.cross_v = (const bf16*)ptrs[12]; p.cache_k = (bf16*)ptrs[13]; p.cache_v = (bf16*)ptrs[14];
  p.stops = (const int*)ptrs[15];
  for (int l = 0; l < p.L; ++l) {
    void** q = ptrs + COMMON_PTRS + LAYER_PTRS * l;
    LayerW& w = p.layers[l];
    w.wqkv = (const bf16*)q[0]; w.bqkv = (const float*)q[1];
    w.wo = (const bf16*)q[2]; w.bo = (const float*)q[3];
    w.slns = (const float*)q[4]; w.slnb = (const float*)q[5];
    w.cwq = (const bf16*)q[6]; w.cbq = (const float*)q[7];
    w.cwo = (const bf16*)q[8]; w.cbo = (const float*)q[9];
    w.clns = (const float*)q[10]; w.clnb = (const float*)q[11];
    w.w1 = (const bf16*)q[12]; w.b1 = (const float*)q[13];
    w.w2 = (const bf16*)q[14]; w.b2 = (const float*)q[15];
    w.mlns = (const float*)q[16]; w.mlnb = (const float*)q[17];
  }
  const int big_n = std::max(3 * p.D, std::max(p.I, p.D));
  const int ld_scores = std::max(p.steps, p.S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tok = static_cast<int*>(tokens);
  int* len = static_cast<int*>(lengths);
  switch (rows) {
    case 1: return launch<1>(p, big_n, ld_scores, tok, len, st);
    case 2: return launch<2>(p, big_n, ld_scores, tok, len, st);
    case 4: return launch<4>(p, big_n, ld_scores, tok, len, st);
    case 8: return launch<8>(p, big_n, ld_scores, tok, len, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
