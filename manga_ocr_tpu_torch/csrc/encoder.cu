// Encoder kernels: the pieces of the attention layer (kernel A, int8 or
// bf16 projections), the int8 MLP block (kernel B) and the attention cores
// of the packed attention (kernel E) and the head-major SDPA (kernel G) of
// the ViT encoder.
//
// Replaces (Pallas, TPU):
//   A  manga_ocr_tpu/ops/flash_attention.py  fused_attn_layer -> _attn_layer_kernel
//      -> _attn_core: x + O(SDPA(LN1(x))) with W8A8 or bf16 q/k/v/o projections,
//      the SDPA in its default form or its sdpa_int8 form (attention_int8_kernel);
//   B  manga_ocr_tpu/ops/fused_mlp.py  fused_mlp_block -> _kernel_int8:
//      x + fc2(GELU(fc1(LN2(x)))) with W8A8 fc1/fc2;
//   E  manga_ocr_tpu/ops/flash_attention.py  attention_packed -> _packed_kernel:
//      SDPA alone on q/k/v [B, S, H*dh] straight from the bf16 projections
//      (the unquantized serving encoder), softmax by division, bf16 out;
//   G  manga_ocr_tpu/ops/flash_attention.py  fused_attention -> _attn_kernel:
//      SDPA alone on q/k/v [B, H, S, dh] (encode(fused_attention=True)),
//      softmax by division, bf16 out.
//
// The TPU kernels keep a whole batch block and every weight in VMEM and run
// one kernel per layer half.  Here each layer half is a short chain of
// kernels that share three building blocks (the whole blocks of kernels H
// and I chain the same pieces from C++, csrc/encoder_layer.cu):
//
//   ln_quant_rows  optional LN (f32 stats) then per-row int8 quantization,
//                  each row held in registers by a warp (a row of up to
//                  8 x 32 16-byte chunks: K = 768 in bf16 or f32) or by 2,
//                  4 or 8 warps (B's second quantization, over 3072 f32
//                  GELU outputs: the row max spans the whole row, so it runs
//                  after fc1 has written them), 16-byte loads, shuffle
//                  reductions.  Bound: bytes (reads 2-4 B, writes 1 B per
//                  element).  Limits: K % 8 == 0 and K <= 2048 chunks of 16
//                  bytes (8192 f32 values), 16-byte aligned x and LN
//                  parameters, 8-byte aligned q.
//   int8_gemm      the int8 products with their dequant epilogues: csrc/
//                  gemm_int8.cu (mocr_int8_gemm, on gemm_sm90.cuh's TMA +
//                  wgmma pipeline).
//   attention      the SDPA core of A (_attn_core), E (_packed_kernel), G
//                  (_attn_kernel) and the attention half of H and I: f32
//                  logits of bf16 q.k scaled by 1/sqrt(dh), keys >= valid_len
//                  masked, softmax exp(s - max) * (1/sum) for A and H and
//                  exp(s - max) / sum for E, G and I, p rounded to bf16, PV
//                  in f32, the context written in f32 (int8 A, H, I, which
//                  row-quantize it next) or bf16 (bf16 A, E, G).  q, k, v
//                  and the output are addressed by (batch, head, row)
//                  strides, so one core reads A's q|k|v GEMM output, E's
//                  three [B, S, D] tensors and G's [B, H, S, dh] ones.
//                  One block per (batch row, head), 4 warps: K and V of the
//                  head staged whole in shared memory by cp.async (S = 197
//                  fits, so no online softmax), each warp a 16-row query
//                  tile at a time on the tensor cores (mma.sync m16n8k16
//                  with ldmatrix fragments for QK^T and PV), the score tile
//                  and the softmax in registers.  Bound: DRAM bytes (q, k, v
//                  read once, the context written once: ~310 MB, 0.09 ms at
//                  B=256, against ~31 GFLOP that mma.sync covers in about
//                  half that); what the design does about it: no pass of
//                  scores or probabilities through memory, V's copy in
//                  flight behind the first tiles' QK^T, and three blocks per
//                  SM (dh <= 64) to overlap one block's staging with
//                  another's products.
//
// Not carried over from the TPU kernels: the batch-group blocking against
// VMEM, A's 197 -> 200 and E's and G's 197 -> 256 sequence pads (the port
// runs S = 197 unpadded; the valid_len mask is kept for padded callers).
#include "common.cuh"
#include "entry.cuh"

using namespace mocr;

namespace {

// ---------------------------------------------------------------------------
// LN + per-row int8 quantization
// ---------------------------------------------------------------------------

// A row is held in registers by a group of ``wpr`` of the block's
// kRowWarps warps (one, two, four or eight): lane l of the group's warp w owns
// the row's 16-byte chunks g, g + 32 wpr, ... (g = 32 w + l), at most
// kChunks of them, each read with one 16-byte load.  Sums and the row max
// reduce by shuffles within a warp, then through shared memory across the
// group's warps.
constexpr int kRowWarps = 8;

// The sum (or max) of ``v`` over the row group of warp ``warp``; every
// thread of the block calls it (the barriers), ``red`` holds kRowWarps
// floats.
template <bool kMax>
__device__ __forceinline__ float group_reduce(float v, float* red, int warp, int wpr) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if (wpr == 1) return v;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  const int first = warp - warp % wpr;
  float r = red[first];
  for (int w = 1; w < wpr; ++w) r = kMax ? fmaxf(r, red[first + w]) : r + red[first + w];
  __syncthreads();  // red is free again
  return r;
}

template <typename T, int kChunks>
__global__ void __launch_bounds__(32 * kRowWarps)
    ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                         const float* __restrict__ ln_bias, int do_ln, float eps,
                         int8_t* __restrict__ q, float* __restrict__ sx, int M, int K, int wpr) {
  constexpr int E = 16 / sizeof(T);  // elements of a 16-byte chunk
  __shared__ float red[kRowWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (kRowWarps / wpr) + warp / wpr;
  const int g = 32 * (warp % wpr) + lane, stride = 32 * wpr, chunks = K / E;
  const bool live = row < M;  // rows past M still join the barriers
  const long long base = (long long)row * K;
  float v[kChunks][E];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = g + c * stride;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (live && i < chunks) raw = *reinterpret_cast<const uint4*>(x + base + (long long)i * E);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < E; ++j) v[c][j] = to_f32(e[j]);
  }
  if (do_ln) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int j = 0; j < E; ++j) s += v[c][j];  // chunks past K hold zeros
    const float mu = group_reduce<false>(s, red, warp, wpr) / (float)K;
    float var = 0.0f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (g + c * stride >= chunks) continue;
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float d = v[c][j] - mu;
        var += d * d;
      }
    }
    const float r = 1.0f / sqrtf(group_reduce<false>(var, red, warp, wpr) / (float)K + eps);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = g + c * stride;
      if (i >= chunks) continue;
      float sc[E], bi[E];
#pragma unroll
      for (int j = 0; j < E; j += 4) {
        *reinterpret_cast<float4*>(sc + j) =
            *reinterpret_cast<const float4*>(ln_scale + i * E + j);
        *reinterpret_cast<float4*>(bi + j) =
            *reinterpret_cast<const float4*>(ln_bias + i * E + j);
      }
#pragma unroll
      for (int j = 0; j < E; ++j)
        v[c][j] = __fadd_rn(__fmul_rn(__fmul_rn(v[c][j] - mu, r), sc[j]), bi[j]);
    }
  }
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
    if (g + c * stride < chunks)
#pragma unroll
      for (int j = 0; j < E; ++j) m = fmaxf(m, fabsf(v[c][j]));
  const float amax = fmaxf(group_reduce<true>(m, red, warp, wpr), 1e-8f);
  const float inv = 127.0f / amax;
  if (!live) return;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = g + c * stride;
    if (i >= chunks) continue;
    uint32_t packed[E / 4];
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      uint32_t p = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        p |= (uint32_t)(uint8_t)(int8_t)__float2int_rn(__fmul_rn(v[c][j + b], inv)) << (8 * b);
      packed[j / 4] = p;
    }
    if (E == 8)
      *reinterpret_cast<uint2*>(q + base + (long long)i * E) =
          make_uint2(packed[0], packed[E / 4 - 1]);
    else
      *reinterpret_cast<uint32_t*>(q + base + (long long)i * E) = packed[0];
  }
  if (g == 0) sx[row] = __fmul_rn(amax, kInv127);
}

// The smallest row group (warps per row) whose lanes hold the row in at
// most 8 chunks each, and the instantiation of that chunk count.
template <typename T>
int launch_ln_quant_rows(const void* x, const void* ln_scale, const void* ln_bias, int do_ln,
                         float eps, void* q_out, void* sx_out, int M, int K,
                         cudaStream_t stream) {
  const int chunks = K / (16 / (int)sizeof(T));
  int wpr = 1;
  while (wpr < kRowWarps && chunks > 32 * wpr * 8) wpr *= 2;
  const int per_lane = (chunks + 32 * wpr - 1) / (32 * wpr);
  if (per_lane > 8) return (int)cudaErrorInvalidValue;
  auto kernel = per_lane <= 2   ? ln_quant_rows_kernel<T, 2>
                : per_lane <= 3 ? ln_quant_rows_kernel<T, 3>
                : per_lane <= 4 ? ln_quant_rows_kernel<T, 4>
                : per_lane <= 6 ? ln_quant_rows_kernel<T, 6>
                                : ln_quant_rows_kernel<T, 8>;
  const int rows = kRowWarps / wpr;
  kernel<<<(M + rows - 1) / rows, 32 * kRowWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), do_ln, eps, static_cast<int8_t*>(q_out),
      static_cast<float*>(sx_out), M, K, wpr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Attention core: out[b, h, i, :] = softmax(q[b, h, i, :] k[b, h]^T * scale) v[b, h]
// ---------------------------------------------------------------------------

// Element strides of a (batch, head, row) addressed tensor; element c of
// row i of head h of batch item b is at b * b_ + h * h_ + i * s_ + c.
struct Strides {
  long long b_, h_, s_;
};

typedef __nv_bfloat16 bf16;

// The core: 4 warps per block, 16-row query tiles, keys in chunks of 16,
// at most CORE_CHUNKS chunks (the score tile of a query tile is held in
// registers whole).  Head dims up to 128 (multiples of 8), each run by the
// smallest of the DH = 16, 64, 128 forms that holds it (zero columns pad
// the rest).
constexpr int CORE_WARPS = 4, CORE_THREADS = 32 * CORE_WARPS, CORE_CHUNKS = 13;
constexpr int CORE_MAX_KEYS = 16 * CORE_CHUNKS, CORE_DH_MAX = 128;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// a / b for a softmax numerator a in [0, 1] and its row sum b >= 1, given
// rb = 1/b correctly rounded (__frcp_rn): q0 = a * rb, one residual step
// brings q within one ulp of a / b, and then (Markstein's theorem) the
// residual a - b q is exact and q + residual * rb rounds to the correctly
// rounded quotient -- what __fdiv_rn returns, in five instructions with no
// range check, as long as nothing underflows: a = 0 gives 0, and an a of at
// least e^kDivMinLogit (> 2^-58) is far from it (the sequence stays exact
// down to a ~ 2^-119); the caller divides smaller ones with __fdiv_rn.
constexpr float kDivMinLogit = -40.0f;

__device__ __forceinline__ float div_by_sum(float a, float b, float rb) {
  float q = __fmul_rn(a, rb);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), rb, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), rb, q);
}

// One block per (batch row, head); q, k and v share the input strides
// ``in`` (kernels A, H and I read the q|k|v GEMM output [B*S, 3D], kernel E
// three [B, S, D] tensors, kernel G three [B, H, S, dh] ones), the output
// has its own.
//
// K and V of the head are staged whole in shared memory by cp.async
// (K first, then V in a second group that lands while the first query
// tiles run QK^T and the softmax), rows padded to CORE_MAX_KEYS and head
// columns to DH with zeros (so every loop over keys runs its full,
// branch-free length), each row DH + 8 halves long so that the eight rows
// of an ldmatrix fall on eight different 16-byte bank groups.
// Each warp takes query tiles w, w + 4, ... of 16 rows, each copied by
// cp.async into the warp's own buffer while the warp works on the tile
// before it:
//   QK^T   Q and K fragments by ldmatrix.x4, mma.sync m16n8k16 into the
//          16 x 16*CORE_CHUNKS f32 score tile, held in registers;
//   mask   logits = s * scale (__fmul_rn), keys >= valid_len set to kNegInf
//          and the padded keys >= S to -inf (their p is exactly 0);
//   softmax row max and sum over each thread's columns and then across the
//          quad that holds the row (two __shfl_xor), p = expf(s - max),
//          divided by the sum (``divide``: E, G, I) or multiplied by its
//          reciprocal (A, H), rounded to bf16 and packed straight into the
//          A fragments of PV (the C layout of two neighbouring n8 tiles is
//          the m16n8k16 A layout), so p never touches shared memory;
//   PV     V fragments by ldmatrix.x4.trans, mma.sync into 16 x DH f32
//          accumulators; rows < S and columns < dh stored as float2 (f32
//          out: int8 A, H and I, which row-quantize it next) or bf16 pairs.
template <int DH>
__global__ void __launch_bounds__(CORE_THREADS, DH <= 64 ? 3 : 2)
attention_kernel(const bf16* __restrict__ qg, const bf16* __restrict__ kg,
                 const bf16* __restrict__ vg, Strides in, void* __restrict__ out, Strides os,
                 int out_bf16, int divide, int S, int H, int dh, int valid_len, float scale) {
  constexpr int LD = DH + 8;               // halves per staged row
  constexpr int ROW_CHUNKS = DH / 8;       // 16-byte chunks per staged row
  constexpr int KK = DH / 16;              // k16 steps of QK^T
  extern __shared__ __align__(16) unsigned char smem[];
  const int nch = (S + 15) >> 4;           // query tiles
  bf16* Ks = reinterpret_cast<bf16*>(smem);  // every chunk staged: zeros past S
  bf16* Vs = Ks + CORE_MAX_KEYS * LD;
  bf16* Qs = Vs + CORE_MAX_KEYS * LD;      // a 16-row query tile per warp
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in quad
  const long long in0 = b * in.b_ + h * in.h_, out0 = b * os.b_ + h * os.h_;

  // Stage rows [row0, row0 + rows) of a head tensor into ``dst`` (one
  // 16-byte piece per thread of ``lanes`` threads at a time), rows >= S and
  // columns >= dh zero-filled.
  const int dh_chunks = dh >> 3;
  auto stage = [&](bf16* dst, const bf16* src, int row0, int rows, int first, int lanes) {
    for (int idx = first; idx < rows * ROW_CHUNKS; idx += lanes) {
      const int r = idx / ROW_CHUNKS, c = idx % ROW_CHUNKS, j = row0 + r;
      const bool real = j < S && c < dh_chunks;
      cp_async16(dst + r * LD + c * 8, src + (real ? in0 + j * in.s_ + c * 8 : in0),
                 real ? 16 : 0);
    }
  };
  // group 0: K and each warp's first query tile; group 1: V
  bf16* Qw = Qs + warp * 16 * LD;  // this warp's query tile
  stage(Ks, kg, 0, CORE_MAX_KEYS, tid, CORE_THREADS);
  if (warp < nch) stage(Qw, qg, warp * 16, 16, lane, 32);
  cp_async_commit();
  stage(Vs, vg, 0, CORE_MAX_KEYS, tid, CORE_THREADS);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // ldmatrix row addresses of this lane: K (non-transposed, key rows x
  // head columns) gives the B fragments of two n8 key tiles for one k16
  // step; V (transposed) those of two n8 head-column tiles for one k16 key
  // chunk; Q (non-transposed) the A fragment of one k16 step.
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) << 3;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3), v_col = (lane >> 4) << 3;

  const int rounds = (nch + CORE_WARPS - 1) / CORE_WARPS;  // the same for every warp
  for (int it = 0; it < rounds; ++it) {
    const int tile = it * CORE_WARPS + warp;
    const bool active = tile < nch;
    const int r0 = tile * 16 + g, r1 = r0 + 8;  // this thread's two query rows
    uint32_t pa[CORE_CHUNKS][4];                // p of key chunk c as an A fragment
    if (active) {
      if (it > 0) {  // this tile's Q, copied during the last one
        cp_async_wait<0>();
        __syncwarp();
      }
      uint32_t qa[KK][4];
#pragma unroll
      for (int kk = 0; kk < KK; ++kk) ldmatrix_x4<false>(qa[kk], Qw + v_row * LD + kk * 16 + v_col);
      __syncwarp();  // every lane has its fragments: the buffer takes the next tile
      if (tile + CORE_WARPS < nch) stage(Qw, qg, (tile + CORE_WARPS) * 16, 16, lane, 32);
      cp_async_commit();
      // s[n][0..1]: row r0, keys 8n + 2t, +1; s[n][2..3]: row r1
      float s[2 * CORE_CHUNKS][4];
#pragma unroll
      for (int c = 0; c < CORE_CHUNKS; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[2 * c][e] = s[2 * c + 1][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KK; ++kk) {
          uint32_t kb[4];
          ldmatrix_x4<false>(kb, Ks + (c * 16 + k_row) * LD + kk * 16 + k_col);
          const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
          mma_bf16(s[2 * c], qa[kk], b0);
          mma_bf16(s[2 * c + 1], qa[kk], b1);
        }
      }
      // logits: every key scaled, then the n8 tiles that reach past
      // min(S, valid_len) masked (the hot loops stay free of branches)
#pragma unroll
      for (int n = 0; n < 2 * CORE_CHUNKS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = __fmul_rn(s[n][e], scale);
      float mn0 = INFINITY, mn1 = INFINITY;  // the rows' smallest logits (masked keys too)
      if (divide) {
#pragma unroll
        for (int n = 0; n < 2 * CORE_CHUNKS; ++n) {
          mn0 = fminf(mn0, fminf(s[n][0], s[n][1]));
          mn1 = fminf(mn1, fminf(s[n][2], s[n][3]));
        }
      }
      const int unmasked = min(S, valid_len);
#pragma unroll
      for (int n = 0; n < 2 * CORE_CHUNKS; ++n) {
        if (n * 8 + 8 > unmasked) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = n * 8 + 2 * t + (e & 1);
            if (j >= unmasked) s[n][e] = j >= S ? -INFINITY : kNegInf;
          }
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2 * CORE_CHUNKS; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
      }
      float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
      for (int n = 0; n < 2 * CORE_CHUNKS; ++n) {
        s[n][0] = expf(s[n][0] - mx0);
        s[n][1] = expf(s[n][1] - mx0);
        s[n][2] = expf(s[n][2] - mx1);
        s[n][3] = expf(s[n][3] - mx1);
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, o);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, o);
      }
      // every p is 0 or at least e^kDivMinLogit unless a logit lies further
      // below its row's max: then every p is divided the long way
      const bool tiny = mn0 - mx0 < kDivMinLogit || mn1 - mx1 < kDivMinLogit;
      if (divide && !tiny) {  // e / sum, exactly as IEEE division (div_by_sum)
        const float r0s = __frcp_rn(sum0), r1s = __frcp_rn(sum1);
#pragma unroll
        for (int n = 0; n < 2 * CORE_CHUNKS; ++n) {
          s[n][0] = div_by_sum(s[n][0], sum0, r0s);
          s[n][1] = div_by_sum(s[n][1], sum0, r0s);
          s[n][2] = div_by_sum(s[n][2], sum1, r1s);
          s[n][3] = div_by_sum(s[n][3], sum1, r1s);
        }
      } else if (divide) {
#pragma unroll
        for (int n = 0; n < 2 * CORE_CHUNKS; ++n) {
          s[n][0] = __fdiv_rn(s[n][0], sum0);
          s[n][1] = __fdiv_rn(s[n][1], sum0);
          s[n][2] = __fdiv_rn(s[n][2], sum1);
          s[n][3] = __fdiv_rn(s[n][3], sum1);
        }
      } else {
        const float inv0 = 1.0f / sum0, inv1 = 1.0f / sum1;
#pragma unroll
        for (int n = 0; n < 2 * CORE_CHUNKS; ++n) {
          s[n][0] = __fmul_rn(s[n][0], inv0);
          s[n][1] = __fmul_rn(s[n][1], inv0);
          s[n][2] = __fmul_rn(s[n][2], inv1);
          s[n][3] = __fmul_rn(s[n][3], inv1);
        }
      }
#pragma unroll
      for (int c = 0; c < CORE_CHUNKS; ++c) {
        pa[c][0] = pack_bf16x2(s[2 * c][0], s[2 * c][1]);
        pa[c][1] = pack_bf16x2(s[2 * c][2], s[2 * c][3]);
        pa[c][2] = pack_bf16x2(s[2 * c + 1][0], s[2 * c + 1][1]);
        pa[c][3] = pack_bf16x2(s[2 * c + 1][2], s[2 * c + 1][3]);
      }
    }
    if (it == 0) {  // V has landed before the first PV
      cp_async_wait<0>();
      __syncthreads();
    }
    if (active) {
      float o[DH / 8][4];
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < CORE_CHUNKS; ++c) {
#pragma unroll
        for (int np = 0; np < DH / 16; ++np) {
          uint32_t vb[4];
          ldmatrix_x4<true>(vb, Vs + (c * 16 + v_row) * LD + np * 16 + v_col);
          const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
          mma_bf16(o[2 * np], pa[c], b0);
          mma_bf16(o[2 * np + 1], pa[c], b1);
        }
      }
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        const int col = n * 8 + 2 * t;
        if (col >= dh) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? r1 : r0;
          if (row >= S) continue;
          const long long off = out0 + row * os.s_ + col;
          if (out_bf16)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
                __floats2bfloat162_rn(o[n][2 * half], o[n][2 * half + 1]);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
                make_float2(o[n][2 * half], o[n][2 * half + 1]);
        }
      }
    }
  }
}

template <int DH>
int launch_attention(const void* q, const void* k, const void* v, Strides in, void* out,
                     Strides os, int out_bf16, int divide, int B, int S, int H, int dh,
                     int valid_len, float scale, cudaStream_t stream) {
  const size_t smem = (2 * (size_t)CORE_MAX_KEYS + CORE_WARPS * 16) * (DH + 8) * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<DH><<<B * H, CORE_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), in,
      out, os, out_bf16, divide, S, H, dh, valid_len, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel A's sdpa_int8 core: QK^T and PV on int8 with dynamic quantization
// ---------------------------------------------------------------------------

constexpr int ATTN_THREADS = 256, ATTN_WARPS = ATTN_THREADS / 32, DH_MAX = 128;

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One block per (batch row, head), as the core above, with every
// quantization of the head inside the block:
//   - each key row over dh with quant_rows (k_q [S][dh] int8, sk [S]);
//   - v per output column over the valid_len real rows only (rows at or past
//     valid_len count as 0), amax at least 1e-8, v_q = rint(v * (127 / amax)),
//     v_scale = amax * (1/127); v_q kept TRANSPOSED [dh][S] so __dp4a runs
//     over four keys at a time in PV;
//   - per query row (one warp): q over dh with quant_rows, logits =
//     (acc * (sq * scale)) * sk[j] (exact int32 acc), keys >= valid_len
//     masked, softmax exp(s - max) * (1/sum) in f32, p row-quantized in f32
//     (no bf16 cast), ctx = (acc * sp) * v_scale[d] in f32, written f32 (int8
//     projections: row-quantized next) or bf16 (float projections).
// Every int32 sum is exact, so against the plain version only the f32
// softmax (summation order, expf) can move a value across a rounding
// boundary of p's quantization.  Shared rows of int8 are padded to an odd
// number of 32-bit words, so the lanes of a warp, reading one word of 32
// different rows, hit 32 different banks.
template <typename OutT>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_int8_kernel(const __nv_bfloat16* __restrict__ qg, const __nv_bfloat16* __restrict__ kg,
                      const __nv_bfloat16* __restrict__ vg, Strides in, OutT* __restrict__ out,
                      Strides os, int S, int H, int dh, int valid_len, float scale) {
  extern __shared__ __align__(16) int words[];
  const int ldk = (dh / 4) | 1;         // words per quantized key row
  const int s4 = (S + 3) / 4;           // words of four keys
  const int ldv = s4 | 1;               // words per transposed value column
  int* kq = words;                      // [S][ldk]
  int* vq = kq + S * ldk;               // [dh][ldv]
  float* sk = reinterpret_cast<float*>(vq + dh * ldv);  // [S]
  float* vscl = sk + S;                 // [dh]
  int* qq = reinterpret_cast<int*>(vscl + dh);          // [warps][dh / 4]
  float* ps = reinterpret_cast<float*>(qq + ATTN_WARPS * (dh / 4));  // [warps][S]
  int* pq = reinterpret_cast<int*>(ps + ATTN_WARPS * S);             // [warps][s4]
  __nv_bfloat16* vs = reinterpret_cast<__nv_bfloat16*>(pq + ATTN_WARPS * s4);  // [S][dh]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long in0 = b * in.b_ + h * in.h_, out0 = b * os.b_ + h * os.h_;
  const int n_valid = min(valid_len, S);

  // keys: one warp per row, quant_rows over dh (lanes hold d = lane + 32c)
  for (int j = warp; j < S; j += ATTN_WARPS) {
    float v[DH_MAX / 32], m = 0.0f;
#pragma unroll
    for (int c = 0; c < DH_MAX / 32; ++c) {
      const int d = lane + 32 * c;
      v[c] = d < dh ? __bfloat162float(kg[in0 + j * in.s_ + d]) : 0.0f;
      m = fmaxf(m, fabsf(v[c]));
    }
    const float amax = fmaxf(warp_max(m), 1e-8f);
    const float inv = 127.0f / amax;
    int8_t* row = reinterpret_cast<int8_t*>(kq + j * ldk);
#pragma unroll
    for (int c = 0; c < DH_MAX / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) row[d] = (int8_t)__float2int_rn(__fmul_rn(v[c], inv));
    }
    if (lane == 0) sk[j] = __fmul_rn(amax, kInv127);
  }
  // values: stage the head's rows, then per column its scale and its
  // transposed int8 column (keys past S, and rows past valid_len, are 0)
  for (int idx = threadIdx.x; idx < S * (dh / 2); idx += ATTN_THREADS) {
    const int j = idx / (dh / 2), c = idx % (dh / 2);
    *reinterpret_cast<__nv_bfloat162*>(vs + j * dh + 2 * c) =
        *reinterpret_cast<const __nv_bfloat162*>(vg + in0 + j * in.s_ + 2 * c);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dh; d += ATTN_THREADS) {
    float m = 0.0f;
    for (int j = 0; j < n_valid; ++j) m = fmaxf(m, fabsf(__bfloat162float(vs[j * dh + d])));
    const float amax = fmaxf(m, 1e-8f);
    const float inv = 127.0f / amax;
    vscl[d] = __fmul_rn(amax, kInv127);
    int8_t* col = reinterpret_cast<int8_t*>(vq + d * ldv);
    for (int j = 0; j < 4 * s4; ++j)
      col[j] = j < n_valid ? (int8_t)__float2int_rn(__fmul_rn(__bfloat162float(vs[j * dh + d]), inv))
                           : (int8_t)0;
  }
  __syncthreads();

  int* qw = qq + warp * (dh / 4);
  float* p = ps + warp * S;
  int* pw = pq + warp * s4;
  int8_t* qb = reinterpret_cast<int8_t*>(qw);
  int8_t* pb = reinterpret_cast<int8_t*>(pw);
  for (int i = warp; i < S; i += ATTN_WARPS) {
    float v[DH_MAX / 32], m = 0.0f;
#pragma unroll
    for (int c = 0; c < DH_MAX / 32; ++c) {
      const int d = lane + 32 * c;
      v[c] = d < dh ? __bfloat162float(qg[in0 + i * in.s_ + d]) : 0.0f;
      m = fmaxf(m, fabsf(v[c]));
    }
    const float qmax = fmaxf(warp_max(m), 1e-8f);
    const float qinv = 127.0f / qmax;
#pragma unroll
    for (int c = 0; c < DH_MAX / 32; ++c) {
      const int d = lane + 32 * c;
      if (d < dh) qb[d] = (int8_t)__float2int_rn(__fmul_rn(v[c], qinv));
    }
    __syncwarp();
    const float qscale = __fmul_rn(__fmul_rn(qmax, kInv127), scale);
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const int* kr = kq + j * ldk;
      int acc = 0;
      for (int c = 0; c < dh / 4; ++c) acc = __dp4a(qw[c], kr[c], acc);
      const float s = j < valid_len ? __fmul_rn(__fmul_rn((float)acc, qscale), sk[j]) : kNegInf;
      p[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < S; j += 32) {
      const float e = expf(p[j] - mx);
      p[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    float pm = 0.0f;
    for (int j = lane; j < S; j += 32) {
      p[j] = __fmul_rn(p[j], inv);
      pm = fmaxf(pm, p[j]);
    }
    const float pmax = fmaxf(warp_max(pm), 1e-8f);
    const float pinv = 127.0f / pmax;
    for (int j = lane; j < 4 * s4; j += 32)
      pb[j] = j < S ? (int8_t)__float2int_rn(__fmul_rn(p[j], pinv)) : (int8_t)0;
    __syncwarp();
    const float pscale = __fmul_rn(pmax, kInv127);
    for (int d = lane; d < dh; d += 32) {
      const int* vc = vq + d * ldv;
      int acc = 0;
      for (int c = 0; c < s4; ++c) acc = __dp4a(pw[c], vc[c], acc);
      store_out(out + out0 + i * os.s_ + d, __fmul_rn(__fmul_rn((float)acc, pscale), vscl[d]));
    }
    __syncwarp();
  }
}

template <typename OutT>
int launch_attention_int8(const void* q, const void* k, const void* v, Strides in, void* out,
                          Strides os, int B, int S, int H, int dh, int valid_len, float scale,
                          cudaStream_t stream) {
  const int s4 = (S + 3) / 4;
  const size_t smem = ((size_t)S * ((dh / 4) | 1) + (size_t)dh * (s4 | 1) + S + dh +
                       (size_t)ATTN_WARPS * (dh / 4 + S + s4)) * 4 + (size_t)S * dh * 2;
  cudaError_t err = cudaFuncSetAttribute(attention_int8_kernel<OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_int8_kernel<OutT><<<B * H, ATTN_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), in, static_cast<OutT*>(out), os, S, H, dh, valid_len,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel A's sdpa_int8 core on (batch, head, row) strides; arguments as
// mocr_attention's (no ``divide``: A's softmax multiplies by the reciprocal).
int mocr_attention_sdpa_int8(const void* q, const void* k, const void* v, long long in_b,
                             long long in_h, long long in_s, void* out, long long out_b,
                             long long out_h, long long out_s, int out_bf16, int B, int S, int H,
                             int dh, int valid_len, float scale, void* stream) {
  if (dh > DH_MAX || dh % 4 || (in_b | in_h | in_s) % 2) return (int)cudaErrorInvalidValue;
  const Strides in{in_b, in_h, in_s}, os{out_b, out_h, out_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_bf16 ? launch_attention_int8<__nv_bfloat16>(q, k, v, in, out, os, B, S, H, dh,
                                                         valid_len, scale, st)
                  : launch_attention_int8<float>(q, k, v, in, out, os, B, S, H, dh, valid_len,
                                                 scale, st);
}

int mocr_ln_quant_rows(const void* x, int x_is_bf16, const void* ln_scale, const void* ln_bias,
                       int do_ln, float eps, void* q_out, void* sx_out, int M, int K,
                       void* stream) {
  // 16-byte row chunks of x (and of the LN parameters), 8- or 4-byte
  // pieces of q
  if (M < 1 || K < 8 || K % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q_out) % 8 ||
      (do_ln && (reinterpret_cast<uintptr_t>(ln_scale) % 16 ||
                 reinterpret_cast<uintptr_t>(ln_bias) % 16)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return x_is_bf16 ? launch_ln_quant_rows<__nv_bfloat16>(x, ln_scale, ln_bias, do_ln, eps, q_out,
                                                         sx_out, M, K, st)
                   : launch_ln_quant_rows<float>(x, ln_scale, ln_bias, do_ln, eps, q_out, sx_out,
                                                 M, K, st);
}

int mocr_attention(const void* q, const void* k, const void* v, long long in_b, long long in_h,
                   long long in_s, void* out, long long out_b, long long out_h, long long out_s,
                   int out_bf16, int divide, int B, int S, int H, int dh, int valid_len,
                   float scale, void* stream) {
  // cp.async copies 16-byte pieces of q/k/v rows (element strides multiples
  // of 8, 16-byte bases); the output is written in pairs (even strides)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (dh < 8 || dh > CORE_DH_MAX || dh % 8 || S < 1 || S > CORE_MAX_KEYS ||
      (in_b | in_h | in_s) % 8 || bases % 16 || (out_b | out_h | out_s) % 2 ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return (int)cudaErrorInvalidValue;
  const Strides in{in_b, in_h, in_s}, os{out_b, out_h, out_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* launch = dh <= 16 ? launch_attention<16>
                 : dh <= 64 ? launch_attention<64>
                            : launch_attention<128>;
  return launch(q, k, v, in, out, os, out_bf16, divide, B, S, H, dh, valid_len, scale, st);
}

}  // extern "C"
