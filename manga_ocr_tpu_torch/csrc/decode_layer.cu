// Attention cores of the fused whole-layer decode step (kernels J and K).
//
// Replaces (Pallas, TPU):
//   J  manga_ocr_tpu/ops/decode_layer.py  fused_self_attn_step -> _self_attn_kernel:
//      LN(x + O(SelfAttn(x))) for one decode step, the new K/V row written
//      into the packed [T, B, D] cache at ``step``, keys t <= step;
//   K  manga_ocr_tpu/ops/decode_layer.py  fused_cross_attn_step -> _cross_attn_kernel:
//      LN(x + O(CrossAttn(x))) over packed [B, S, D] cross-K/V, int8 with
//      per-(b, s) K scales and per-(b, d) V scales, or bf16.
//
// The TPU kernels run one Pallas call per layer half with a batch group and
// every weight in VMEM.  Here each layer half is a short chain (ops/
// decode_layer.py): the q|k|v (J) or q (K) projection through the repo's
// GEMMs with an f32-out epilogue (int8_gemm after ln_quant_rows, or
// bf16_gemm), one of the cores below, the out projection with the bf16
// residual epilogue, and ln_rows_bf16 for the post-LN.
//
//   self_attn_step   one block per (batch row, head).  It rounds its head's
//                    new k and v to bf16, writes them into cache row
//                    ``step`` and keeps them in shared memory, so key
//                    ``step`` is read back from the block's own fresh values
//                    and no block reads memory another block writes (a
//                    block reads only its own head's columns).  Scores in
//                    f32 from the f32 q (not rounded, as in the JAX kernel)
//                    times the bf16 keys, times 1/sqrt(dh); keys t > step
//                    weigh 0 (the -1e30 mask); softmax by exact division; p
//                    stays f32; the context is f32 (int8 weights: row
//                    quantized next) or bf16 (bf16 weights).
//   cross_attn_step  one block per (batch row, head): scores (q . K) * k_scale
//                    * 1/sqrt(dh), the s >= s_valid mask, softmax by division,
//                    context (sum p V) * v_scale; the scales apply after the
//                    contractions, as in the JAX kernel.
//
// Bound: bytes.  Per step a J core reads the live cache rows (t <= step) of
// K and V once, a K core the int8 (or bf16) slabs once; the arithmetic is
// two multiply-adds per byte.  One block per (row, head) with dh = 96 gives
// B * 8 blocks; a warp reads one key row (96 values) per pass and a thread
// one context channel, so the loads coalesce along the head's columns.
// Not carried over: the TPU's 0/1 segment matrix (a Mosaic workaround for
// 96-lane head slices).
#include "common.cuh"

using namespace mocr;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int STEP_THREADS = 128;

__device__ __forceinline__ float kv_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float kv_f32(int8_t x) { return (float)x; }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// p[0..n) holds the scores on entry and the softmax (exp(s - max) / sum,
// an exact division) on exit.  Called by the whole block.
__device__ __forceinline__ void block_softmax(float* p, int n, float* red) {
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, p[i]);
  m = block_max(m, red);
  float sum = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float e = expf(p[i] - m);
    p[i] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = __fdiv_rn(p[i], sum);
  __syncthreads();
}

// qkv [B, 3D] f32 (q | k | v); cache [T, B, D] bf16; ctx [B, D].
template <typename OutT>
__global__ void __launch_bounds__(STEP_THREADS)
self_attn_step_kernel(const float* __restrict__ qkv, bf16* __restrict__ ck,
                      bf16* __restrict__ cv, OutT* __restrict__ ctx, int B, int H, int dh,
                      int step, float scale) {
  extern __shared__ float sm[];  // q[dh] | k_new[dh] | v_new[dh] | p[step + 1]
  __shared__ float red[32];
  float* q = sm;
  float* kn = q + dh;
  float* vn = kn + dh;
  float* p = vn + dh;
  const int b = blockIdx.x / H, h = blockIdx.x % H, D = H * dh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const float* row = qkv + (long)b * 3 * D + h * dh;
  const long col = (long)b * D + h * dh;  // this head's columns in a [B, D] row
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    q[d] = row[d];
    const bf16 kb = __float2bfloat16_rn(row[D + d]), vb = __float2bfloat16_rn(row[2 * D + d]);
    kn[d] = __bfloat162float(kb);
    vn[d] = __bfloat162float(vb);
    ck[(long)step * B * D + col + d] = kb;
    cv[(long)step * B * D + col + d] = vb;
  }
  __syncthreads();
  for (int t = warp; t <= step; t += nwarps) {
    float s = 0.0f;
    if (t == step) {
      for (int d = lane; d < dh; d += 32) s += q[d] * kn[d];
    } else {
      const bf16* kr = ck + (long)t * B * D + col;
      for (int d = lane; d < dh; d += 32) s += q[d] * __bfloat162float(kr[d]);
    }
    s = warp_sum(s);
    if (lane == 0) p[t] = __fmul_rn(s, scale);
  }
  __syncthreads();
  block_softmax(p, step + 1, red);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < step; ++t) acc += p[t] * __bfloat162float(cv[(long)t * B * D + col + d]);
    acc += p[step] * vn[d];
    store_out(ctx + col + d, acc);
  }
}

// q [B, D] f32; K/V [B, S, D] int8 or bf16; k_scale [B, S], v_scale [B, D]
// f32 or null (bf16 K/V); ctx [B, D].
template <typename KV, typename OutT>
__global__ void __launch_bounds__(STEP_THREADS)
cross_attn_step_kernel(const float* __restrict__ qg, const KV* __restrict__ K,
                       const KV* __restrict__ V, const float* __restrict__ ks,
                       const float* __restrict__ vs, OutT* __restrict__ ctx, int S, int H,
                       int dh, int s_valid, float scale) {
  extern __shared__ float sm[];  // q[dh] | p[S]
  __shared__ float red[32];
  float* q = sm;
  float* p = q + dh;
  const int b = blockIdx.x / H, h = blockIdx.x % H, D = H * dh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const long col = (long)b * D + h * dh;
  const long base = (long)b * S * D + h * dh;  // key/value s of this head at base + s * D
  for (int d = threadIdx.x; d < dh; d += blockDim.x) q[d] = qg[col + d];
  __syncthreads();
  for (int s = warp; s < S; s += nwarps) {
    const KV* kr = K + base + (long)s * D;
    float acc = 0.0f;
    for (int d = lane; d < dh; d += 32) acc += q[d] * kv_f32(kr[d]);
    acc = warp_sum(acc);
    if (lane == 0) {
      if (ks != nullptr) acc = __fmul_rn(acc, ks[(long)b * S + s]);
      acc = __fmul_rn(acc, scale);
      p[s] = s < s_valid ? acc : kNegInf;
    }
  }
  __syncthreads();
  block_softmax(p, S, red);
  for (int d = threadIdx.x; d < dh; d += blockDim.x) {
    float acc = 0.0f;
    for (int s = 0; s < S; ++s) acc += p[s] * kv_f32(V[base + (long)s * D + d]);
    if (vs != nullptr) acc = __fmul_rn(acc, vs[col + d]);
    store_out(ctx + col + d, acc);
  }
}

// Dynamic shared memory above 48 KB must be allowed per kernel (a long
// cache or encoder sequence); returns a cudaError_t.
template <typename F>
int allow_smem(F kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

int mocr_self_attn_step(const void* qkv, void* cache_k, void* cache_v, void* ctx, int ctx_bf16,
                        int B, int T, int H, int dh, int step, float scale, void* stream) {
  if (step < 0 || step >= T || dh <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(3 * dh + step + 1) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* q = static_cast<const float*>(qkv);
  bf16* ck = static_cast<bf16*>(cache_k);
  bf16* cv = static_cast<bf16*>(cache_v);
  if (ctx_bf16) {
    int err = allow_smem(self_attn_step_kernel<bf16>, smem);
    if (err) return err;
    self_attn_step_kernel<bf16><<<B * H, STEP_THREADS, smem, st>>>(
        q, ck, cv, static_cast<bf16*>(ctx), B, H, dh, step, scale);
  } else {
    int err = allow_smem(self_attn_step_kernel<float>, smem);
    if (err) return err;
    self_attn_step_kernel<float><<<B * H, STEP_THREADS, smem, st>>>(
        q, ck, cv, static_cast<float*>(ctx), B, H, dh, step, scale);
  }
  return (int)cudaGetLastError();
}

int mocr_cross_attn_step(const void* q, const void* k, const void* v, const void* k_scale,
                         const void* v_scale, int kv_int8, void* ctx, int ctx_bf16, int B, int S,
                         int H, int dh, int s_valid, float scale, void* stream) {
  if (dh <= 0 || S <= 0 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(dh + S) * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
#define MOCR_CROSS(KV, OUT)                                                                   \
  do {                                                                                        \
    int err = allow_smem(cross_attn_step_kernel<KV, OUT>, smem);                              \
    if (err) return err;                                                                      \
    cross_attn_step_kernel<KV, OUT><<<B * H, STEP_THREADS, smem, st>>>(                       \
        qf, static_cast<const KV*>(k), static_cast<const KV*>(v), ks, vs,                     \
        static_cast<OUT*>(ctx), S, H, dh, s_valid, scale);                                    \
  } while (0)
  if (kv_int8) {
    if (ctx_bf16) MOCR_CROSS(int8_t, bf16); else MOCR_CROSS(int8_t, float);
  } else {
    if (ctx_bf16) MOCR_CROSS(bf16, bf16); else MOCR_CROSS(bf16, float);
  }
#undef MOCR_CROSS
  return (int)cudaGetLastError();
}

}  // extern "C"
