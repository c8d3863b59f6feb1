// Shared device numerics of the serving kernels.
//
// These are the formulas of manga_ocr_tpu_torch/ops/kernel_utils.py (and of
// the JAX package's ops/kernel_utils.py), written in the same order:
//   - LayerNorm statistics in f32, two passes (mean, then mean of squares of
//     the centred values), 1/sqrt with IEEE sqrt and division;
//   - per-row int8 quantization: sx = amax * (1/127), inv = 127/amax,
//     q = rint(h * inv) -- rintf rounds half to even like jnp.round (roundf
//     would round half away from zero and break int8 parity); no clip;
//   - the A&S 7.1.26 erf polynomial and both GELUs.
// Multiplies and adds whose rounding order matters use __fmul_rn/__fadd_rn,
// which nvcc never contracts into an FMA.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mocr {

constexpr float kNegInf = -1e30f;
constexpr float kInv127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The per-row int8 quantization (kernel_utils.quant_rows) in pieces, for
// kernels that take a row's max |x| across threads, warps or a cluster:
// amax = max(max |x|, 1e-8), inv = 127 / amax (one IEEE division), a value
// rint(x * inv) (half to even, no clip), sx = amax * (1/127).
__device__ __forceinline__ float quant_amax(float max_abs) { return fmaxf(max_abs, 1e-8f); }
__device__ __forceinline__ float quant_inv(float amax) { return 127.0f / amax; }
__device__ __forceinline__ float quant_sx(float amax) { return __fmul_rn(amax, kInv127); }
__device__ __forceinline__ signed char quant_i8(float x, float inv) {
  return (signed char)__float2int_rn(__fmul_rn(x, inv));
}

// c += a . b on the tensor cores: a 16x16 bf16 A fragment (row), a 16x8
// B fragment (col), f32 accumulators (the m16n8k16 register layouts).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a . b on the tensor cores in int8: a 16x32 s8 A fragment (row), a
// 32x8 B fragment (col), exact int32 sums (the m16n8k32 layouts: byte for
// byte those of m16n8k16 bf16).
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, past L1; ``bytes`` = 0 writes 16 zero bytes
// (and reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// ``W`` bytes (4, 8 or 16) global -> shared; both addresses W-aligned.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  static_assert(W == 4 || W == 8 || W == 16, "cp.async copies 4, 8 or 16 bytes");
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(W)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most ``N`` of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row (l & 7) of matrix (l >> 3), and r[m] is matrix m's fragment (``trans``:
// of the transposed matrix).
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_u32(p))
                 : "memory");
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 1/d as IEEE division gives it (correctly rounded), for d >= 1 or NaN,
// without the division's branch to its slow path: d is capped at 2^126
// (1/d stays normal; only d = inf or NaN reaches the cap, from x = +-inf or
// NaN in erf_poly, where exp(-x^2) makes t's value irrelevant), then one
// Newton step with FMAs on the hardware's approximate reciprocal.
__device__ __forceinline__ float rcp_ge1(float d) {
  d = fminf(d, 0x1p126f);
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(d));
  return __fmaf_rn(r, __fmaf_rn(-d, r, 1.0f), r);
}

// kRcp takes the polynomial's reciprocal by rcp_ge1 in place of the
// division: the same bits on every f32 input (gelu_erf<true> against
// gelu_erf<false>, checked exhaustively on the card by
// mocr_check_gelu_erf_rcp, csrc/mlp_bf16.cu), and branch-free, so the
// compiler can interleave many of them.  The bf16 GEMM's epilogue takes
// it (fc1 311 -> 406 TFLOP/s on an H100); kernel C's decode ran slower
// with it at small batch, so B, C and F keep the division.
template <bool kRcp = false>
__device__ __forceinline__ float erf_poly(float x) {
  const float d = __fadd_rn(1.0f, __fmul_rn(0.3275911f, fabsf(x)));
  float t = kRcp ? rcp_ge1(d) : 1.0f / d;
  float p = __fmul_rn(1.061405429f, t);
  p = __fmul_rn(__fadd_rn(p, -1.453152027f), t);
  p = __fmul_rn(__fadd_rn(p, 1.421413741f), t);
  p = __fmul_rn(__fadd_rn(p, -0.284496736f), t);
  p = __fadd_rn(p, 0.254829592f);
  float y = __fadd_rn(1.0f, -__fmul_rn(__fmul_rn(p, t), expf(-__fmul_rn(x, x))));
  float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(s, y);
}

template <bool kRcp = false>
__device__ __forceinline__ float gelu_erf(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x),
                   __fadd_rn(1.0f, erf_poly<kRcp>(__fmul_rn(x, 0.7071067811865476f))));
}

__device__ __forceinline__ float gelu_sigmoid(float x) {
  return x / __fadd_rn(1.0f, expf(__fmul_rn(-1.702f, x)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions; every thread gets the result.  ``red`` is a
// 32-float shared scratch; the trailing __syncthreads lets callers reuse it.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? red[lane] : 0.0f;
  r = warp_sum(r);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = lane < nwarps ? red[lane] : -INFINITY;
  r = warp_max(r);
  __syncthreads();
  return r;
}

// LayerNorm of one row held in shared memory (``x`` f32, length n), written
// to ``y`` (may alias x).  Called by the whole block.
__device__ __forceinline__ void block_layer_norm(const float* x, float* y, int n,
                                                 const float* scale, const float* bias,
                                                 float eps, float* red) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s += x[i];
  const float mu = block_sum(s, red) / (float)n;
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    float d = x[i] - mu;
    v += d * d;
  }
  const float var = block_sum(v, red) / (float)n;
  const float r = 1.0f / sqrtf(var + eps);
  __syncthreads();  // every thread has read x before y (maybe x) is written
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    y[i] = __fadd_rn(__fmul_rn(__fmul_rn(x[i] - mu, r), scale[i]), bias[i]);
  __syncthreads();
}

}  // namespace mocr
