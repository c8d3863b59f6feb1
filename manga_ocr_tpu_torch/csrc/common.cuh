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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float erf_poly(float x) {
  float t = 1.0f / __fadd_rn(1.0f, __fmul_rn(0.3275911f, fabsf(x)));
  float p = __fmul_rn(1.061405429f, t);
  p = __fmul_rn(__fadd_rn(p, -1.453152027f), t);
  p = __fmul_rn(__fadd_rn(p, 1.421413741f), t);
  p = __fmul_rn(__fadd_rn(p, -0.284496736f), t);
  p = __fadd_rn(p, 0.254829592f);
  float y = __fadd_rn(1.0f, -__fmul_rn(__fmul_rn(p, t), expf(-__fmul_rn(x, x))));
  float s = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
  return __fmul_rn(s, y);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return __fmul_rn(__fmul_rn(0.5f, x),
                   __fadd_rn(1.0f, erf_poly(__fmul_rn(x, 0.7071067811865476f))));
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
