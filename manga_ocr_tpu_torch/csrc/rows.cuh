// Row-parallel GEMVs and the greedy LM head of the whole-decode kernel's
// forms on decode_loop.cuh (kernel C).
//
// A block of ROW_THREADS threads owns R rows held in shared memory as f32
// values that are already bf16-exact; the weights are bf16 [K, N] row-major
// in device memory (read through L2) and each thread walks one column pair
// over all of K, so every warp reads 128 contiguous bytes per k.  Products
// of two bf16 values are exact in f32, so only the f32 summation order can
// differ from a plain matmul.  gemv_i8 is the W8A8 form (kernel C's int8
// decoder): int32 sums are exact, so only its epilogue rounds.
#pragma once

#include "common.cuh"

namespace mocr {

constexpr int ROW_THREADS = 512;
constexpr int ROW_WARPS = ROW_THREADS / 32;

// out[r][n] = sum_k in[r][k] * W[k][n] + bias[n] for r < R.  ``in`` holds
// bf16-valued floats (rounded by the caller); W is [K, N] row-major bf16.
template <int R>
__device__ void gemv(const float* in, int ld_in, const __nv_bfloat16* __restrict__ W,
                     const float* __restrict__ bias, int K, int N, float* out, int ld_out) {
  const int half_n = N / 2;
  const __nv_bfloat162* W2 = reinterpret_cast<const __nv_bfloat162*>(W);
  for (int p = threadIdx.x; p < half_n; p += blockDim.x) {
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.0f;
#pragma unroll 16  // 16 independent loads in flight per thread
    for (int k = 0; k < K; ++k) {
      const float2 w = __bfloat1622float2(W2[(long)k * half_n + p]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = in[r * ld_in + k];
        acc[r][0] += a * w.x;  // bf16 x bf16 products are exact in f32
        acc[r][1] += a * w.y;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      out[r * ld_out + 2 * p] = acc[r][0] + bias[2 * p];
      out[r * ld_out + 2 * p + 1] = acc[r][1] + bias[2 * p + 1];
    }
  }
  __syncthreads();
}

// Per-row int8 quantization of R rows of K f32 values (kernel_utils.quant_rows):
// amax over the row (at least 1e-8), sx = amax * (1/127), q = rint(h * (127 /
// amax)), no clip.  q is [R][ld_q] int8, sx [R]; called by the whole block.
template <int R>
__device__ void quant_rows_block(const float* in, int ld_in, int K, int8_t* q, int ld_q,
                                 float* sx, float* red) {
#pragma unroll 1
  for (int r = 0; r < R; ++r) {
    float m = 0.0f;
    for (int k = threadIdx.x; k < K; k += blockDim.x) m = fmaxf(m, fabsf(in[r * ld_in + k]));
    const float amax = fmaxf(block_max(m, red), 1e-8f);
    const float inv = 127.0f / amax;
    for (int k = threadIdx.x; k < K; k += blockDim.x)
      q[r * ld_q + k] = (int8_t)__float2int_rn(__fmul_rn(in[r * ld_in + k], inv));
    if (threadIdx.x == 0) sx[r] = __fmul_rn(amax, kInv127);
  }
  __syncthreads();
}

// The W8A8 form of gemv: out[r][n] = (acc * sx[r]) * sw[n] + bias[n] with
// acc the exact int32 sum of the int8 rows quant_rows makes of in[r] (f32,
// NOT rounded to bf16 first) times W.  W is int8 packed [K/4][N][4]: a 32-bit
// word holds four consecutive k of one column, so each thread's __dp4a runs
// along K while a warp reads consecutive columns, as the bf16 gemv does.
// ``qbuf`` is [R][ld_q] int8 shared scratch (ld_q >= K, a multiple of 4) and
// ``sx`` [R] floats; K % 4 == 0, N even.
template <int R>
__device__ void gemv_i8(const float* in, int ld_in, const int8_t* __restrict__ W,
                        const float* __restrict__ sw, const float* __restrict__ bias, int K,
                        int N, float* out, int ld_out, int8_t* qbuf, int ld_q, float* sx,
                        float* red) {
  quant_rows_block<R>(in, ld_in, K, qbuf, ld_q, sx, red);
  const int half_n = N / 2, k4 = K / 4, ldq4 = ld_q / 4;
  const int2* W2 = reinterpret_cast<const int2*>(W);
  const int* q32 = reinterpret_cast<const int*>(qbuf);
  for (int p = threadIdx.x; p < half_n; p += blockDim.x) {
    int acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0;
#pragma unroll 16
    for (int k = 0; k < k4; ++k) {
      const int2 w = W2[(long)k * half_n + p];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int a = q32[r * ldq4 + k];
        acc[r][0] = __dp4a(a, w.x, acc[r][0]);
        acc[r][1] = __dp4a(a, w.y, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int n = 2 * p + c;
        out[r * ld_out + n] =
            __fadd_rn(__fmul_rn(__fmul_rn((float)acc[r][c], sx[r]), sw[n]), bias[n]);
      }
    }
  }
  __syncthreads();
}

// The vocab matmul fused with the argmax over columns [col0, col0 + ncols)
// of a [K, ldw] matrix: best[r] = first argmax_n of (in[r] . W[:, n] +
// bias[n]) and best_v[r] its value.  Columns are visited in increasing
// order with a strict >, and ties between threads go to the lower index, so
// the first maximum wins as in jnp.argmax.  col0, ncols and ldw are even.
template <int R>
__device__ void gemv_argmax(const float* in, int ld_in, const __nv_bfloat16* __restrict__ W,
                            int ldw, const float* __restrict__ bias, int K, int col0, int ncols,
                            int* best, float* best_v, float* red_v, int* red_i) {
  const int half_n = ncols / 2, half_ld = ldw / 2;
  const __nv_bfloat162* W2 = reinterpret_cast<const __nv_bfloat162*>(W + col0);
  const float* b = bias + col0;
  float bv[R];
  int bi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) { bv[r] = -INFINITY; bi[r] = 0x7fffffff; }
  for (int p = threadIdx.x; p < half_n; p += blockDim.x) {
    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.0f;
#pragma unroll 16  // 16 independent loads in flight per thread
    for (int k = 0; k < K; ++k) {
      const float2 w = __bfloat1622float2(W2[(long)k * half_ld + p]);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float a = in[r * ld_in + k];
        acc[r][0] += a * w.x;
        acc[r][1] += a * w.y;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v0 = acc[r][0] + b[2 * p], v1 = acc[r][1] + b[2 * p + 1];
      if (v0 > bv[r]) { bv[r] = v0; bi[r] = col0 + 2 * p; }
      if (v1 > bv[r]) { bv[r] = v1; bi[r] = col0 + 2 * p + 1; }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float v = bv[r];
    int i = bi[r];
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, v, o);
      const int oi = __shfl_xor_sync(0xffffffffu, i, o);
      if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
    }
    if (lane == 0) { red_v[r * ROW_WARPS + warp] = v; red_i[r * ROW_WARPS + warp] = i; }
  }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float v = red_v[r * ROW_WARPS];
    int i = red_i[r * ROW_WARPS];
    for (int w = 1; w < ROW_WARPS; ++w) {
      const float ov = red_v[r * ROW_WARPS + w];
      const int oi = red_i[r * ROW_WARPS + w];
      if (ov > v || (ov == v && oi < i)) { v = ov; i = oi; }
    }
    best[r] = i;
    best_v[r] = v;
  }
  __syncthreads();
}

// The head's transform for R rows: hbuf[r] = bf16(LN(gelu_erf(x[r] . Wt +
// bt))), with the f32 GELU output unrounded before the LN, as in the JAX
// head.  ``big`` is [R][>= D] scratch; rows past ``nrows`` are skipped by
// the LN (their hbuf rows are left as they were).
template <int R>
__device__ void head_hidden(const float* x, int ld_x, int nrows, const __nv_bfloat16* wt,
                            const float* bt, const float* lns, const float* lnb, int D,
                            float eps, float* big, int ld_big, float* hbuf, int ld_h,
                            float* red) {
  gemv<R>(x, ld_x, wt, bt, D, D, big, ld_big);
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    float* v = big + (idx / D) * ld_big + idx % D;
    *v = gelu_erf(*v);
  }
  __syncthreads();
  for (int r = 0; r < nrows; ++r) {
    block_layer_norm(big + r * ld_big, hbuf + r * ld_h, D, lns, lnb, eps, red);
    for (int d = threadIdx.x; d < D; d += blockDim.x) hbuf[r * ld_h + d] = bf16_round(hbuf[r * ld_h + d]);
    __syncthreads();
  }
}

}  // namespace mocr
