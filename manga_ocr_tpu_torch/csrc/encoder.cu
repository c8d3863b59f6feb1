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
//   ln_quant_rows  one block per row: optional LN (f32 stats) then per-row
//                  int8 quantization.  The row max spans the whole row, so
//                  B's second quantization (over 3072 GELU outputs) runs
//                  after fc1 has written its f32 output.  Bound: bytes
//                  (reads 2-4 B, writes 1 B per element).
//   int8_gemm      int8 x int8 -> int32 on the tensor cores
//                  (mma.sync m16n8k32), 128x128x64 tiles in shared memory,
//                  fused f32 epilogue  y = (acc * sx[m]) * sw[n] + b[n]
//                  then one of the Int8Epilogue forms of entry.cuh (bf16
//                  out, a GELU with f32 out, bf16 out + bf16 residual, f32
//                  out).  The int32 sums are exact, so only epilogue
//                  rounding can differ from the plain version.  Bound: at
//                  B=256 (M = 50432) the products are large; this simple
//                  single-stage tile loop is bound by its own load latency
//                  well below the int8 tensor-core peak.  Pipelined loads
//                  (cp.async / TMA) and wgmma are the next steps.
//   attention      one block per (batch row, head): K and V of that head in
//                  shared memory, one warp per query row, f32 scores of bf16
//                  products scaled by 1/sqrt(dh), keys >= valid_len masked,
//                  softmax exp(s - max) * (1/sum) for A and H (_attn_core)
//                  and exp(s - max) / sum for E, G and I, p rounded to bf16,
//                  PV in f32, the context written in f32 (int8 A, which
//                  row-quantizes it next) or bf16 (bf16 A, E, G).  q, k, v
//                  and the output are addressed by (batch, head, row)
//                  strides, so one core reads A's q|k|v GEMM output, E's
//                  three [B, S, D] tensors and G's [B, H, S, dh] ones.
//                  Bound: exp and shared-memory reads; S=197 fits a head's
//                  K/V (51 KB) whole, so no online softmax is needed.
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

template <typename T>
__global__ void ln_quant_rows_kernel(const T* __restrict__ x, const float* __restrict__ ln_scale,
                                     const float* __restrict__ ln_bias, int do_ln, float eps,
                                     int8_t* __restrict__ q, float* __restrict__ sx, int K) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const long base = (long)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) row[i] = to_f32(x[base + i]);
  __syncthreads();
  if (do_ln) block_layer_norm(row, row, K, ln_scale, ln_bias, eps, red);
  float m = 0.0f;
  for (int i = threadIdx.x; i < K; i += blockDim.x) m = fmaxf(m, fabsf(row[i]));
  const float amax = fmaxf(block_max(m, red), 1e-8f);
  const float inv = 127.0f / amax;
  for (int i = threadIdx.x; i < K; i += blockDim.x)
    q[base + i] = (int8_t)__float2int_rn(__fmul_rn(row[i], inv));
  if (threadIdx.x == 0) sx[blockIdx.x] = __fmul_rn(amax, kInv127);
}

// ---------------------------------------------------------------------------
// int8 GEMM: out[M, N] = epilogue(A[M, K] . B_t[N, K]^T)
// ---------------------------------------------------------------------------

constexpr int BM = 128, BN = 128, BK = 64, LDS = BK + 16;  // 80-byte smem rows
constexpr int GEMM_THREADS = 256;

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(GEMM_THREADS)
int8_gemm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ Bt,
                 const float* __restrict__ sx, const float* __restrict__ sw,
                 const float* __restrict__ bias, const __nv_bfloat16* __restrict__ res,
                 void* __restrict__ out, int M, int N, int K, int mode) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // 128 rows x 64 bytes per operand = 512 16-byte chunks; 2 per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int c = tid + it * GEMM_THREADS;
      const int row = c >> 2, col = (c & 3) * 16;
      int4 va = make_int4(0, 0, 0, 0), vb = make_int4(0, 0, 0, 0);
      if (m0 + row < M) va = *reinterpret_cast<const int4*>(A + (long)(m0 + row) * K + k0 + col);
      if (n0 + row < N) vb = *reinterpret_cast<const int4*>(Bt + (long)(n0 + row) * K + k0 + col);
      *reinterpret_cast<int4*>(As + row * LDS + col) = va;
      *reinterpret_cast<int4*>(Bs + row * LDS + col) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp_m * 64 + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(As + r * LDS + kb + tq * 4);
        af[i][1] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * LDS + kb + tq * 4);
        af[i][2] = *reinterpret_cast<const uint32_t*>(As + r * LDS + kb + 16 + tq * 4);
        af[i][3] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * LDS + kb + 16 + tq * 4);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp_n * 32 + j * 8 + g;
        bfr[j][0] = *reinterpret_cast<const uint32_t*>(Bs + n * LDS + kb + tq * 4);
        bfr[j][1] = *reinterpret_cast<const uint32_t*>(Bs + n * LDS + kb + 16 + tq * 4);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], af[i], bfr[j]);
    }
    __syncthreads();
  }

  // epilogue: c0/c1 at (row g, cols 2tq, 2tq+1), c2/c3 at row g + 8
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + warp_m * 64 + i * 16 + g + half * 8;
      if (m >= M) continue;
      const float sxm = sx[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + warp_n * 32 + j * 8 + tq * 2;
        if (n >= N) continue;
        float y0 = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[i][j][half * 2], sxm), sw[n]), bias[n]);
        float y1 = __fadd_rn(__fmul_rn(__fmul_rn((float)acc[i][j][half * 2 + 1], sxm), sw[n + 1]),
                             bias[n + 1]);
        const long o = (long)m * N + n;
        if (mode == kI8GeluSigmoidF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(gelu_sigmoid(y0), gelu_sigmoid(y1));
        } else if (mode == kI8F32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
        } else if (mode == kI8GeluErfF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
              make_float2(gelu_erf(y0), gelu_erf(y1));
        } else {
          if (mode == kI8ResidualBf16) {
            const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + o);
            y0 = __fadd_rn(__bfloat162float(r.x), bf16_round(y0));
            y1 = __fadd_rn(__bfloat162float(r.y), bf16_round(y1));
          }
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Attention core: out[b, h, i, :] = softmax(q[b, h, i, :] k[b, h]^T * scale) v[b, h]
// ---------------------------------------------------------------------------

constexpr int ATTN_THREADS = 256, ATTN_WARPS = ATTN_THREADS / 32, DH_MAX = 128;

// Element strides of a (batch, head, row) addressed tensor; element c of
// row i of head h of batch item b is at b * b_ + h * h_ + i * s_ + c.
struct Strides {
  long long b_, h_, s_;
};

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One block per (batch row, head).  q, k and v share the input strides
// ``in`` (kernels A, H and I read the q|k|v GEMM output [B*S, 3D], kernel E
// three [B, S, D] tensors, kernel G three [B, H, S, dh] ones); the output
// has its own.  The softmax normalises with a reciprocal multiply (A's and
// H's _attn_core) or a division (E's _packed_kernel, G's _attn_kernel, I's
// _one_layer); the output is f32 (int8 A, H and I, which row-quantize it
// next) or bf16.
template <bool kDivide, typename OutT>
__global__ void __launch_bounds__(ATTN_THREADS)
attention_kernel(const __nv_bfloat16* __restrict__ qg, const __nv_bfloat16* __restrict__ kg,
                 const __nv_bfloat16* __restrict__ vg, Strides in, OutT* __restrict__ out,
                 Strides os, int S, int H, int dh, int valid_len, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ldk = dh + 2;  // +2 halves: conflict-free K row reads
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + S * ldk;
  float* qs = reinterpret_cast<float*>(Vs + S * dh);  // [warps][dh]
  float* ps = qs + ATTN_WARPS * dh;                   // [warps][S]
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long in0 = b * in.b_ + h * in.h_, out0 = b * os.b_ + h * os.h_;
  const int half_dh = dh / 2;

  for (int idx = threadIdx.x; idx < S * half_dh; idx += ATTN_THREADS) {
    const int j = idx / half_dh, c = idx % half_dh;
    const long long off = in0 + j * in.s_ + 2 * c;
    *reinterpret_cast<__nv_bfloat162*>(Ks + j * ldk + 2 * c) =
        *reinterpret_cast<const __nv_bfloat162*>(kg + off);
    *reinterpret_cast<__nv_bfloat162*>(Vs + j * dh + 2 * c) =
        *reinterpret_cast<const __nv_bfloat162*>(vg + off);
  }
  __syncthreads();

  float* q = qs + warp * dh;
  float* p = ps + warp * S;
  for (int i = warp; i < S; i += ATTN_WARPS) {
    for (int d = lane; d < dh; d += 32) q[d] = __bfloat162float(qg[in0 + i * in.s_ + d]);
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < S; j += 32) {
      const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(Ks + j * ldk);
      float s = 0.0f;  // bf16 x bf16 products are exact in f32
      for (int c = 0; c < half_dh; ++c) {
        const float2 kv = __bfloat1622float2(kr[c]);
        s += q[2 * c] * kv.x;
        s += q[2 * c + 1] * kv.y;
      }
      s = j < valid_len ? __fmul_rn(s, scale) : kNegInf;
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
    sum = warp_sum(sum);
    const float inv = 1.0f / sum;
    for (int j = lane; j < S; j += 32)
      p[j] = bf16_round(kDivide ? __fdiv_rn(p[j], sum) : __fmul_rn(p[j], inv));
    __syncwarp();
    for (int d = lane; d < dh; d += 32) {
      float acc = 0.0f;
      for (int j = 0; j < S; ++j) acc += p[j] * __bfloat162float(Vs[j * dh + d]);
      store_out(out + out0 + i * os.s_ + d, acc);
    }
    __syncwarp();
  }
}

template <bool kDivide, typename OutT>
int launch_attention(const void* q, const void* k, const void* v, Strides in, void* out,
                     Strides os, int B, int S, int H, int dh, int valid_len, float scale,
                     cudaStream_t stream) {
  const size_t smem = (size_t)S * (dh + 2) * 2 + (size_t)S * dh * 2 +
                      (size_t)ATTN_WARPS * dh * 4 + (size_t)ATTN_WARPS * S * 4;
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<kDivide, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<kDivide, OutT><<<B * H, ATTN_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), in, static_cast<OutT*>(out), os, S, H, dh, valid_len,
      scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Kernel A's sdpa_int8 core: QK^T and PV on int8 with dynamic quantization
// ---------------------------------------------------------------------------

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
  const size_t smem = (size_t)K * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    ln_quant_rows_kernel<__nv_bfloat16><<<M, 256, smem, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(ln_scale),
        static_cast<const float*>(ln_bias), do_ln, eps, static_cast<int8_t*>(q_out),
        static_cast<float*>(sx_out), K);
  } else {
    ln_quant_rows_kernel<float><<<M, 256, smem, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(ln_scale),
        static_cast<const float*>(ln_bias), do_ln, eps, static_cast<int8_t*>(q_out),
        static_cast<float*>(sx_out), K);
  }
  return (int)cudaGetLastError();
}

int mocr_int8_gemm(const void* a, const void* b_t, const void* sx, const void* sw,
                   const void* bias, const void* residual, void* out, int M, int N, int K,
                   int mode, void* stream) {
  if (K % BK || N % 2 || mode < kI8Bf16 || mode > kI8GeluErfF32) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_gemm_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(b_t),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<const __nv_bfloat16*>(residual), out, M, N, K,
      mode);
  return (int)cudaGetLastError();
}

int mocr_attention(const void* q, const void* k, const void* v, long long in_b, long long in_h,
                   long long in_s, void* out, long long out_b, long long out_h, long long out_s,
                   int out_bf16, int divide, int B, int S, int H, int dh, int valid_len,
                   float scale, void* stream) {
  // bf16 pairs are read as one 32-bit word: every offset must be even
  if (dh > DH_MAX || dh % 2 || (in_b | in_h | in_s) % 2) return (int)cudaErrorInvalidValue;
  const Strides in{in_b, in_h, in_s}, os{out_b, out_h, out_s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (divide)
    return out_bf16 ? launch_attention<true, __nv_bfloat16>(q, k, v, in, out, os, B, S, H, dh,
                                                            valid_len, scale, st)
                    : launch_attention<true, float>(q, k, v, in, out, os, B, S, H, dh,
                                                    valid_len, scale, st);
  return out_bf16 ? launch_attention<false, __nv_bfloat16>(q, k, v, in, out, os, B, S, H, dh,
                                                           valid_len, scale, st)
                  : launch_attention<false, float>(q, k, v, in, out, os, B, S, H, dh, valid_len,
                                                   scale, st);
}

}  // extern "C"
