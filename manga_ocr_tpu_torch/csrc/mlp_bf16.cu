// bf16 MLP block (kernel D): [LN ->] fc1 -> GELU -> fc2 -> + x [-> LN].
//
// Replaces (Pallas, TPU): manga_ocr_tpu/ops/fused_mlp.py fused_mlp_block ->
// _kernel_bf16, used by the unquantized encoder (pre-LN, [B*197, 768]
// rows) and by the step-by-step decoder (pre_ln=False, [B, 768] rows).  The
// TPU kernel keeps a token tile and both weight matrices in VMEM.  Here the
// block is a chain of two kernels:
//
//   ln_rows_bf16  one block per row: LN with f32 statistics, cast to bf16
//                 (the pre-LN of the encoder, or the post-LN form's
//                 LN(x + MLP(x))).  Bound: bytes.
//   bf16_gemm     bf16 x bf16 -> f32 on the tensor cores
//                 (mma.sync m16n8k16), 128x128x32 shared-memory tiles, the
//                 weights read in their [K, N] layout, rows masked at the
//                 ragged edge (the step form has M = B rows), with the
//                 epilogue of _kernel_bf16:
//                   fc1: y = acc + b1 (f32), GELU in f32 (the A&S erf
//                        polynomial or the sigmoid form), cast to bf16;
//                   fc2: y = acc + b2 (f32), cast to bf16, then + x in bf16;
//                 a plain f32-out epilogue y = acc + b for the decode
//                 step's bf16 projections (csrc/decode_layer.cu), and a
//                 plain bf16-out one, bf16(acc + b), for the bf16 q|k|v
//                 projection of kernels A, H and I (_attn_core's
//                 ``(dot + b).astype(x.dtype)``).
//                 The bf16 [M, 3072] intermediate goes through device
//                 memory (~310 MB at B=256).  Bound: at B=256 the products
//                 are large (2 x 50432 x 768 x 3072 multiply-adds); this
//                 single-stage tile loop is bound by its own load latency
//                 well below the bf16 tensor-core peak.  Pipelined loads
//                 (cp.async / TMA), wgmma and keeping the intermediate on
//                 chip are the next steps.
#include "common.cuh"
#include "entry.cuh"

using namespace mocr;

namespace {

typedef __nv_bfloat16 bf16;

__global__ void ln_rows_bf16_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_scale,
                                    const float* __restrict__ ln_bias, float eps,
                                    bf16* __restrict__ y, int K) {
  extern __shared__ float row[];
  __shared__ float red[32];
  const long base = (long)blockIdx.x * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) row[i] = __bfloat162float(x[base + i]);
  __syncthreads();
  block_layer_norm(row, row, K, ln_scale, ln_bias, eps, red);
  for (int i = threadIdx.x; i < K; i += blockDim.x) y[base + i] = __float2bfloat16_rn(row[i]);
}

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8;   // bf16 per A row in shared memory (80 bytes)
constexpr int LDB = BN + 8;   // bf16 per B row in shared memory (272 bytes)
constexpr int GEMM_THREADS = 256;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two bf16 values as one 32-bit register, ``lo`` in the low half (the
// lower k index, as the mma fragments expect).
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// out[M, N] = epilogue(A[M, K] . B[K, N] + bias[N]); A and B row-major
// bf16, K % 32 == 0, N % 8 == 0; out is bf16, or f32 for kBfF32.
__global__ void __launch_bounds__(GEMM_THREADS)
bf16_gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const float* __restrict__ bias, const bf16* __restrict__ res,
                 void* __restrict__ out, int M, int N, int K, int mode) {
  __shared__ __align__(16) bf16 As[BM * LDA];
  __shared__ __align__(16) bf16 Bs[BK * LDB];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warp_m = warp >> 2, warp_n = warp & 3;  // 2 x 4 warps: 64 x 32 each
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // A: 128 rows x 32 bf16 = 4 16-byte chunks a row; B: 32 rows x 128 bf16
    // = 16 chunks a row; 512 chunks each, 2 per thread
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int c = tid + it * GEMM_THREADS;
      const int ar = c >> 2, ac = (c & 3) * 8;
      uint4 va = make_uint4(0, 0, 0, 0);
      if (m0 + ar < M) va = *reinterpret_cast<const uint4*>(A + (long)(m0 + ar) * K + k0 + ac);
      *reinterpret_cast<uint4*>(As + ar * LDA + ac) = va;
      const int br = c >> 4, bc = (c & 15) * 8;
      uint4 vb = make_uint4(0, 0, 0, 0);
      if (n0 + bc < N) vb = *reinterpret_cast<const uint4*>(B + (long)(k0 + br) * N + n0 + bc);
      *reinterpret_cast<uint4*>(Bs + br * LDB + bc) = vb;
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < BK; kb += 16) {
      uint32_t af[4][4], bfr[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp_m * 64 + i * 16 + g;
        af[i][0] = *reinterpret_cast<const uint32_t*>(As + r * LDA + kb + tq * 2);
        af[i][1] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * LDA + kb + tq * 2);
        af[i][2] = *reinterpret_cast<const uint32_t*>(As + r * LDA + kb + 8 + tq * 2);
        af[i][3] = *reinterpret_cast<const uint32_t*>(As + (r + 8) * LDA + kb + 8 + tq * 2);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = warp_n * 32 + j * 8 + g;
        const int k = kb + tq * 2;
        bfr[j][0] = pack_bf16(Bs[k * LDB + n], Bs[(k + 1) * LDB + n]);
        bfr[j][1] = pack_bf16(Bs[(k + 8) * LDB + n], Bs[(k + 9) * LDB + n]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], af[i], bfr[j]);
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + warp_n * 32 + j * 8 + tq * 2;
        if (n >= N) continue;
        float y0 = __fadd_rn(acc[i][j][half * 2], bias[n]);
        float y1 = __fadd_rn(acc[i][j][half * 2 + 1], bias[n + 1]);
        const long o = (long)m * N + n;
        if (mode == kBfF32) {
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(y0, y1);
          continue;
        }
        if (mode == kBfGeluErf) {
          y0 = gelu_erf(y0);
          y1 = gelu_erf(y1);
        } else if (mode == kBfGeluSigmoid) {
          y0 = gelu_sigmoid(y0);
          y1 = gelu_sigmoid(y1);
        } else if (mode == kBfResidual) {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(res + o);
          y0 = __fadd_rn(__bfloat162float(r.x), bf16_round(y0));
          y1 = __fadd_rn(__bfloat162float(r.y), bf16_round(y1));
        }
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

}  // namespace

extern "C" {

int mocr_ln_rows_bf16(const void* x, const void* ln_scale, const void* ln_bias, float eps,
                      void* y, int M, int K, void* stream) {
  ln_rows_bf16_kernel<<<M, 256, (size_t)K * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), eps, static_cast<bf16*>(y), K);
  return (int)cudaGetLastError();
}

int mocr_bf16_gemm(const void* a, const void* b, const void* bias, const void* residual,
                   void* out, int M, int N, int K, int mode, void* stream) {
  if (K % BK || N % 8 || mode < kBfGeluErf || mode > kBfBias) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bf16_gemm_kernel<<<grid, GEMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<const float*>(bias),
      static_cast<const bf16*>(residual), out, M, N, K, mode);
  return (int)cudaGetLastError();
}

}  // extern "C"
