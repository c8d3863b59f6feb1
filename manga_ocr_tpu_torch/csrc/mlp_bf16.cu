// The bf16 GEMM of the port, and the bf16 LayerNorm row pass beside it.
//
// Replaces (Pallas, TPU), as the bf16 products of:
//   D  manga_ocr_tpu/ops/fused_mlp.py:188 fused_mlp_block -> _kernel_bf16
//      (fc1 + GELU, fc2 + residual; the encoder's pre-LN form on [B*197,
//      768] rows and the decoder step's forms on [B, 768] rows);
//   A  manga_ocr_tpu/ops/flash_attention.py:617 fused_attn_layer, bf16 form
//      (_attn_core's q|k|v ``(dot + b).astype(x.dtype)`` and o + residual);
//   H  manga_ocr_tpu/ops/flash_attention.py:770 fused_encoder_layer and
//   I  manga_ocr_tpu/ops/encoder_stack.py:190 encoder_stack, bf16 forms
//      (all four projections of a block, chained by csrc/encoder_layer.cu);
//   J, K  the f32-out q|k|v / q and residual o projections of the bf16
//      decode step (ops/decode_layer.py).
// The TPU kernels run these products on the MXU with the weights resident
// in VMEM.  Here each is one launch of ``bf16_gemm`` (mocr_bf16_gemm):
//
//   ln_rows_bf16  one block per row: LN with f32 statistics, cast to bf16
//                 (the pre-LN of the encoder, or the post-LN form's
//                 LN(x + MLP(x))).  Bound: bytes.
//   bf16_gemm     out[M, N] = epilogue(A[M, K] . B[K, N] + bias[N]), bf16
//                 operands, f32 accumulation, B read in the [K, N] layout
//                 the callers prepare.  The pipeline of gemm_sm90.cuh: TMA
//                 boxes with 128-byte swizzle into a ring of k-64 stages
//                 (A [BM rows][64 k], B [64 k][64 n] boxes), one producer
//                 thread, one or two consumer warpgroups issuing
//                 wgmma.m64nNk16 from shared memory (B through the
//                 transpose bit: the N-major operand), a persistent grid of
//                 one block per SM.  The epilogue works on the accumulators
//                 in registers and writes through a small staging buffer
//                 per warpgroup (Bf16Store), with the roundings of
//                 _kernel_bf16:
//                   GELU:     y = acc + b (f32), GELU in f32 (the A&S erf
//                             polynomial or the sigmoid form), cast to bf16;
//                   residual: bf16(acc + b), then + r in f32, cast to bf16;
//                   f32 out:  acc + b;   bias: bf16(acc + b).
//                 Only the f32 summation order of the product differs from
//                 the plain version (ops/fused_mlp.py bf16_gemm_reference).
//                 The erf polynomial's reciprocal is common.cuh's
//                 branch-free rcp_ge1 (gelu_erf<true>: the same bits as
//                 the division, on every f32 input: mocr_check_gelu_erf_rcp).
//
// Bound at B=256 (M = 256 x 197 = 50432 rows): operations.  The four
// products of an encoder block, q|k|v [768 -> 2304], o [768 -> 768], fc1
// [768 -> 3072] and fc2 [3072 -> 768], take 0.18 / 0.07 (bytes) / 0.24 /
// 0.24 ms at the bf16 tensor-core peak (989 TFLOP/s) and the memory rate.
// The design keeps the tensor cores fed: loads run up to a ring ahead of
// the products and of the previous tile's epilogue, one thread issues
// them, the wgmma products read the swizzled stages directly (no register
// staging, no ldmatrix), and 128 x 256 tiles read each loaded byte 128 or
// 256 times.  What it does not hide is the epilogue, which the consumers
// run between two tiles' products: the erf GELU's ~36 floating-point
// instructions a value make fc1's epilogue as long as its products.  The
// step shapes (M = 32..256 rows) are bound by reading the weights; they
// take 64-row tiles so that more SMs share those reads (pick_tile).
// Limits: K % 64 == 0, N % 8 == 0 (TMA's 16-byte row strides), M >= 1,
// A, B, residual and out 16-byte aligned, bias 8-byte aligned (kernels/
// launch.py bf16_gemm checks them; here they return cudaErrorInvalidValue).
#include <cuda.h>

#include "common.cuh"
#include "entry.cuh"
#include "gemm_sm90.cuh"

using namespace mocr;

namespace {

typedef __nv_bfloat16 bf16;
using sm90::Bf16Op;

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

// The epilogues of entry.cuh's Bf16Epilogue codes, with the roundings of
// _kernel_bf16: y = acc + bias in f32, then the GELU in f32 and bf16; or
// bf16(y) + residual in f32, then bf16; or y (f32); or bf16(y).  Written
// through the staging buffer in chunks of 64 columns (32 for kBfF32):
// gemm_sm90.cuh's Chunk.
struct Bf16Store {
  const float* bias;
  const bf16* res;
  void* out;
  int mode;

  static constexpr int kStagingBytes = sm90::Chunk<true>::kStagingBytes;

  // Every mode stores through the staging copy (no output tensor map).
  bool encode_out(CUtensorMap*, int, int) const { return true; }

  template <int MODE>
  __device__ __forceinline__ static void apply(float& y0, float& y1) {
    if (MODE == kBfGeluErf) {
      y0 = gelu_erf<true>(y0);
      y1 = gelu_erf<true>(y1);
    } else if (MODE == kBfGeluSigmoid) {
      y0 = gelu_sigmoid(y0);
      y1 = gelu_sigmoid(y1);
    }
  }

  template <int MODE, int NA>
  __device__ __forceinline__ void store(const float (&acc)[NA], int m0, int n0, int warp,
                                        int lane, uint8_t* stage, int bar, int M,
                                        int N) const {
    constexpr bool kF32 = MODE == kBfF32;
    typedef sm90::Chunk<kF32> C;
    static_assert(NA % (4 * C::kGroups) == 0, "whole chunks");
    const int tid = warp * 32 + lane, t = lane % 4, r0 = warp * 16 + lane / 4;
#pragma unroll
    for (int q = 0; q < NA / (4 * C::kGroups); ++q) {
      const int nc = n0 + C::kWidth * q;
      uint4 rv[C::kPasses];
      if (MODE == kBfResidual) sm90::load_residual<kF32>(rv, res, m0, nc, tid, M, N);
      float2 b[C::kGroups];
#pragma unroll
      for (int i = 0; i < C::kGroups; ++i) {
        const int n = nc + 8 * i + 2 * t;
        b[i] = n < N ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < C::kGroups; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = C::kGroups * q + i;
          float y0 = __fadd_rn(acc[4 * j + 2 * h], b[i].x);
          float y1 = __fadd_rn(acc[4 * j + 2 * h + 1], b[i].y);
          apply<MODE>(y0, y1);
          sm90::stage_pair<kF32>(stage, r0 + 8 * h, 8 * i + 2 * t, y0, y1);
        }
      }
      sm90::copy_out<kF32, MODE == kBfResidual>(stage, rv, out, m0, nc, tid, bar, M, N);
    }
  }

  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int m0, int n0, int warp,
                                             int lane, uint8_t* stage, int bar, int M, int N,
                                             const CUtensorMap*) const {
    switch (mode) {
      case kBfGeluErf: store<kBfGeluErf>(acc, m0, n0, warp, lane, stage, bar, M, N); break;
      case kBfGeluSigmoid:
        store<kBfGeluSigmoid>(acc, m0, n0, warp, lane, stage, bar, M, N);
        break;
      case kBfResidual: store<kBfResidual>(acc, m0, n0, warp, lane, stage, bar, M, N); break;
      case kBfF32: store<kBfF32>(acc, m0, n0, warp, lane, stage, bar, M, N); break;
      default: store<kBfBias>(acc, m0, n0, warp, lane, stage, bar, M, N); break;
    }
  }
};

// gelu_erf<true> against gelu_erf<false> on every f32 bit pattern (NaN
// equal to NaN): counts the inputs whose results differ in any bit.
__global__ void check_gelu_erf_rcp_kernel(unsigned long long* mismatches) {
  unsigned long long bad = 0;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * blockDim.x + threadIdx.x; i < (1ull << 32);
       i += stride) {
    const float x = __uint_as_float((unsigned)i);
    const float a = gelu_erf<false>(x), b = gelu_erf<true>(x);
    bad += !(__float_as_uint(a) == __float_as_uint(b) || (isnan(a) && isnan(b)));
  }
  if (bad) atomicAdd(mismatches, bad);
}

}  // namespace

extern "C" {

// Counts into *mismatches (device memory, zeroed by the caller) the f32
// inputs on which common.cuh's gelu_erf<true> (the reciprocal by rcp_ge1,
// the GEMM's) and gelu_erf<false> (the division, B's, C's and F's) differ.
int mocr_check_gelu_erf_rcp(void* mismatches, void* stream) {
  check_gelu_erf_rcp_kernel<<<132 * 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(mismatches));
  return (int)cudaGetLastError();
}

int mocr_ln_rows_bf16(const void* x, const void* ln_scale, const void* ln_bias, float eps,
                      void* y, int M, int K, void* stream) {
  ln_rows_bf16_kernel<<<M, 256, (size_t)K * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_scale),
      static_cast<const float*>(ln_bias), eps, static_cast<bf16*>(y), K);
  return (int)cudaGetLastError();
}

int mocr_bf16_gemm(const void* a, const void* b, const void* bias, const void* residual,
                   void* out, int M, int N, int K, int mode, void* stream) {
  if (M < 1 || K < 64 || K % 64 || N < 8 || N % 8 || mode < kBfGeluErf || mode > kBfBias ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      reinterpret_cast<uintptr_t>(bias) % 8 || reinterpret_cast<uintptr_t>(residual) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const Bf16Store epi{static_cast<const float*>(bias), static_cast<const bf16*>(residual), out,
                      mode};
  return sm90::launch_gemm<Bf16Op>(a, b, epi, M, N, K, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
