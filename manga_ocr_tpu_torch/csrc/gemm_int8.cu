// The int8 GEMM of the port: every W8A8 projection.
//
// Replaces (Pallas, TPU), as the int8 products of:
//   A  manga_ocr_tpu/ops/flash_attention.py:617 fused_attn_layer, int8 form
//      (_attn_core's q|k|v and o projections, W8A8);
//   B  manga_ocr_tpu/ops/fused_mlp.py:165 fused_mlp_block -> _kernel_int8
//      (fc1 + GELU, fc2 + residual; the encoder's pre-LN form on [B*197,
//      768] rows and the decoder step's post-LN form on [B, 768] rows);
//   H  manga_ocr_tpu/ops/flash_attention.py:770 fused_encoder_layer and
//   I  manga_ocr_tpu/ops/encoder_stack.py:190 encoder_stack, int8 forms
//      (all four projections of a block, chained by csrc/encoder_layer.cu);
//   J, K  the int8 q|k|v / q and residual o projections of the decode step
//      (ops/decode_layer.py).
// The TPU kernels run these products on the MXU's int8 path with the
// weights resident in VMEM.  Here each is one launch of ``int8_gemm``
// (mocr_int8_gemm), after csrc/encoder.cu's ln_quant_rows has quantized the
// rows:
//
//   int8_gemm  out[M, N] = epilogue((A[M, K] . B_t[N, K]^T) * sx[m] * sw[n]
//              + bias[n]): int8 operands, exact int32 sums, B read in the
//              [N, K] layout the callers store.  The pipeline of
//              gemm_sm90.cuh: TMA boxes with 128-byte swizzle into a ring of
//              k-128 stages (A [BM rows][128 k], B [BN rows][128 k]: both
//              K-major), one producer thread, one or two consumer
//              warpgroups issuing wgmma.m64nNk32.s32.s8.s8 from shared
//              memory (four k32 products a stage, each descriptor moving 32
//              bytes along the swizzled rows), a persistent grid of one
//              block per SM.  The epilogue (Int8Store) works on the int32
//              accumulators in registers and writes through staging
//              buffers per warpgroup (TMA stores of whole 64 x 128-byte
//              boxes; the residual mode's 16-byte pieces), with the
//              roundings of _kernel_int8:
//                y = ((float)acc * sx[m]) * sw[n] + bias[n], each step
//                    rounded (__fmul_rn/__fadd_rn: no FMA contraction);
//                bf16 out; or the sigmoid or erf-polynomial GELU (the
//                division form B, C and F use), f32 out; or bf16(y) +
//                residual in f32, then bf16; or y, f32 out.
//              The int32 sums are exact (|sum| <= 127^2 K < 2^31), so the
//              F32, bf16 and residual outputs equal the plain version's
//              (ops/fused_mlp.py int8_gemm_reference) bit for bit.
//
// Bound at B=256 (M = 256 x 197 = 50432 rows), at 1,979 TOP/s int8 and
// 3.35 TB/s: q|k|v [768 -> 2304, bf16 out] 0.090 ms (operations), o
// [768 -> 768, + residual] 0.058 (bytes), fc1 [768 -> 3072, GELU, f32 out]
// 0.197 (bytes: 620 MB of f32 out), fc2 [3072 -> 768, + residual] 0.120
// (operations).  The design keeps the tensor cores fed as the bf16 GEMM
// does (loads a ring ahead of the products and of the previous tile's
// epilogue, 128 x 256 tiles reading each loaded byte 128 or 256 times); an
// int8 stage is half the products of a bf16 one, so the epilogue, which
// the consumers run between two tiles' products, weighs twice as much: for
// fc1 the epilogue and its f32 stores are the kernel.  The step shapes
// (M = 32..256 rows) are bound by reading the weights; they take 64-row
// tiles so that more SMs share those reads (pick_tile).
// Limits: K % 64 == 0 (a ragged last 128-byte box is zero-filled by TMA),
// N % 8 == 0 (TMA's 16-byte row strides and the 16-byte output pieces),
// M >= 1, A, B_t, residual and out 16-byte aligned, sw and bias 8-byte
// aligned (kernels/launch.py int8_gemm checks them; here they return
// cudaErrorInvalidValue).
#include <cuda.h>

#include "common.cuh"
#include "entry.cuh"
#include "gemm_sm90.cuh"

using namespace mocr;

namespace {

typedef __nv_bfloat16 bf16;

// The s8 operands: a stage holds 128 k (one 128-byte row of A and of B_t),
// B_t as one box of [BN rows][128 k], a K-major wgmma operand like A.
struct S8Op {
  typedef int Acc;
  static constexpr int kBK = 128;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  static constexpr int kElemBytes = 1;

  // B_t [N, K]: boxes of 128 k by the tile's BN rows (rows past N read as
  // zeros, and count toward the transaction like the others).
  static bool encode_b(CUtensorMap* map, const void* b_t, int N, int K, int bn) {
    return sm90::encode_map(map, b_t, kMapType, kElemBytes, N, K, bn);
  }

  template <int BN>
  __device__ static uint32_t b_bytes(int, int) {
    return BN * 128;
  }

  template <int BN>
  __device__ static void load_b(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int n0,
                                int k0, int) {
    sm90::tma_load_2d(dst, map, bar, k0, n0);
  }

  // Four k32 products.  A and B_t alike (K-major): the k step moves 32
  // bytes along the swizzled row; 8-row groups 1024 bytes apart (stride
  // byte offset).
  template <int NA>
  __device__ static void mma(int (&acc)[NA], uint32_t a, uint32_t b, bool accumulate) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_s8(acc, sm90::smem_desc(a + 32 * kk, 16, 1024),
                     sm90::smem_desc(b + 32 * kk, 16, 1024), accumulate || kk > 0 ? 1 : 0);
  }
};

// The epilogues of entry.cuh's Int8Epilogue codes, with the roundings of
// _kernel_int8 (see the header note), in chunks of 64 rows by 128 bytes (64
// bf16 or 32 f32 columns: gemm_sm90.cuh's Chunk).  A thread's two row
// scales are loaded once a tile, a chunk's column scales and bias (and
// residual) before its staging writes.  The bf16, GELU and f32 modes store
// through TMA: each chunk is staged as a swizzled box in one of two
// buffers and handed to the TMA unit whole (its writes drain while the
// consumers move on to the next chunk and the next tile's products; a
// buffer is rewritten once the store two chunks back has read it).  The
// residual mode adds the bf16 residual in the staging copy's 16-byte pieces
// (sm90::copy_out).
struct Int8Store {
  const float* sx;
  const float* sw;
  const float* bias;
  const bf16* res;
  void* out;
  int mode;

  static constexpr int kBoxBytes = 64 * 128;          // one chunk as a TMA box
  static constexpr int kStagingBytes = 2 * kBoxBytes;  // two of them (1024-byte aligned)
  static_assert(kStagingBytes >= sm90::Chunk<true>::kStagingBytes, "the staging copy's chunk");

  __host__ __device__ static constexpr bool f32_out(int m) {
    return m != kI8Bf16 && m != kI8ResidualBf16;
  }

  // The output's tensor map: boxes of one chunk, 128-byte swizzle (unused
  // by the residual mode).
  bool encode_out(CUtensorMap* map, int M, int N) const {
    if (mode == kI8ResidualBf16) return true;
    if (f32_out(mode))
      return sm90::encode_map(map, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, M, N, 64);
    return sm90::encode_map(map, out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, N, 64);
  }

  template <int MODE>
  __device__ __forceinline__ static float apply(float y) {
    if (MODE == kI8GeluSigmoidF32) return gelu_sigmoid(y);
    if (MODE == kI8GeluErfF32) return gelu_erf(y);
    return y;
  }

  template <int MODE, int NA>
  __device__ __forceinline__ void store(const int (&acc)[NA], int m0, int n0, int warp, int lane,
                                        uint8_t* stage, int bar, int M, int N,
                                        const CUtensorMap* map_out) const {
    constexpr bool kF32 = f32_out(MODE), kTma = MODE != kI8ResidualBf16;
    typedef sm90::Chunk<kF32> C;
    static_assert(NA % (4 * C::kGroups) == 0, "whole chunks");
    const int tid = warp * 32 + lane, t = lane % 4, r0 = warp * 16 + lane / 4;
    float sxr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) sxr[h] = m0 + r0 + 8 * h < M ? sx[m0 + r0 + 8 * h] : 0.0f;
#pragma unroll
    for (int q = 0; q < NA / (4 * C::kGroups); ++q) {
      const int nc = n0 + C::kWidth * q;
      uint8_t* box = stage + (q % 2) * kBoxBytes;
      if (kTma && q >= 2) {  // the store of chunk q - 2 has read this buffer
        if (tid == 0) sm90::bulk_wait_read<1>();
        sm90::named_barrier_sync(bar, 128);
      }
      uint4 rv[C::kPasses];
      if (!kTma) sm90::load_residual<kF32>(rv, res, m0, nc, tid, M, N);
      float2 w[C::kGroups], b[C::kGroups];
#pragma unroll
      for (int i = 0; i < C::kGroups; ++i) {
        const int n = nc + 8 * i + 2 * t;
        const bool in = n < N;
        w[i] = in ? *reinterpret_cast<const float2*>(sw + n) : make_float2(0.0f, 0.0f);
        b[i] = in ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < C::kGroups; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = C::kGroups * q + i;
          const float y0 = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), sxr[h]), w[i].x), b[i].x);
          const float y1 = __fadd_rn(
              __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), sxr[h]), w[i].y),
              b[i].y);
          if (kTma)
            sm90::stage_pair_swizzled<kF32>(box, r0 + 8 * h, 8 * i + 2 * t, apply<MODE>(y0),
                                            apply<MODE>(y1));
          else
            sm90::stage_pair<kF32>(stage, r0 + 8 * h, 8 * i + 2 * t, y0, y1);
        }
      }
      if (!kTma) {
        sm90::copy_out<kF32, true>(stage, rv, out, m0, nc, tid, bar, M, N);
        continue;
      }
      sm90::fence_proxy_async();  // the box's writes, visible to the TMA unit
      sm90::named_barrier_sync(bar, 128);
      if (tid == 0) {
        sm90::tma_store_2d(map_out, box, nc, m0);
        sm90::bulk_commit();
      }
    }
    if (kTma) {  // both buffers free for the next tile
      if (tid == 0) sm90::bulk_wait_read<0>();
      sm90::named_barrier_sync(bar, 128);
    }
  }

  template <int NA>
  __device__ __forceinline__ void operator()(const int (&acc)[NA], int m0, int n0, int warp,
                                             int lane, uint8_t* stage, int bar, int M, int N,
                                             const CUtensorMap* map_out) const {
    switch (mode) {
      case kI8GeluSigmoidF32:
        store<kI8GeluSigmoidF32>(acc, m0, n0, warp, lane, stage, bar, M, N, map_out);
        break;
      case kI8ResidualBf16:
        store<kI8ResidualBf16>(acc, m0, n0, warp, lane, stage, bar, M, N, map_out);
        break;
      case kI8F32: store<kI8F32>(acc, m0, n0, warp, lane, stage, bar, M, N, map_out); break;
      case kI8GeluErfF32:
        store<kI8GeluErfF32>(acc, m0, n0, warp, lane, stage, bar, M, N, map_out);
        break;
      default: store<kI8Bf16>(acc, m0, n0, warp, lane, stage, bar, M, N, map_out); break;
    }
  }
};

}  // namespace

extern "C" {

int mocr_int8_gemm(const void* a, const void* b_t, const void* sx, const void* sw,
                   const void* bias, const void* residual, void* out, int M, int N, int K,
                   int mode, void* stream) {
  if (M < 1 || K < 64 || K % 64 || N < 8 || N % 8 || mode < kI8Bf16 || mode > kI8GeluErfF32 ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b_t) % 16 ||
      reinterpret_cast<uintptr_t>(sw) % 8 || reinterpret_cast<uintptr_t>(bias) % 8 ||
      reinterpret_cast<uintptr_t>(residual) % 16 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  const Int8Store epi{static_cast<const float*>(sx), static_cast<const float*>(sw),
                      static_cast<const float*>(bias), static_cast<const bf16*>(residual), out,
                      mode};
  return sm90::launch_gemm<S8Op>(a, b_t, epi, M, N, K, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
