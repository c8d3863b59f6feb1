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

constexpr int kBoxN = 64;                  // B box: 64 columns (128 bytes) ...
constexpr int kBoxBytes = 64 * kBoxN * 2;  // ... by 64 k rows

// The bf16 operands: a stage holds 64 k (one 128-byte row of A), B as
// BN / 64 boxes of [64 k][64 n], each an N-major wgmma operand.
struct Bf16Op {
  typedef float Acc;
  static constexpr int kBK = 64;

  // Boxes wholly past N are not loaded (their columns are never stored).
  template <int BN>
  __device__ static int boxes(int n0, int N) {
    const int left = (N - n0 + kBoxN - 1) / kBoxN;
    return left < BN / kBoxN ? left : BN / kBoxN;
  }

  template <int BN>
  __device__ static uint32_t b_bytes(int n0, int N) {
    return boxes<BN>(n0, N) * kBoxBytes;
  }

  template <int BN>
  __device__ static void load_b(uint8_t* dst, const CUtensorMap* map, uint64_t* bar, int n0,
                                int k0, int N) {
    const int nb = boxes<BN>(n0, N);
    for (int j = 0; j < nb; ++j)
      sm90::tma_load_2d(dst + j * kBoxBytes, map, bar, n0 + j * kBoxN, k0);
  }

  // Four k16 products.  A (K-major): the k step moves 32 bytes along the
  // swizzled row; 8-row groups 1024 bytes apart.  B (N-major): the k step
  // moves 16 rows (2048 bytes); 8-row k groups 1024 bytes apart (stride
  // byte offset), 64-column boxes kBoxBytes apart (leading byte offset).
  template <int NA>
  __device__ static void mma(float (&acc)[NA], uint32_t a, uint32_t b, bool accumulate) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_bf16(acc, sm90::smem_desc(a + 32 * kk, 16, 1024),
                       sm90::smem_desc(b + 2048 * kk, kBoxBytes, 1024),
                       accumulate || kk > 0 ? 1 : 0);
  }
};

// The epilogues of entry.cuh's Bf16Epilogue codes, with the roundings of
// _kernel_bf16: y = acc + bias in f32, then the GELU in f32 and bf16; or
// bf16(y) + residual in f32, then bf16; or y (f32); or bf16(y).
// On a consumer warpgroup's own 64 x BN block, 64 columns (32 for kBfF32)
// at a time: each thread applies the bias (and GELU) to its fragment and
// writes the result to the warpgroup's staging buffer (bf16, or f32 for
// kBfF32); then the 128 threads copy the chunk out in 16-byte pieces along
// the rows (whole sectors, where the fragment's pairs would touch 8 rows
// per store), adding the residual there.  A chunk's bias and residual are
// loaded before its staging writes: the compiler may not move a load past
// a store that could alias it, so a load issued between the stores would
// wait a full memory round trip.
struct Bf16Store {
  const float* bias;
  const bf16* res;
  void* out;
  int mode;

  // A chunk: 64 rows of 64 bf16 (row pitch 72) or 32 f32 (pitch 40).
  static constexpr int kStagingBytes = 64 * 40 * 4;

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

  // bf16(y) + r in f32, then bf16, on packed pairs.
  __device__ __forceinline__ static uint32_t add_residual(uint32_t y, uint32_t r) {
    const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
    const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
    const __nv_bfloat162 o = __floats2bfloat162_rn(__fadd_rn(rf.x, yf.x), __fadd_rn(rf.y, yf.y));
    return *reinterpret_cast<const uint32_t*>(&o);
  }

  template <int MODE, int NA>
  __device__ __forceinline__ void store(const float (&acc)[NA], int m0, int n0, int warp,
                                        int lane, uint8_t* stage, int bar, int M,
                                        int N) const {
    constexpr bool kF32 = MODE == kBfF32;
    constexpr int kWidth = kF32 ? 32 : 64, kRowPitch = kF32 ? 40 : 72;
    constexpr int kGroups = kWidth / 8;            // 8-column groups per chunk
    constexpr int kPieces = kF32 ? 4 : 8;          // elements per 16-byte piece
    constexpr int kPerRow = kWidth / kPieces;      // pieces per chunk row
    constexpr int kPasses = 64 * kPerRow / 128;    // copy passes per chunk
    static_assert(NA % (4 * kGroups) == 0, "whole chunks");
    const int tid = warp * 32 + lane, t = lane % 4, r0 = warp * 16 + lane / 4;
    float* stage_f = reinterpret_cast<float*>(stage);
    bf16* stage_h = reinterpret_cast<bf16*>(stage);
#pragma unroll
    for (int q = 0; q < NA / (4 * kGroups); ++q) {
      const int nc = n0 + kWidth * q;
      uint4 rv[kPasses];
      if (MODE == kBfResidual) {
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
          const int row = (tid + 128 * p) / kPerRow, n = nc + kPieces * ((tid + 128 * p) % kPerRow);
          if (m0 + row < M && n < N)
            rv[p] = *reinterpret_cast<const uint4*>(res + (long long)(m0 + row) * N + n);
        }
      }
      float2 b[kGroups];
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
        const int n = nc + 8 * i + 2 * t;
        b[i] = n < N ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int i = 0; i < kGroups; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = kGroups * q + i, col = 8 * i + 2 * t, row = r0 + 8 * h;
          float y0 = __fadd_rn(acc[4 * j + 2 * h], b[i].x);
          float y1 = __fadd_rn(acc[4 * j + 2 * h + 1], b[i].y);
          if (kF32) {
            *reinterpret_cast<float2*>(stage_f + row * kRowPitch + col) = make_float2(y0, y1);
            continue;
          }
          apply<MODE>(y0, y1);
          *reinterpret_cast<__nv_bfloat162*>(stage_h + row * kRowPitch + col) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
      sm90::named_barrier_sync(bar, 128);
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int row = (tid + 128 * p) / kPerRow, piece = (tid + 128 * p) % kPerRow;
        const int m = m0 + row, n = nc + kPieces * piece;
        if (m >= M || n >= N) continue;  // N % 8 == 0: a piece is wholly in or out
        const long long o = (long long)m * N + n;
        if (kF32) {
          *reinterpret_cast<uint4*>(static_cast<float*>(out) + o) =
              *reinterpret_cast<const uint4*>(stage_f + row * kRowPitch + kPieces * piece);
          continue;
        }
        uint4 v = *reinterpret_cast<const uint4*>(stage_h + row * kRowPitch + kPieces * piece);
        if (MODE == kBfResidual) {
          v.x = add_residual(v.x, rv[p].x);
          v.y = add_residual(v.y, rv[p].y);
          v.z = add_residual(v.z, rv[p].z);
          v.w = add_residual(v.w, rv[p].w);
        }
        *reinterpret_cast<uint4*>(static_cast<bf16*>(out) + o) = v;
      }
      sm90::named_barrier_sync(bar, 128);  // the staging buffer is free again
    }
  }

  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int m0, int n0, int warp,
                                             int lane, uint8_t* stage, int bar, int M,
                                             int N) const {
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

// The instantiations: 128 x 256 tiles for the encoder's row counts, 64-row
// tiles (one consumer warpgroup) where 128-row tiles would leave SMs idle.
typedef sm90::Tile<128, 256, 4> WideTile;
typedef sm90::Tile<64, 128, 6> NarrowTile;
typedef sm90::Tile<64, 64, 8> SmallTile;

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's
// entry-point query (so the library links nothing beyond the runtime).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 2-D bf16 tensor map of a row-major [rows, cols] matrix with boxes of
// 64 columns (128 bytes, 128-byte swizzle) by ``box_rows``; out-of-bounds
// elements read as zero.
bool encode_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

int sm_count(int dev) {
  static int counts[kMaxDevices];
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// The instantiation with the least estimated time: rounds of one tile per
// SM, each costing its tile's area plus a fixed share (fill and epilogue).
// At the encoder's row counts that is the 128 x 256 tile; at the step
// shapes a 64-row tile, the narrowest that needs no second round.
enum { kWide, kNarrow, kSmall };

int pick_tile(int M, int N, int sms) {
  const int bm[3] = {WideTile::kBM, NarrowTile::kBM, SmallTile::kBM};
  const int bn[3] = {WideTile::kBN, NarrowTile::kBN, SmallTile::kBN};
  int best = kWide;
  long long best_cost = -1;
  for (int i = kWide; i <= kSmall; ++i) {
    const long long tiles = (long long)((M + bm[i] - 1) / bm[i]) * ((N + bn[i] - 1) / bn[i]);
    const long long cost = (tiles + sms - 1) / sms * (bm[i] * bn[i] + 4096);
    if (best_cost < 0 || cost < best_cost) {
      best = i;
      best_cost = cost;
    }
  }
  return best;
}

template <class T>
int launch_gemm(const void* a, const void* b, const Bf16Store& epi, int M, int N, int K, int dev,
                cudaStream_t stream) {
  auto kernel = sm90::gemm_kernel<Bf16Op, T, Bf16Store>;
  constexpr int kSmem = sm90::smem_bytes<T, Bf16Store>();
  static bool smem_set[kMaxDevices];
  if (!smem_set[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  CUtensorMap map_a, map_b;
  if (!encode_map(&map_a, a, M, K, T::kBM) || !encode_map(&map_b, b, K, N, 64))
    return (int)cudaErrorInvalidValue;
  const int tiles = (M + T::kBM - 1) / T::kBM * ((N + T::kBN - 1) / T::kBN);
  const int grid = tiles < sm_count(dev) ? tiles : sm_count(dev);
  kernel<<<grid, T::kThreads, kSmem, stream>>>(map_a, map_b, epi, M, N, K);
  return (int)cudaGetLastError();
}

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
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  const Bf16Store epi{static_cast<const float*>(bias), static_cast<const bf16*>(residual), out,
                      mode};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_tile(M, N, sm_count(dev))) {
    case kWide: return launch_gemm<WideTile>(a, b, epi, M, N, K, dev, st);
    case kNarrow: return launch_gemm<NarrowTile>(a, b, epi, M, N, K, dev, st);
    default: return launch_gemm<SmallTile>(a, b, epi, M, N, K, dev, st);
  }
}

}  // extern "C"
