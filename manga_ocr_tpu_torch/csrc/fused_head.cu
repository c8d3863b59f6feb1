// Fused greedy LM head (kernel F): ids[b] = first argmax_n of
// (bf16(LN(gelu_erf(x[b] . Wt + bt))) . Wp[:, n] + bp[n]).
//
// Replaces (Pallas, TPU): manga_ocr_tpu/ops/fused_head.py fused_greedy_head
// -> _head_kernel, which keeps the [B, 6144] logits in VMEM and tracks a
// running (max, argmax) over 512-wide vocab tiles.
//
// Here one C entry (mocr_fused_head) chains four launches on the stream,
// with the roundings of _head_kernel:
//
//   transform  h32 = x . Wt + bt in f32: the bf16 GEMM (mocr_bf16_gemm,
//              csrc/mlp_bf16.cu, kBfF32) on gemm_sm90.cuh's TMA + wgmma
//              pipeline, once per row (not once per vocab split).
//   head_rows  a warp per row, the row in registers (16-byte loads): the
//              erf-polynomial GELU in f32 (the division form, as B and C),
//              LN with f32 statistics (the mean, then the mean of the
//              squared deviations, then 1/sqrt(var + eps)), cast to bf16.
//   vocab      h [B, D] bf16 . Wp [D, V] + bp on the same pipeline with the
//              ArgmaxStore epilogue: each consumer warpgroup reduces its
//              64 x BN accumulators, plus bp in f32, to one (value, column)
//              pair per row and 64-column slot -- first within a thread's
//              fragment in column order (strict >), then across the 4 lanes
//              that share a row (__shfl_xor_sync; a tie goes to the lower
//              column) -- and writes it to part_v / part_i [B, V / 64].  A
//              row's columns of a tile all lie in one warp of the wgmma
//              fragment, so no exchange across warps is needed.  The
//              logits never reach device memory.  Rows past B come in as
//              TMA zeros and write nothing.
//   reduce     a warp per row reads its V / 64 partials, each lane its
//              slots in column order (strict >), then the lanes by shuffle
//              (a tie to the lower column): the first maximum over the
//              whole vocab, as the TPU kernel's strict > across tiles.
//
// Bound on the H100: bytes, the head weights (~10.6 MB bf16) read once: 3.2
// us at 3.35 TB/s, against ~2.7 us of bf16 products at B = 256.  The
// products run on the tensor cores; the vocab weights are read once per
// 64-row tile (pick_tile: 64-row tiles at the step shapes), so 4 times from
// L2 at B = 256.  What the design does not remove is the four launches:
// each kernel's own fill and drain, a few microseconds at these sizes, sets
// F's time (0.02-0.03 ms on an H100 SXM at 700 W, chip_smoke.py
// --gemm-times), not its bytes.
// Limits: B >= 1, D % 64 == 0 and D <= 1024 (a row of the row pass in one
// warp's registers), V % 64 == 0 (whole slots; the wrapper asks V % 512),
// every operand 16-byte aligned (kernels/launch.py fused_head checks them;
// here they return cudaErrorInvalidValue).
#include <cuda.h>

#include "common.cuh"
#include "entry.cuh"
#include "gemm_sm90.cuh"

using namespace mocr;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kSlot = 64;      // vocab columns per partial
constexpr int kRowWarps = 8;   // rows per block of the row passes
constexpr int kMaxChunks = 8;  // 16-byte f32 chunks a lane holds: D <= 1024

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// One row per warp: lane l holds the row's f32 chunks l, l + 32, ... (4
// values each, at most kChunks of them).
template <int kChunks>
__global__ void __launch_bounds__(32 * kRowWarps)
    head_rows_kernel(const float* __restrict__ h, const float* __restrict__ lns,
                     const float* __restrict__ lnb, float eps, bf16* __restrict__ y, int M,
                     int D) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= M) return;  // no block barrier below
  const int chunks = D / 4;
  const long long base = (long long)row * D;
  float v[kChunks][4];
  float4 sc[kChunks], bi[kChunks];  // the LN parameters, loaded with the row
  float s = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = lane + 32 * c;
    float4 raw = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (i < chunks) {
      raw = *reinterpret_cast<const float4*>(h + base + 4 * i);
      sc[c] = *reinterpret_cast<const float4*>(lns + 4 * i);
      bi[c] = *reinterpret_cast<const float4*>(lnb + 4 * i);
    }
    v[c][0] = gelu_erf(raw.x);
    v[c][1] = gelu_erf(raw.y);
    v[c][2] = gelu_erf(raw.z);
    v[c][3] = gelu_erf(raw.w);
#pragma unroll
    for (int j = 0; j < 4; ++j) s += v[c][j];  // chunks past D hold gelu(0) = 0
  }
  const float mu = warp_sum(s) / (float)D;
  float var = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (lane + 32 * c >= chunks) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = v[c][j] - mu;
      var += d * d;
    }
  }
  const float r = 1.0f / sqrtf(warp_sum(var) / (float)D + eps);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = lane + 32 * c;
    if (i >= chunks) continue;
    const __nv_bfloat162 lo = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(v[c][0] - mu, r), sc[c].x), bi[c].x),
        __fadd_rn(__fmul_rn(__fmul_rn(v[c][1] - mu, r), sc[c].y), bi[c].y));
    const __nv_bfloat162 hi = __floats2bfloat162_rn(
        __fadd_rn(__fmul_rn(__fmul_rn(v[c][2] - mu, r), sc[c].z), bi[c].z),
        __fadd_rn(__fmul_rn(__fmul_rn(v[c][3] - mu, r), sc[c].w), bi[c].w));
    *reinterpret_cast<uint2*>(y + base + 4 * i) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  }
}

// The vocab product's epilogue (gemm_sm90.cuh's Epi): no output tile, one
// (value, column) partial per row and 64-column slot.  The wgmma fragment:
// thread (warp, lane) holds acc[4j + 2h + e] at row 16 warp + lane / 4 + 8h,
// column 8j + 2 (lane % 4) + e of its warpgroup's 64 x BN block.
struct ArgmaxStore {
  const float* bias;  // bp [N]
  float* part_v;      // [M, N / kSlot]
  int* part_i;

  static constexpr int kStagingBytes = 0;

  bool encode_out(CUtensorMap*, int, int) const { return true; }

  template <int NA>
  __device__ __forceinline__ void operator()(const float (&acc)[NA], int m0, int n0, int warp,
                                             int lane, uint8_t*, int, int M, int N,
                                             const CUtensorMap*) const {
    static_assert(NA % 32 == 0, "whole 64-column slots");
    const int t = lane % 4, slots = N / kSlot;
#pragma unroll
    for (int s = 0; s < NA / 32; ++s) {
      const int ns = n0 + kSlot * s;
      if (ns >= N) continue;  // N % 64 == 0: a slot is wholly in or out
      float2 b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        b[i] = *reinterpret_cast<const float2*>(bias + ns + 8 * i + 2 * t);
      float bv[2] = {-INFINITY, -INFINITY};
      int bi[2] = {ns, ns};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = 8 * s + i, n = ns + 8 * i + 2 * t;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = __fadd_rn(acc[4 * j + 2 * h], b[i].x);
          const float y1 = __fadd_rn(acc[4 * j + 2 * h + 1], b[i].y);
          if (y0 > bv[h]) {
            bv[h] = y0;
            bi[h] = n;
          }
          if (y1 > bv[h]) {
            bv[h] = y1;
            bi[h] = n + 1;
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int o = 1; o < 4; o <<= 1) {  // the four lanes of one row
          const float ov = __shfl_xor_sync(0xffffffffu, bv[h], o);
          const int oi = __shfl_xor_sync(0xffffffffu, bi[h], o);
          if (better(ov, oi, bv[h], bi[h])) {
            bv[h] = ov;
            bi[h] = oi;
          }
        }
        const int row = m0 + 16 * warp + lane / 4 + 8 * h;
        if (t == 0 && row < M) {
          part_v[(long long)row * slots + ns / kSlot] = bv[h];
          part_i[(long long)row * slots + ns / kSlot] = bi[h];
        }
      }
    }
  }
};

// One row per warp: lane l takes slots l, l + 32, ... in column order with
// strict >, then the lanes by shuffle with a tie to the lower column.
__global__ void __launch_bounds__(32 * kRowWarps)
    head_reduce_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i, int M,
                       int slots, int* __restrict__ ids) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * kRowWarps + threadIdx.x / 32;
  if (row >= M) return;
  const long long base = (long long)row * slots;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int s = lane; s < slots; s += 32) {
    const float v = part_v[base + s];
    if (bi == 0x7fffffff || v > bv) {
      bv = v;
      bi = part_i[base + s];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  if (lane == 0) ids[row] = bi;
}

template <int kChunks>
int launch_rows(const float* h, const float* lns, const float* lnb, float eps, bf16* y, int M,
                int D, cudaStream_t st) {
  head_rows_kernel<kChunks><<<(M + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, st>>>(
      h, lns, lnb, eps, y, M, D);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// x [B, D] bf16; wt [D, D] bf16; bt, lns, lnb [D] f32; wp [D, V] bf16;
// bp [V] f32; scratch h32 [B, D] f32, hb [B, D] bf16, part_v / part_i
// [B, V / 64] f32 / int32; ids [B] int32.
int mocr_fused_head(const void* x, const void* wt, const void* bt, const void* lns,
                    const void* lnb, const void* wp, const void* bp, int B, int D, int V,
                    float eps, void* h32, void* hb, void* part_v, void* part_i, void* ids,
                    void* stream) {
  const void* ptrs[] = {x, wt, bt, lns, lnb, wp, bp, h32, hb, part_v, part_i, ids};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  if (B < 1 || D < 64 || D % 64 || D > 4 * 32 * kMaxChunks || V < kSlot || V % kSlot)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = mocr_bf16_gemm(x, wt, bt, nullptr, h32, B, D, D, kBfF32, stream);
  if (err) return err;
  const float* hf = static_cast<const float*>(h32);
  const float* sc = static_cast<const float*>(lns);
  const float* bi = static_cast<const float*>(lnb);
  bf16* hy = static_cast<bf16*>(hb);
  const int per_lane = (D / 4 + 31) / 32;
  err = per_lane <= 2   ? launch_rows<2>(hf, sc, bi, eps, hy, B, D, st)
        : per_lane <= 4 ? launch_rows<4>(hf, sc, bi, eps, hy, B, D, st)
        : per_lane <= 6 ? launch_rows<6>(hf, sc, bi, eps, hy, B, D, st)
                        : launch_rows<kMaxChunks>(hf, sc, bi, eps, hy, B, D, st);
  if (err) return err;
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  const ArgmaxStore epi{static_cast<const float*>(bp), pv, pi};
  err = sm90::launch_gemm<sm90::Bf16Op>(hb, wp, epi, B, V, D, st);
  if (err) return err;
  head_reduce_kernel<<<(B + kRowWarps - 1) / kRowWarps, 32 * kRowWarps, 0, st>>>(
      pv, pi, B, V / kSlot, static_cast<int*>(ids));
  return (int)cudaGetLastError();
}

}  // extern "C"
