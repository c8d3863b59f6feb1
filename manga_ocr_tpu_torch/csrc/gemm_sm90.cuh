// A warp-specialised GEMM pipeline for Hopper (sm_90a), and the PTX it is
// built from: TMA tile loads into a ring of shared-memory stages guarded by
// "full" and "empty" mbarriers, wgmma products read from those stages,
// accumulators (Op::Acc) in registers, a persistent grid.
//
//   block   one producer warpgroup (one thread issues every TMA load; the
//           warpgroup gives its registers to the consumers by setmaxnreg)
//           and kConsumers = BM / 64 consumer warpgroups, each owning 64
//           rows of the block's BM x BN output tile;
//   ring    kStages stages, each one k tile of A ([BM rows][128 bytes]) and
//           of B (the operand's own layout, Op::load_b); the producer waits
//           for a stage's "empty" barrier, arms its "full" barrier with the
//           stage's byte count and issues the loads; each consumer
//           warpgroup waits for "full", issues the stage's wgmma products,
//           and arrives on "empty" once the products that read the stage
//           have retired (one wgmma group stays in flight);
//   tiles   the grid is at most one block per SM; block b takes output
//           tiles b, b + gridDim.x, ... in row-major tile order, so the
//           producer loads the next tile's first stages while the consumers
//           run the current tile's epilogue (Epi: on the accumulators in
//           registers, through a staging buffer and a named barrier per
//           consumer warpgroup).
//
// Both operands are loaded with 128-byte swizzle: a tile row is 128 bytes,
// 8 rows make one 1024-byte swizzle atom, and every stage starts on a
// 1024-byte boundary, so the wgmma descriptors need no base offset.  The
// ragged M (and N, and K) edge comes in as zeros from TMA (a box's full
// bytes count toward its stage's transaction either way); the epilogue
// masks its stores.  ``Op`` supplies the element type's k depth of a stage,
// B's loads and the products of one stage: Bf16Op (below: k16 products, B
// N-major through the transpose bit) and S8Op (gemm_int8.cu: k32 products,
// B K-major).  ``Epi`` is the epilogue: Bf16Store (mlp_bf16.cu), Int8Store
// (gemm_int8.cu) and ArgmaxStore (fused_head.cu, kernel F's vocab product:
// the first maximum of each row's 64-column slots, no output tile).
#pragma once

#include <cuda.h>  // CUtensorMap (a type only; nothing of libcuda is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mocr {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive and add ``bytes`` to the transactions the current phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` has completed.  A wait that
// outlasts 2^22 polls (far beyond any load or product) traps: a pipeline
// fault then surfaces as a launch failure at the next synchronisation
// instead of a hung process.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  long long spins = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (++spins > (1ll << 22)) __trap();
  } while (!done);
}

// One 2-D TMA box (coordinates innermost first) into shared memory; its
// bytes complete a transaction of ``bar``.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One 2-D TMA box from shared memory to global memory (coordinates
// innermost first) in this thread's current bulk group; elements past the
// tensor's bounds are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most ``N`` of this thread's bulk groups still read their
// shared-memory sources (their global writes may still be in flight).
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's shared-memory writes visible to the TMA unit.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Barrier ``id`` (1..15; 0 is __syncthreads) over ``count`` threads.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_operands(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(int (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(acc[i])::"memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma shared-memory matrix descriptor of a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128B swizzle), base offset 0 (atoms are 1024-byte aligned).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// The accumulator lists of the wgmma products below: %0 .. %(N/2 - 1) in
// the instruction text, one "+f" or "+r" operand each.
#define MOCR_ACC32 \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define MOCR_ACC64 MOCR_ACC32 ", " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define MOCR_ACC128 MOCR_ACC64 ", " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
  "%125, %126, %127"
#define MOCR_D8(c, i)                                                                     \
  c(d[i]), c(d[i + 1]), c(d[i + 2]), c(d[i + 3]), c(d[i + 4]), c(d[i + 5]), c(d[i + 6]), \
      c(d[i + 7])
#define MOCR_D32(c) MOCR_D8(c, 0), MOCR_D8(c, 8), MOCR_D8(c, 16), MOCR_D8(c, 24)
#define MOCR_D64(c) MOCR_D32(c), MOCR_D8(c, 32), MOCR_D8(c, 40), MOCR_D8(c, 48), MOCR_D8(c, 56)
#define MOCR_D128(c)                                                                        \
  MOCR_D64(c), MOCR_D8(c, 64), MOCR_D8(c, 72), MOCR_D8(c, 80), MOCR_D8(c, 88), MOCR_D8(c, 96), \
      MOCR_D8(c, 104), MOCR_D8(c, 112), MOCR_D8(c, 120)
#define MOCR_F(x) "+f"(x)
#define MOCR_R(x) "+r"(x)

// D (64 x N, f32) += A (64 x 16, K-major) . B (16 x N, N-major: the
// transpose bit), bf16 operands from shared memory; ``accumulate`` 0
// overwrites D.  One overload per N: the accumulator array sets it.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" MOCR_ACC32
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MOCR_D32(MOCR_F)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" MOCR_ACC64
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : MOCR_D64(MOCR_F)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {" MOCR_ACC128
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : MOCR_D128(MOCR_F)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D (64 x N, s32) += A (64 x 32, K-major) . B (32 x N, K-major), s8
// operands from shared memory; ``accumulate`` 0 overwrites D.  8-bit
// products take both operands K-major (no transpose bit).  The sums wrap
// (no .satfinite): the int8 GEMM's |sum| <= 127^2 K stays below 2^31 for
// any K up to 133,000.
__device__ __forceinline__ void wgmma_s8(int (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" MOCR_ACC32 "}, %32, %33, p;\n}\n"
      : MOCR_D32(MOCR_R)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" MOCR_ACC64 "}, %64, %65, p;\n}\n"
      : MOCR_D64(MOCR_R)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_s8(int (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {" MOCR_ACC128 "}, %128, %129, p;\n}\n"
      : MOCR_D128(MOCR_R)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef MOCR_ACC32
#undef MOCR_ACC64
#undef MOCR_ACC128
#undef MOCR_D8
#undef MOCR_D32
#undef MOCR_D64
#undef MOCR_D128
#undef MOCR_F
#undef MOCR_R

// Output tile shape and ring depth of one instantiation.  Registers:
// setmaxnreg hands the producer's to the consumers, which hold the
// accumulators (kProducerRegs / kConsumerRegs a thread; an increase can
// only take what a decrease gave back to the block's allocation at launch,
// kLaunchRegs a thread).  ptxas then compiles the consumer's code to the
// larger count.
template <int BM_, int BN_, int STAGES_>
struct Tile {
  static constexpr int kBM = BM_, kBN = BN_, kStages = STAGES_;
  static constexpr int kConsumers = BM_ / 64;
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kABytes = BM_ * 128;  // one k tile of A: BM rows of 128 bytes
  static constexpr int kBBytes = BN_ * 128;  // one k tile of B: BN x 128 bytes either way
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr bool kRebalance = kConsumers > 1;
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static_assert(BM_ == 64 || BM_ == 128, "one or two consumer warpgroups");
  static_assert(BN_ % 64 == 0 && BN_ <= 256, "wgmma N up to 256, whole 64-column boxes");
  static_assert(!kRebalance || kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <=
                                   kLaunchRegs * kThreads,
                "the block's registers");
};

// Dynamic shared memory of gemm_kernel<Op, T, Epi>: 1024 bytes to align
// the ring, the ring, each consumer warpgroup's epilogue staging, the full
// and empty barriers.
template <class T, class Epi>
constexpr int smem_bytes() {
  return 1024 + T::kStages * T::kStageBytes + T::kConsumers * Epi::kStagingBytes +
         2 * T::kStages * 8;
}

// out tile = Epi(A[M, K] . B + ...): A through ``map_a`` (boxes of 128 bytes
// x BM rows), B through ``map_b`` as Op reads it.  K is a multiple of 64
// (the last k tile of a 128-k stage may be half zeros).  Each consumer
// warpgroup hands Epi its accumulators (the wgmma fragment: thread (warp,
// lane) holds acc[4j + 2h + e] at row ``16 warp + lane / 4 + 8h``, column
// ``8j + 2 (lane % 4) + e`` of its 64 x BN block at (m0, n0)), its staging
// buffer, its named barrier and ``map_out``, the output's tensor map where
// Epi stores through TMA (Epi::encode_out).
template <class Op, class T, class Epi>
__global__ void __launch_bounds__(T::kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b,
                const __grid_constant__ CUtensorMap map_out, const Epi epi, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = ring;
  uint8_t* b_ring = ring + T::kStages * T::kABytes;
  uint8_t* staging = b_ring + T::kStages * T::kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + T::kConsumers * Epi::kStagingBytes);
  uint64_t* empty = full + T::kStages;
  const int tiles_n = (N + T::kBN - 1) / T::kBN;
  const int tiles = (M + T::kBM - 1) / T::kBM * tiles_n;
  const int k_tiles = (K + Op::kBK - 1) / Op::kBK;  // a ragged last box reads zeros

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], T::kConsumers);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer warpgroup
    if constexpr (T::kRebalance) setmaxnreg_dec<T::kProducerRegs>();
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * T::kBM, n0 = tile % tiles_n * T::kBN;
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(&empty[stage], phase ^ 1);
          mbar_expect_tx(&full[stage], T::kABytes + Op::template b_bytes<T::kBN>(n0, N));
          tma_load_2d(a_ring + stage * T::kABytes, &map_a, &full[stage], kt * Op::kBK, m0);
          Op::template load_b<T::kBN>(b_ring + stage * T::kBBytes, &map_b, &full[stage], n0,
                                      kt * Op::kBK, N);
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // a consumer warpgroup: rows [64c, 64c + 64) of each tile
    if constexpr (T::kRebalance) setmaxnreg_inc<T::kConsumerRegs>();
    const int c = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool signals = threadIdx.x % 128 == 0;
    typename Op::Acc acc[T::kBN / 2];
#pragma unroll
    for (int i = 0; i < T::kBN / 2; ++i) acc[i] = 0;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile / tiles_n * T::kBM, n0 = tile % tiles_n * T::kBN;
      for (int kt = 0; kt < k_tiles; ++kt) {
        mbar_wait(&full[stage], phase);
        fence_operands(acc);
        wgmma_fence();
        Op::mma(acc, smem_addr(a_ring + stage * T::kABytes + c * 64 * 128),
                smem_addr(b_ring + stage * T::kBBytes), kt > 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products have retired
        fence_operands(acc);
        if (kt > 0 && signals) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == T::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_operands(acc);
      if (signals) mbar_arrive(&empty[prev]);
      epi(acc, m0 + c * 64, n0, warp, lane, staging + c * Epi::kStagingBytes, 1 + c, M, N,
          &map_out);
    }
  }
}

// ---------------------------------------------------------------------------
// The epilogues' stores (Bf16Store, Int8Store): a consumer warpgroup's
// 64 x BN block goes out in chunks of 64 rows by Chunk::kWidth columns.
// Each thread writes its fragment's values of a chunk into the warpgroup's
// staging buffer (bf16, or f32 for an f32 output); after a named barrier the
// 128 threads copy the chunk out in 16-byte pieces along the rows (whole
// sectors, where the fragment's pairs would touch 8 rows per store), adding
// a bf16 residual there; a second barrier frees the buffer.  A chunk's
// residual (and the epilogue's bias and scales) are loaded before its
// staging writes: the compiler may not move a load past a store that could
// alias it, so a load issued between the stores would wait a full memory
// round trip.  (Int8Store's modes without a residual hand each chunk to the
// TMA unit instead, staged as a swizzled box: stage_pair_swizzled.)
// ---------------------------------------------------------------------------

template <bool kF32>
struct Chunk {
  static constexpr int kWidth = kF32 ? 32 : 64;        // columns
  static constexpr int kRowPitch = kF32 ? 40 : 72;     // staging row pitch, elements
  static constexpr int kGroups = kWidth / 8;           // 8-column fragment groups
  static constexpr int kPieces = kF32 ? 4 : 8;         // elements per 16-byte piece
  static constexpr int kPerRow = kWidth / kPieces;     // pieces per chunk row
  static constexpr int kPasses = 64 * kPerRow / 128;   // copy passes per chunk
  static constexpr int kStagingBytes = 64 * 40 * 4;    // the larger of the two forms
};

// The bf16 residual pieces of the chunk at columns [nc, nc + kWidth) that
// thread ``tid`` adds in copy_out.
template <bool kF32>
__device__ __forceinline__ void load_residual(uint4 (&rv)[Chunk<kF32>::kPasses],
                                              const __nv_bfloat16* res, int m0, int nc, int tid,
                                              int M, int N) {
  typedef Chunk<kF32> C;
#pragma unroll
  for (int p = 0; p < C::kPasses; ++p) {
    const int row = (tid + 128 * p) / C::kPerRow;
    const int n = nc + C::kPieces * ((tid + 128 * p) % C::kPerRow);
    if (m0 + row < M && n < N)
      rv[p] = *reinterpret_cast<const uint4*>(res + (long long)(m0 + row) * N + n);
  }
}

// bf16(y) + r in f32, then bf16, on packed pairs.
__device__ __forceinline__ uint32_t add_residual(uint32_t y, uint32_t r) {
  const float2 yf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&y));
  const float2 rf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
  const __nv_bfloat162 o = __floats2bfloat162_rn(__fadd_rn(rf.x, yf.x), __fadd_rn(rf.y, yf.y));
  return *reinterpret_cast<const uint32_t*>(&o);
}

// A fragment's value pair (``y0``, ``y1``) into the staging buffer at
// ``row`` and chunk column ``col``.
template <bool kF32>
__device__ __forceinline__ void stage_pair(uint8_t* stage, int row, int col, float y0, float y1) {
  if (kF32)
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(stage) + row * Chunk<kF32>::kRowPitch +
                               col) = make_float2(y0, y1);
  else
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<__nv_bfloat16*>(stage) +
                                       row * Chunk<kF32>::kRowPitch + col) =
        __floats2bfloat162_rn(y0, y1);
}

// A fragment's value pair into a chunk laid out as a TMA box of 64 rows of
// 128 bytes with 128-byte swizzle (16-byte piece p of row r at piece
// p ^ (r % 8)): the layout a store through a SWIZZLE_128B tensor map reads,
// and the fragment's 8 rows land on 8 different bank groups.
template <bool kF32>
__device__ __forceinline__ void stage_pair_swizzled(uint8_t* box, int row, int col, float y0,
                                                    float y1) {
  const int byte = col * (kF32 ? 4 : 2);
  uint8_t* p = box + row * 128 + (((byte >> 4) ^ (row & 7)) << 4) + (byte & 15);
  if (kF32)
    *reinterpret_cast<float2*>(p) = make_float2(y0, y1);
  else
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(y0, y1);
}

// The staged chunk at columns [nc, nc + kWidth) out to ``out`` [M, N] (f32
// or bf16), plus the residual pieces ``rv`` under kResidual; both barriers.
template <bool kF32, bool kResidual>
__device__ __forceinline__ void copy_out(const uint8_t* stage,
                                         const uint4 (&rv)[Chunk<kF32>::kPasses], void* out,
                                         int m0, int nc, int tid, int bar, int M, int N) {
  typedef Chunk<kF32> C;
  named_barrier_sync(bar, 128);
#pragma unroll
  for (int p = 0; p < C::kPasses; ++p) {
    const int row = (tid + 128 * p) / C::kPerRow, piece = (tid + 128 * p) % C::kPerRow;
    const int m = m0 + row, n = nc + C::kPieces * piece;
    if (m >= M || n >= N) continue;  // N % 8 == 0: a piece is wholly in or out
    const long long o = (long long)m * N + n;
    if (kF32) {
      *reinterpret_cast<uint4*>(static_cast<float*>(out) + o) = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const float*>(stage) + row * C::kRowPitch + C::kPieces * piece);
      continue;
    }
    uint4 v = *reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(stage) +
                                              row * C::kRowPitch + C::kPieces * piece);
    if (kResidual) {
      v.x = add_residual(v.x, rv[p].x);
      v.y = add_residual(v.y, rv[p].y);
      v.z = add_residual(v.z, rv[p].z);
      v.w = add_residual(v.w, rv[p].w);
    }
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(out) + o) = v;
  }
  named_barrier_sync(bar, 128);  // the staging buffer is free again
}

// ---------------------------------------------------------------------------
// Host side, shared by the bf16 GEMM (mlp_bf16.cu) and the int8 GEMM
// (gemm_int8.cu): tensor maps, the tile instantiations, the choice among
// them and the launch.  ``Op`` adds to its device part the element type of
// its operands (kMapType, kElemBytes) and the tensor map of B (encode_b).
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime's
// entry-point query (so the library links nothing beyond the runtime).
inline EncodeTiled encode_tiled() {
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

// A 2-D tensor map of a row-major [rows, cols] matrix of ``elem_bytes``-byte
// elements with boxes of one 128-byte row piece (128-byte swizzle) by
// ``box_rows`` rows; out-of-bounds elements read as zero.
inline bool encode_map(CUtensorMap* map, const void* base, CUtensorMapDataType type,
                       int elem_bytes, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 operand set, shared by the bf16 GEMM (mlp_bf16.cu) and kernel
// F's vocab product (fused_head.cu): a stage holds 64 k (one 128-byte row
// of A), B as BN / 64 boxes of [64 k][64 n], each an N-major wgmma operand.
struct Bf16Op {
  typedef float Acc;
  static constexpr int kBK = 64;
  static constexpr CUtensorMapDataType kMapType = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  static constexpr int kElemBytes = 2;
  static constexpr int kBoxN = 64;                  // B box: 64 columns (128 bytes) ...
  static constexpr int kBoxBytes = 64 * kBoxN * 2;  // ... by 64 k rows

  // B [K, N]: boxes of 64 columns by 64 k rows.
  static bool encode_b(CUtensorMap* map, const void* b, int N, int K, int) {
    return encode_map(map, b, kMapType, kElemBytes, K, N, 64);
  }

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
    for (int j = 0; j < nb; ++j) tma_load_2d(dst + j * kBoxBytes, map, bar, n0 + j * kBoxN, k0);
  }

  // Four k16 products.  A (K-major): the k step moves 32 bytes along the
  // swizzled row; 8-row groups 1024 bytes apart.  B (N-major): the k step
  // moves 16 rows (2048 bytes); 8-row k groups 1024 bytes apart (stride
  // byte offset), 64-column boxes kBoxBytes apart (leading byte offset).
  template <int NA>
  __device__ static void mma(float (&acc)[NA], uint32_t a, uint32_t b, bool accumulate) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16(acc, smem_desc(a + 32 * kk, 16, 1024), smem_desc(b + 2048 * kk, kBoxBytes, 1024),
                 accumulate || kk > 0 ? 1 : 0);
  }
};

constexpr int kMaxDevices = 64;

inline int sm_count(int dev) {
  static int counts[kMaxDevices];
  if (counts[dev] == 0) cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  return counts[dev];
}

// The instantiations: 128 x 256 tiles for the encoder's row counts, 64-row
// tiles (one consumer warpgroup) where 128-row tiles would leave SMs idle.
// A stage holds 128 bytes of K either way (64 bf16 or 128 int8 values).
typedef Tile<128, 256, 4> WideTile;
typedef Tile<64, 128, 6> NarrowTile;
typedef Tile<64, 64, 8> SmallTile;

// The instantiation with the least estimated time: rounds of one tile per
// SM, each costing its tile's area plus a fixed share (fill and epilogue).
// At the encoder's row counts that is the 128 x 256 tile; at the step
// shapes a 64-row tile, the narrowest that needs no second round.
enum { kWide, kNarrow, kSmall };

inline int pick_tile(int M, int N, int sms) {
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

template <class Op, class T, class Epi>
int launch_tile(const void* a, const void* b, const Epi& epi, int M, int N, int K, int dev,
                cudaStream_t stream) {
  auto kernel = gemm_kernel<Op, T, Epi>;
  constexpr int kSmem = smem_bytes<T, Epi>();
  static bool smem_set[kMaxDevices];
  if (!smem_set[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  CUtensorMap map_a, map_b, map_out = {};
  if (!encode_map(&map_a, a, Op::kMapType, Op::kElemBytes, M, K, T::kBM) ||
      !Op::encode_b(&map_b, b, N, K, T::kBN) || !epi.encode_out(&map_out, M, N))
    return (int)cudaErrorInvalidValue;
  const int tiles = (M + T::kBM - 1) / T::kBM * ((N + T::kBN - 1) / T::kBN);
  const int grid = tiles < sm_count(dev) ? tiles : sm_count(dev);
  kernel<<<grid, T::kThreads, kSmem, stream>>>(map_a, map_b, map_out, epi, M, N, K);
  return (int)cudaGetLastError();
}

// out = Epi(A[M, K] . B) on the instantiation pick_tile chooses, on the
// current device; the caller has checked the shapes and alignments.
template <class Op, class Epi>
int launch_gemm(const void* a, const void* b, const Epi& epi, int M, int N, int K,
                cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  switch (pick_tile(M, N, sm_count(dev))) {
    case kWide: return launch_tile<Op, WideTile>(a, b, epi, M, N, K, dev, stream);
    case kNarrow: return launch_tile<Op, NarrowTile>(a, b, epi, M, N, K, dev, stream);
    default: return launch_tile<Op, SmallTile>(a, b, epi, M, N, K, dev, stream);
  }
}

}  // namespace sm90
}  // namespace mocr
