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
// ragged M (and N) edge comes in as zeros from TMA; the epilogue masks its
// stores.  ``Op`` supplies the element type's k depth of a stage, B's
// loads and the products of one stage: an s8 operand set (k32 products, a
// K-major B) fits the same skeleton.
#pragma once

#include <cuda.h>  // CUtensorMap (a type only; nothing of libcuda is linked)
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

// D (64 x N, f32) += A (64 x 16, K-major) . B (16 x N, N-major: the
// transpose bit), bf16 operands from shared memory; ``accumulate`` 0
// overwrites D.  One overload per N: the accumulator array sets it.
#define MOCR_D8(i)                                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : MOCR_D8(0), MOCR_D8(8), MOCR_D8(16), MOCR_D8(24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : MOCR_D8(0), MOCR_D8(8), MOCR_D8(16), MOCR_D8(24),
        MOCR_D8(32), MOCR_D8(40), MOCR_D8(48), MOCR_D8(56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[128], uint64_t desc_a, uint64_t desc_b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : MOCR_D8(0), MOCR_D8(8), MOCR_D8(16), MOCR_D8(24),
        MOCR_D8(32), MOCR_D8(40), MOCR_D8(48), MOCR_D8(56),
        MOCR_D8(64), MOCR_D8(72), MOCR_D8(80), MOCR_D8(88),
        MOCR_D8(96), MOCR_D8(104), MOCR_D8(112), MOCR_D8(120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef MOCR_D8

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
// x BM rows), B through ``map_b`` as Op reads it.  K is a multiple of
// Op::kBK.  Each consumer warpgroup hands Epi its accumulators (the wgmma
// fragment: thread (warp, lane) holds acc[4j + 2h + e] at row
// ``16 warp + lane / 4 + 8h``, column ``8j + 2 (lane % 4) + e`` of its
// 64 x BN block at (m0, n0)), its staging buffer and its named barrier.
template <class Op, class T, class Epi>
__global__ void __launch_bounds__(T::kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, const Epi epi, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* a_ring = ring;
  uint8_t* b_ring = ring + T::kStages * T::kABytes;
  uint8_t* staging = b_ring + T::kStages * T::kBBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + T::kConsumers * Epi::kStagingBytes);
  uint64_t* empty = full + T::kStages;
  const int tiles_n = (N + T::kBN - 1) / T::kBN;
  const int tiles = (M + T::kBM - 1) / T::kBM * tiles_n;
  const int k_tiles = K / Op::kBK;

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
      epi(acc, m0 + c * 64, n0, warp, lane, staging + c * Epi::kStagingBytes, 1 + c, M, N);
    }
  }
}

}  // namespace sm90
}  // namespace mocr
