// Kernel C on thread-block clusters: the whole greedy decode (bf16 or int8
// decoder weights, bf16 cross-K/V slabs, the erf GELU, no ablate) in one
// launch.  It serves the serving form (bf16 weights, slabs precomputed),
// the fuse_kv form (slabs written just before by ops/decode_loop.py
// cross_kv_prologue: the final LN's row pass and the bf16 GEMM of
// mlp_bf16.cu, on the same stream) and both again with quantize_decoder
// weights (int8_w, a kernel of its own).  The diagnosis forms (ablate,
// the sigmoid GELU) and the shapes this kernel does not take run on
// decode_loop.cuh; ops/decode_loop.py decode_form chooses before any
// launch.
//
// Replaces (Pallas, TPU): manga_ocr_tpu/ops/decode_loop.py greedy_decode_loop
// -> _loop_call -> _decode_loop_kernel, in its serving form.
//
// What bounds it on the H100.  Each row-step reads all decoder weights
// (~44 MB bf16 at full width) and its own cross slabs and live self cache
// (2 layers x K, V x 197 x 768 bf16 = 1.2 MB, plus 4 x (t+1) x 768 bf16),
// which no cache holds at B=256 (310 MB of slabs).  decode_loop.cuh streams
// the weights once per ROW from L2 through CUDA-core GEMVs: ~11 GB of L2
// reads a step at B=256.  Here a cluster of H CTAs (one per decoder head)
// owns a tile of rows, and each CTA streams only its 1/H of the weights
// once per TILE into tensor-core products, so the weight stream falls ~16 x
// H fold and the slab and cache re-reads from HBM (~49 ms for 299 steps at
// B=256) become the floor.  Measured (PERF.md), the kernel is bound by
// latency, not by either stream: one 512-thread CTA per SM at the
// 128-register cap, a chain of barriers and cluster syncs a step, and each
// warp waiting on one K/V or weight round trip at a time; the attention
// takes about half a step, the projections a quarter.
//
// Design:
// - grid: one cluster of H CTAs (H = decoder heads: 8 at full width, the
//   portable maximum) per tile of R rows, as many clusters as the card
//   seats at once (cudaOccupancyMaxActiveClusters: 15 on the H100), each
//   looping over tiles if the batch has more.  R is 16, or, when that would
//   take a second wave, the fewest rows (up to 32, two m16 row tiles, as
//   far as shared memory holds them: 19 at full width) that let one wave
//   hold the batch (B=256: 15 tiles of 18).  Padded rows of the last tile
//   are computed but write nothing.
// - residual rows: every CTA keeps the tile's residual rows as bf16 in
//   shared memory (the A operand of every projection) and computes the
//   embedding and every LN redundantly, in the same order, so all CTAs hold
//   the same bits.
// - projections: CTA h computes its column slice for all R rows with
//   mma.sync.m16n8k16 (bf16 in, f32 sums, then the f32 bias): self q|k|v
//   of head h, cross q of head h, 1/H of o, cross o, fc2 and the head
//   transform, 1/H of fc1 and of the (padded) vocab.  A fragments come by
//   ldmatrix from the shared rows; B fragments straight from L2 in the
//   order the wrapper packs them (ops/decode_loop.py pack_fragments: one
//   16-byte load per lane per tile per two k16 steps, 512 contiguous bytes
//   a warp), past L1 and kept in L2 (evict_last) while the slabs stream
//   past.  Each weight byte is used once per CTA per step, so staging it
//   through shared memory would only add a copy.  16 warps split a
//   projection into tiles and, where the tiles are few, into parts along K
//   whose f32 sums are added in part order (the wrapper's plan, _proj_plan).
// - attention, per CTA and head, on CUDA cores as decode_loop.cuh attends:
//   q rounded to bf16, f32 scores x scale, exp(s - max) * (1/sum), p rounded
//   to bf16, f32 PV.  CTA h alone writes and reads head h's slice of the
//   self cache, and reads head h's slice of the cross slabs.  A warp per
//   row where the tile has at most 16 rows; (row, 32-key) units spread over
//   the warps where it has more.  A lane loads a key's whole 192-byte head
//   row at once; where the clusters leave most of the card idle, the warps
//   also ask L2 for the next keys ahead of their loads.
// - exchange through distributed shared memory: after each sliced stage
//   (attention context, o, cross context, cross o, GELU(fc1), fc2, the
//   head transform) a CTA writes its slice to one of two exchange buffers,
//   cluster.sync(), and every CTA gathers the H slices into full rows
//   (16-byte DSMEM reads).  The two buffers alternate, so one sync per
//   exchange suffices: a buffer is written again only after the next sync,
//   which every reader of its previous contents has passed.  fc2 gathers
//   the whole hidden row (16 x 3072 bf16 = 96 KB) and keeps the summation
//   of the other projections (one K split per warp part) rather than
//   splitting K across CTAs and reducing partial [16, 768] sums, which
//   would add a second exchange.
// - head: each CTA finds the first maximum of its vocab columns per row,
//   then every CTA reduces the H candidates in rank order (greater value,
//   or equal value and lower index), so all end the step with the same
//   tokens and done flags; the early exit is uniform across the cluster,
//   and a last cluster.sync() keeps every CTA's shared memory alive until
//   no peer can read it.
// - registers: the projection, the vocab argmax and the attention are calls
//   of their own, each taking its pointers by value, so each gets the
//   128 registers apart from the kernel's body (inlined, they spilled ~2 KB
//   a thread).
// - bookkeeping as decode_loop.cuh: PAD after EOS, lengths count BOS and
//   EOS, stops force done at t + 2 >= stops[b], tokens start BOS | PAD
//   (written by CTA 0 of the cluster).
// - int8_w (decode_cluster_i8_kernel, apart from the bf16 kernel: one
//   kernel for every form slowed the serving form 4-14% on the H100): the
//   six projections of a layer (self q|k|v, o, cross q, cross o, fc1, fc2)
//   on mma.sync.m16n8k32 s8, A by ldmatrix from int8 rows in shared memory
//   (16 bytes a row piece, the byte layout of the bf16 k16 fragment), B
//   from L2 in the s8 fragment order (pack_fragments of int8 weights: one
//   16-byte load per lane per tile per two k32 steps), exact int32 sums
//   (any K split gives the same bits), then (acc * sx) * sw + b with
//   __fmul_rn/__fadd_rn, as kernel_utils.quant_rows + int8_matmul and
//   rows.cuh gemv_i8 compute it.  Each input row is quantized unrounded,
//   as JAX's _proj does, by the pass that already holds it: the residual
//   rows by the LN pass that writes them (every CTA alike; after the
//   embedding, by a pass of their own); the f32 attention context
//   exchanged as f32 (dh * 4 bytes a row) and gathered by a warp per row
//   straight into registers, quantized whole by every CTA; the f32
//   GELU(fc1) slice, too wide to gather as f32, by the row's
//   max over the cluster (each CTA's slice max through distributed shared
//   memory, one more cluster barrier a layer: a max is exact and
//   order-free, so every CTA gets the same scale), then exchanged as
//   int8.  The head, the embedding, the LNs, the attention and the caches
//   stay as in the bf16 kernel.
#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace mocr;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 16, THREADS = 32 * WARPS;
constexpr int MAX_ROWS = 32;  // rows of a tile: up to two m16 row tiles
constexpr int MAX_T = 6;      // n8 tiles a warp holds (ops/decode_loop.py _MAX_TILES)
constexpr int MAX_LAYERS = 4;
constexpr int MAX_DH = 128;   // head dims (multiples of 16) up to this
constexpr int KEY_CHUNK = 32; // keys of one attention unit

constexpr int N_PLANS = 8;
enum { P_QKV, P_O, P_CQ, P_CO, P_FC1, P_FC2, P_TR, P_VOCAB };

// One projection's split (ops/decode_loop.py _proj_plan): K inputs, n
// columns of this CTA's slice, kp parts along K, t tiles a warp holds.
struct Plan {
  int k, n, kp, t;
};

struct ClusterLayer {
  const uint4* wqkv; const float* bqkv;
  const uint4* wo; const float* bo; const float* slns; const float* slnb;
  const uint4* wcq; const float* bcq;
  const uint4* wco; const float* bco; const float* clns; const float* clnb;
  const uint4* w1; const float* b1;
  const uint4* w2; const float* b2; const float* mlns; const float* mlnb;
};
constexpr int N_INT8_PLANS = P_FC2 + 1;  // int8_w's int8 projections: the plans before P_TR
constexpr int COMMON_PTRS = 16, LAYER_PTRS = 18, INT8_PTRS = N_INT8_PLANS;
constexpr int N_INTS = 12 + 2 * N_PLANS;

struct ClusterParams {
  const bf16* tok_emb; const bf16* pos_emb; const bf16* tok_type;
  const float* elns; const float* elnb;
  const uint4* wt; const float* bt; const float* hlns; const float* hlnb;
  const uint4* wp; const float* bp;  // vocab padded to H * Vs columns
  const bf16* cross_k; const bf16* cross_v;  // [L, B, S, D]
  bf16* cache_k; bf16* cache_v;              // [L, B, steps, D]
  const int* stops;                          // [B] or null
  ClusterLayer layers[MAX_LAYERS];
  Plan plan[N_PLANS];
  int B, D, H, I, V, Vs, L, S, steps, bos, eos, pad;
  int R;  // rows of a tile (a cluster's rows at once)
  int prefetch;  // attention asks L2 for K/V rows ahead of their loads
  float scale, eps;
  long long* prof;  // [N_STAGES] clock sums of CTA 0 (the profiled kernel only)
};

// The int8_w kernel's parameters: the bf16 kernel's (whose parameter block
// stays as it is) and the per-column f32 weight scales of each layer's
// int8 projections, in plan order, per head slice as the biases.
struct ClusterParamsI8 : ClusterParams {
  const float* scales[MAX_LAYERS][N_INT8_PLANS];
};

// k values of one 64-byte pair of k steps (a lane's 16-byte B load): 32
// bf16 (two k16 steps) or 64 int8 (two k32 steps)
__host__ __device__ inline int pair_k(bool int8, int plan) {
  return int8 && plan < N_INT8_PLANS ? 64 : 32;
}

// The stages a profiled launch times (ops/decode_loop.py CLUSTER_STAGES).
enum { S_EMBED, S_PROJ, S_SELF, S_CROSS, S_XCH, S_LN, S_VOCAB, S_TOKEN, S_QUANT, N_STAGES };

__device__ __forceinline__ long long clock_now() { return clock64(); }

// Thread 0 of CTA 0 adds the clocks since its last mark to a stage's sum;
// each mark follows a barrier, so a stage's time is the whole CTA's.  The
// serving kernel (kProf false) has no marks.
template <bool kProf>
struct StageClock {
  long long* acc;
  long long last;
  __device__ explicit StageClock(long long* prof)
      : acc(kProf && threadIdx.x == 0 && blockIdx.x == 0 ? prof : nullptr), last(clock_now()) {}
  __device__ __forceinline__ void mark(int stage) {
    if constexpr (kProf) {
      __syncthreads();
      if (acc) {
        const long long now = clock_now();
        acc[stage] += now - last;
        last = now;
      }
    }
  }
};

// The CTA's shared memory, R rows (ops/decode_loop.py _cluster_smem mirrors it).
struct Smem {
  bf16* xs; int ldx;      // [R][D + 8] residual rows, the projections' A
  char* u; int ldu;       // [R][max(D, I) + 8] bf16 gathered rows; also the
                          // f32 head rows and the attention's partial sums
  float* pout; int ldp;   // [R][slice] f32 projection output
  char* xch[2]; int xrow; // [R][xrow bytes] exchange buffers
  float* sc; int lds;     // [R][max(steps, S)] scores, then p
  float* red_v; int* red_i;    // [WARPS][R] argmax candidates of each warp
  float* cand_v; int* cand_i;  // [R] this CTA's candidates (peers read them)
  int* prev; int* done; int* lens;
};

__host__ __device__ inline long imax(long a, long b) { return a > b ? a : b; }

__host__ __device__ inline int slice_max(const ClusterParams& p) {
  return (int)imax(3 * (p.D / p.H), imax(p.I / p.H, p.D / p.H));
}

__host__ __device__ inline int xch_row(const ClusterParams& p) {
  return (int)imax(2 * (p.I / p.H), 4 * (p.D / p.H));
}

__host__ __device__ inline int key_chunks(const ClusterParams& p) {
  return (int)((imax(p.steps, p.S) + KEY_CHUNK - 1) / KEY_CHUNK);
}

__host__ __device__ inline long u_bytes(const ClusterParams& p, int R) {
  const long attn = (long)R * key_chunks(p) * (p.D / p.H) * 4 + (long)WARPS * 32 * 8 * 4;
  return imax(imax((long)R * (imax(p.D, p.I) + 8) * 2, (long)R * p.D * 4), attn);
}

__host__ __device__ inline long smem_bytes(const ClusterParams& p, int R, bool int8) {
  return (long)R * (p.D + 8) * 2 + u_bytes(p, R) + (long)R * slice_max(p) * 4 +
         (long)2 * R * xch_row(p) + (long)R * imax(p.steps, p.S) * 4 +
         (long)2 * WARPS * R * 4 + 2 * R * 4 + 3 * R * 4 + (int8 ? 2 * R * 4 : 0);
}


__device__ Smem carve(unsigned char* base, const ClusterParams& p) {
  const int R = p.R;
  Smem s;
  char* c = reinterpret_cast<char*>(base);
  s.ldx = p.D + 8;
  s.xs = reinterpret_cast<bf16*>(c);
  c += (size_t)R * s.ldx * 2;
  s.ldu = (int)imax(p.D, p.I) + 8;
  s.u = c;
  c += u_bytes(p, R);
  s.ldp = slice_max(p);
  s.pout = reinterpret_cast<float*>(c);
  c += (size_t)R * s.ldp * 4;
  s.xrow = xch_row(p);
  s.xch[0] = c;
  s.xch[1] = c + R * s.xrow;
  c += 2 * R * s.xrow;
  s.lds = (int)imax(p.steps, p.S);
  s.sc = reinterpret_cast<float*>(c);
  c += (size_t)R * s.lds * 4;
  s.red_v = reinterpret_cast<float*>(c);
  s.red_i = reinterpret_cast<int*>(s.red_v + WARPS * R);
  s.cand_v = reinterpret_cast<float*>(s.red_i + WARPS * R);
  s.cand_i = reinterpret_cast<int*>(s.cand_v + R);
  s.prev = s.cand_i + R;
  s.done = s.prev + R;
  s.lens = s.done + R;
  return s;
}

// The int8_w kernel's buffers beyond carve's, computed where used (no
// registers held for them across the step): its gathered D-wide bf16 rows
// sit D + 8 apart at u (carve's ldu is for I-wide rows, which this kernel
// exchanges as int8); past them the int8 A rows of the next projection
// (the residual or the context, quantized; (D + 8) * 2 + D + 16 bytes a
// row, within u's 4 D for f32 rows); the gathered int8 GELU(fc1) rows at
// u, I + 16 bytes apart; after the row state the A rows' scales, then this
// CTA's per-row slice max (peers read it).
__device__ __forceinline__ int ldu_i8(const ClusterParams& p) { return p.D + 8; }
__device__ __forceinline__ int ldq_i8(const ClusterParams& p) { return p.D + 16; }
__device__ __forceinline__ int ldh_i8(const ClusterParams& p) { return p.I + 16; }
__device__ __forceinline__ int8_t* xq_i8(const Smem& s, const ClusterParams& p) {
  return reinterpret_cast<int8_t*>(s.u + (size_t)p.R * ldu_i8(p) * 2);
}
__device__ __forceinline__ float* sx_i8(const Smem& s, const ClusterParams& p) {
  return reinterpret_cast<float*>(s.lens + p.R);
}

// L2 policy of the weights (~44 MB, read by every cluster every step):
// kept (evict_last) while the slabs and the caches stream past.
__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t pol;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// A weight fragment: read once per CTA per step, so past L1, and kept in L2.
__device__ __forceinline__ uint4 ldg_weight(const uint4* ptr, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.u32 {%0,%1,%2,%3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(ptr), "l"(pol));
  return v;
}

// Asks L2 for the 128-byte line holding ``p`` (no register waits for it).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// One tensor-core step: bf16 m16n8k16 into f32 sums, or s8 m16n8k32 into
// exact int32 sums (the same register layouts, byte for byte).
__device__ __forceinline__ void mma_step(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  mma_bf16(c, a, b);
}
__device__ __forceinline__ void mma_step(int (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  mma_s8(c, a, b);
}

// The product of this warp's tiles over its part of K for MT row tiles of
// 16: acc[m][i] is row tile m, column tile base + grp + i * groups (a tile
// past the end loads nothing and is never written).  Rows at or past R read
// row R - 1 (their sums are never written).  A is bf16 (f32 sums) or int8
// (int32 sums); a k pair is 64 bytes of a row either way.
template <int T, int MT, typename E, typename Acc>
__device__ __forceinline__ void tile_products(const E* A, int lda, int R,
                                              const uint4* __restrict__ W, int nt, int n_pairs,
                                              int p0, int pp, int base, int grp, int groups,
                                              Acc (&acc)[MT][T][4]) {
  constexpr int V = 16 / sizeof(E);  // values of a 16-byte row piece (a k step's half)
  const int lane = threadIdx.x & 31;
  // ldmatrix x4: lanes 0-7 rows 0-7 / k 0-7, 8-15 rows 8-15 / k 0-7,
  // 16-23 rows 0-7 / k 8-15, 24-31 rows 8-15 / k 8-15: the m16k16 A fragment
  // (in bytes, also the m16k32 s8 one)
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = V * (lane >> 4) + p0 * 4 * V;
  const E* a_row[MT];
#pragma unroll
  for (int m = 0; m < MT; ++m) a_row[m] = A + min(16 * m + lrow, R - 1) * lda + lcol;
  const uint4* w0 = W + ((long)(base + grp) * n_pairs + p0) * 32 + lane;
  const long stride = (long)groups * n_pairs * 32;  // between a warp's tiles
  const int n_valid = nt - base - grp;  // tiles i < n_valid exist
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < T; ++i) acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = Acc(0);
  const uint64_t pol = l2_evict_last();
  constexpr int kUnroll = T <= 3 ? 4 : 2;  // 8-12 weight loads in flight a lane
#pragma unroll kUnroll
  for (int p = 0; p < pp; ++p) {
    uint4 b[T];
#pragma unroll
    for (int i = 0; i < T; ++i)
      b[i] = i * groups < n_valid ? ldg_weight(w0 + i * stride + p * 32, pol)
                                  : make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t a0[4], a1[4];
      ldmatrix_x4<false>(a0, a_row[m] + p * 4 * V);
      ldmatrix_x4<false>(a1, a_row[m] + p * 4 * V + 2 * V);
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const uint32_t b0[2] = {b[i].x, b[i].y}, b1[2] = {b[i].z, b[i].w};
        mma_step(acc[m][i], a0, b0);
        mma_step(acc[m][i], a1, b1);
      }
    }
  }
}

// out[r][c] = A[r][:k] . W[:, c] + bias[c] (f32) for the R rows and this
// CTA's pl.n columns; W, bias (and sw) already point at the CTA's slice.
// int8 A: out[r][c] = (acc * sx[r]) * sw[c] + bias[c], the parts' exact
// int32 sums added first.
template <int T, int MT, typename E>
__device__ __forceinline__ void project_t(const E* A, int lda, int R,
                                          const uint4* __restrict__ W,
                                          const float* __restrict__ bias, const Plan& pl,
                                          float* out, int ldo, const float* sx = nullptr,
                                          const float* __restrict__ sw = nullptr) {
  constexpr bool kS8 = sizeof(E) == 1;
  using Acc = typename std::conditional<kS8, int, float>::type;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = pl.n / 8, n_pairs = pl.k / (kS8 ? 64 : 32), kp = pl.kp;
  const int groups = WARPS / kp, part = warp / groups, grp = warp % groups;
  const int pp = n_pairs / kp;
  const int g = lane >> 2, q = lane & 3;
  for (int base = 0; base < nt; base += groups * T) {
    Acc acc[MT][T][4];
    tile_products<T, MT>(A, lda, R, W, nt, n_pairs, part * pp, pp, base, grp, groups, acc);
    for (int pt = 0; pt < kp; ++pt) {  // the parts' sums, added in part order
      if (part == pt) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int i = 0; i < T; ++i) {
            const int j = base + grp + i * groups;
            if (j >= nt) continue;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 16 * m + g + 8 * (e >> 1), c = 8 * j + 2 * q + (e & 1);
              if (r >= R) continue;
              if constexpr (kS8) {  // int32 partial sums in out until the last part
                int v = acc[m][i][e];
                if (pt) v += reinterpret_cast<const int*>(out)[r * ldo + c];
                if (pt == kp - 1)
                  out[r * ldo + c] =
                      __fadd_rn(__fmul_rn(__fmul_rn((float)v, sx[r]), sw[c]), bias[c]);
                else
                  reinterpret_cast<int*>(out)[r * ldo + c] = v;
              } else {
                float v = acc[m][i][e];
                if (pt) v += out[r * ldo + c];
                if (pt == kp - 1) v += bias[c];
                out[r * ldo + c] = v;
              }
            }
          }
      }
      __syncthreads();
    }
  }
}

template <int MT, typename E>
__device__ __forceinline__ void project_mt(const E* A, int lda, int R, const uint4* W,
                                           const float* bias, const Plan& pl, float* out,
                                           int ldo, const float* sx = nullptr,
                                           const float* sw = nullptr) {
  switch (pl.t) {
    case 1: project_t<1, MT>(A, lda, R, W, bias, pl, out, ldo, sx, sw); break;
    case 2: project_t<2, MT>(A, lda, R, W, bias, pl, out, ldo, sx, sw); break;
    case 3: project_t<3, MT>(A, lda, R, W, bias, pl, out, ldo, sx, sw); break;
    case 4: project_t<4, MT>(A, lda, R, W, bias, pl, out, ldo, sx, sw); break;
    case 5: project_t<5, MT>(A, lda, R, W, bias, pl, out, ldo, sx, sw); break;
    default: project_t<MAX_T, MT>(A, lda, R, W, bias, pl, out, ldo, sx, sw); break;
  }
}

// One projection of the step (a call of its own, so its registers are
// allocated apart from the kernel's): the CTA's slice of ``rank``.
__device__ __noinline__ void project(const bf16* A, int lda, int R, const uint4* W,
                                     const float* bias, Plan pl, int rank, float* out, int ldo) {
  W += (long)rank * (pl.n / 8) * (pl.k / 32) * 32;
  bias += rank * pl.n;
  if (R > 16)
    project_mt<2>(A, lda, R, W, bias, pl, out, ldo);
  else
    project_mt<1>(A, lda, R, W, bias, pl, out, ldo);
}

// The int8 form of ``project`` (a call of its own too): A the int8 rows
// (``lda`` bytes apart) with their scales sx, W packed s8, sw and bias the
// f32 per-column scales and biases.
__device__ __noinline__ void project_i8(const int8_t* A, int lda, const float* sx, int R,
                                        const uint4* W, const float* sw, const float* bias,
                                        Plan pl, int rank, float* out, int ldo) {
  W += (long)rank * (pl.n / 8) * (pl.k / 64) * 32;
  sw += rank * pl.n;
  bias += rank * pl.n;
  if (R > 16)
    project_mt<2>(A, lda, R, W, bias, pl, out, ldo, sx, sw);
  else
    project_mt<1>(A, lda, R, W, bias, pl, out, ldo, sx, sw);
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// The first maximum of (A[r] . Wp[:, c] + bp[c]) over this CTA's vocab
// columns c (global index col0 + c, < V) per row -> cand_v / cand_i.
template <int T, int MT>
__device__ __forceinline__ void vocab_argmax_t(const bf16* A, int lda, int R,
                                               const uint4* __restrict__ W,
                                               const float* __restrict__ bias, const Plan& pl,
                                               int col0, int V, float* red_v, int* red_i,
                                               float* cand_v, int* cand_i) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = pl.n / 8, n_pairs = pl.k / 32;
  const int g = lane >> 2, q = lane & 3;
  float bv[MT][2];
  int bi[MT][2];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    bv[m][0] = bv[m][1] = -INFINITY;
    bi[m][0] = bi[m][1] = 0x7fffffff;
  }
  for (int base = 0; base < nt; base += WARPS * T) {
    float acc[MT][T][4];
    tile_products<T, MT>(A, lda, R, W, nt, n_pairs, 0, n_pairs, base, warp, WARPS, acc);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < T; ++i) {
        const int j = base + warp + i * WARPS;
        if (j >= nt) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * q + (e & 1), col = col0 + c, h = e >> 1;
          const float v = acc[m][i][e] + bias[c];
          if (col < V && better(v, col, bv[m][h], bi[m][h])) {
            bv[m][h] = v;
            bi[m][h] = col;
          }
        }
      }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      for (int o = 1; o < 4; o <<= 1) {  // the four lanes of one row
        const float ov = __shfl_xor_sync(0xffffffffu, bv[m][h], o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi[m][h], o);
        if (better(ov, oi, bv[m][h], bi[m][h])) {
          bv[m][h] = ov;
          bi[m][h] = oi;
        }
      }
      const int r = 16 * m + g + 8 * h;
      if (q == 0 && r < R) {
        red_v[warp * R + r] = bv[m][h];
        red_i[warp * R + r] = bi[m][h];
      }
    }
  __syncthreads();
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float v = red_v[r];
    int i = red_i[r];
    for (int w = 1; w < WARPS; ++w)
      if (better(red_v[w * R + r], red_i[w * R + r], v, i)) {
        v = red_v[w * R + r];
        i = red_i[w * R + r];
      }
    cand_v[r] = v;
    cand_i[r] = i;
  }
  __syncthreads();
}

template <int MT>
__device__ __forceinline__ void vocab_argmax_mt(const bf16* A, int lda, int R, const uint4* W,
                                                const float* bias, const Plan& pl, int col0,
                                                int V, float* red_v, int* red_i, float* cand_v,
                                                int* cand_i) {
  switch (pl.t) {
#define MOCR_VOCAB_CASE(T)                                                                     \
  case T:                                                                                      \
    vocab_argmax_t<T, MT>(A, lda, R, W, bias, pl, col0, V, red_v, red_i, cand_v, cand_i); \
    break;
    MOCR_VOCAB_CASE(1)
    MOCR_VOCAB_CASE(2)
    MOCR_VOCAB_CASE(3)
    MOCR_VOCAB_CASE(4)
    MOCR_VOCAB_CASE(5)
#undef MOCR_VOCAB_CASE
    default:
      vocab_argmax_t<MAX_T, MT>(A, lda, R, W, bias, pl, col0, V, red_v, red_i, cand_v, cand_i);
      break;
  }
}

// The vocab slice's argmax (a call of its own, as ``project``).
__device__ __noinline__ void vocab_argmax(const bf16* A, int lda, int R, const uint4* W,
                                          const float* bias, Plan pl, int rank, int V,
                                          float* red_v, int* red_i, float* cand_v, int* cand_i) {
  W += (long)rank * (pl.n / 8) * (pl.k / 32) * 32;
  bias += rank * pl.n;
  const int col0 = rank * pl.n;
  if (R > 16)
    vocab_argmax_mt<2>(A, lda, R, W, bias, pl, col0, V, red_v, red_i, cand_v, cand_i);
  else
    vocab_argmax_mt<1>(A, lda, R, W, bias, pl, col0, V, red_v, red_i, cand_v, cand_i);
}

__device__ __forceinline__ float2 to_f32x2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 to_f32x2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

constexpr int LN_BATCH = 4;  // value pairs of LN parameters a lane loads at once (8: 6% slower)

// One warp's LN of a row in shared memory (f32 or bf16 values; ``out``
// may be ``in``: a lane reads and writes only its own pairs d = 2 lane +
// 64 i): f32 statistics (mean, then the mean of centred squares), y = (v -
// mu) * (1/sqrt(var + eps)) * scale + bias, stored rounded to bf16.  The
// parameters come from L2 LN_BATCH pairs at a time.  (Loading them before
// the statistics, to overlap their wait, held 48 more registers across the
// kernel's body and slowed it 8-10% on the H100.)
template <typename In>
__device__ __forceinline__ void warp_ln_row(const In* in, int D, const float* __restrict__ scale,
                                            const float* __restrict__ bias, float eps,
                                            bf16* out) {
  const int lane = threadIdx.x & 31;
  float2 sc[LN_BATCH], bi[LN_BATCH];
  auto load_params = [&](int d0) {
#pragma unroll
    for (int i = 0; i < LN_BATCH; ++i)
      if (d0 + 64 * i < D) {
        sc[i] = __ldg(reinterpret_cast<const float2*>(scale + d0 + 64 * i));
        bi[i] = __ldg(reinterpret_cast<const float2*>(bias + d0 + 64 * i));
      }
  };
  float s = 0.0f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 v = to_f32x2(in + d);
    s += v.x + v.y;
  }
  const float mu = warp_sum(s) / (float)D;
  float ss = 0.0f;
  for (int d = 2 * lane; d < D; d += 64) {
    const float2 v = to_f32x2(in + d);
    ss += (v.x - mu) * (v.x - mu) + (v.y - mu) * (v.y - mu);
  }
  const float r = 1.0f / sqrtf(warp_sum(ss) / (float)D + eps);
  for (int d0 = 2 * lane; d0 < D; d0 += 64 * LN_BATCH) {
    load_params(d0);
#pragma unroll
    for (int i = 0; i < LN_BATCH; ++i) {
      const int d = d0 + 64 * i;
      if (d >= D) continue;
      const float2 v = to_f32x2(in + d);
      *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(v.x - mu, r), sc[i].x), bi[i].x),
          __fadd_rn(__fmul_rn(__fmul_rn(v.y - mu, r), sc[i].y), bi[i].y));
    }
  }
}

// int8_w's row quantization, kernel_utils.quant_rows bit for bit: amax =
// max(max |x|, 1e-8), inv = 127 / amax, q = rint(x * inv) (no clip), sx =
// amax * (1/127).  One warp's row of K bf16 values in shared memory -> q
// (int8) and *sx; a lane takes the pairs d = 2 lane + 64 i, those that
// warp_ln_row writes, so it may follow it with no barrier.
__device__ __forceinline__ void quant_row(const bf16* x, int K, int8_t* q, float* sx) {
  const int lane = threadIdx.x & 31;
  float m = 0.0f;
  for (int d = 2 * lane; d < K; d += 64) {
    const float2 v = to_f32x2(x + d);
    m = fmaxf(m, fmaxf(fabsf(v.x), fabsf(v.y)));
  }
  const float amax = quant_amax(warp_max(m));
  const float inv = quant_inv(amax);
  for (int d = 2 * lane; d < K; d += 64) {
    const float2 v = to_f32x2(x + d);
    *reinterpret_cast<char2*>(q + d) = make_char2(quant_i8(v.x, inv), quant_i8(v.y, inv));
  }
  if (lane == 0) *sx = quant_sx(amax);
}

// Every row of the tile (warp w: rows w, w + WARPS, ...):
// x[r] = bf16(LN(bf16(x[r] + add[r]))).
__device__ __forceinline__ void residual_ln(bf16* x, int ldx, const bf16* add, int lda, int R,
                                            int D, const float* scale, const float* bias,
                                            float eps) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += WARPS) {
    bf16* xr = x + r * ldx;
    const bf16* ar = add + r * lda;
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 a = to_f32x2(xr + d), b = to_f32x2(ar + d);
      *reinterpret_cast<__nv_bfloat162*>(xr + d) = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
    }
    __syncwarp();
    warp_ln_row(xr, D, scale, bias, eps, xr);
  }
  __syncthreads();
}

// int8_w: residual_ln with each new row quantized by the warp that wrote
// it into q[r] (``ldq`` bytes apart) and sx[r], for the next projection (a
// call of its own, as ``project``).
__device__ __noinline__ void residual_ln_quant(bf16* x, int ldx, const bf16* add, int lda, int R,
                                               int D, const float* scale, const float* bias,
                                               float eps, int8_t* q, int ldq, float* sx) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += WARPS) {
    bf16* xr = x + r * ldx;
    const bf16* ar = add + r * lda;
    for (int d = 2 * lane; d < D; d += 64) {
      const float2 a = to_f32x2(xr + d), b = to_f32x2(ar + d);
      *reinterpret_cast<__nv_bfloat162*>(xr + d) = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
    }
    __syncwarp();
    warp_ln_row(xr, D, scale, bias, eps, xr);
    quant_row(xr, D, q + r * ldq, sx + r);
  }
  __syncthreads();
}

// int8_w: the tile's R bf16 rows (``ldx`` apart) quantized, a warp per row.
__device__ __noinline__ void quant_rows_tile(const bf16* x, int ldx, int R, int D, int8_t* q,
                                             int ldq, float* sx) {
  for (int r = threadIdx.x >> 5; r < R; r += WARPS) quant_row(x + r * ldx, D, q + r * ldq, sx + r);
  __syncthreads();
}

// U[r] = the H ranks' exchange rows r, concatenated (``w`` bytes each,
// a multiple of 16), as ``ld`` bytes a row.
__device__ __forceinline__ void gather(const cg::cluster_group& cl, char* xch, int xrow, int w,
                                       int H, int R, char* dst, int ld) {
  const int chunks = H * w / 16;
  for (int idx = threadIdx.x; idx < R * chunks; idx += blockDim.x) {
    const int r = idx / chunks, cb = (idx % chunks) * 16;
    const uint4* src = cl.map_shared_rank(reinterpret_cast<uint4*>(xch + r * xrow + cb % w),
                                          cb / w);
    *reinterpret_cast<uint4*>(dst + r * ld + cb) = *src;
  }
  __syncthreads();
}

// One unit of a row's PV, keys [j0, j1) of the probabilities p (V row j
// at vr0 + j * D): lane (grp = lane / NC, c = lane % NC) sums keys j0 + grp,
// j0 + grp + G, ... over its 8 dims, the G groups' sums meet in grp_sum
// ([G][DH] of this warp) and are added in group order, and put(i, d, a)
// takes dim d = lane + 32 i's sum.  Both attention paths build a row's
// context from these sums alone, added in chunk order from 0, so a row's
// tokens do not depend on the path: not on the tile's row count, so not on
// the bucket's batch size.  ``prefetch`` asks L2 for V two rounds ahead.
template <int NC, typename Put>
__device__ __forceinline__ void pv_chunk(const float* p, const bf16* vr0, int j0, int j1, int n,
                                         int D, float* grp_sum, bool prefetch, Put&& put) {
  constexpr int DH = 8 * NC, G = 32 / NC;
  const int lane = threadIdx.x & 31, c = lane % NC, grp = lane / NC;
  if (grp < G) {
    float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    const uint4* vr = reinterpret_cast<const uint4*>(vr0) + c;
#pragma unroll 16
    for (int j = j0 + grp; j < j1; j += G) {
      if (prefetch && c == 0 && j + 2 * 32 < n) {
        const char* vrow = reinterpret_cast<const char*>(vr0 + (long)(j + 2 * 32) * D);
        prefetch_l2(vrow);
        prefetch_l2(vrow + 16 * NC - 1);
      }
      const uint4 vv = vr[(long)j * (D / 8)];
      const float pj = p[j];
      const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 vf = __bfloat1622float2(v2[e]);
        acc[2 * e] += pj * vf.x;
        acc[2 * e + 1] += pj * vf.y;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) grp_sum[grp * DH + 8 * c + e] = acc[e];
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < (DH + 31) / 32; ++i) {
    const int d = lane + 32 * i;
    if (d < DH) {
      float a = 0.0f;
#pragma unroll
      for (int gg = 0; gg < G; ++gg) a += grp_sum[gg * DH + d];
      put(i, d, a);
    }
  }
  __syncwarp();
}

// Attention of the tile's live rows over n keys of one head, one warp per
// row (warp w: rows w, w + WARPS, ...), as decode_loop.cuh attends: q rounded
// to bf16, f32 scores x scale, exp(s - max) * (1/sum) rounded to bf16, f32
// PV.  Scores: a lane takes one key and loads its whole head row (NC
// 16-byte pieces) at once, after asking L2 for the next key it will take;
// PV: pv_chunk over each KEY_CHUNK keys, asking L2 for V two rounds ahead,
// the chunks added in order as attend_tile_t adds them.  No block barrier: the
// warps run their rows' phases independently.  K/V row b starts at k + b *
// kv_row_stride (offsets include the head).
template <int NC, bool kF32>
__device__ __forceinline__ void attend_rows_t(float* pout, int ldp, char* xch, int xrow,
                                              float* sc, int lds, float* u, const bf16* k,
                                              const bf16* v, long kv_row_stride, int n,
                                              int nrows, int D, float scale, bool prefetch) {
  constexpr int DH = 8 * NC, G = 32 / NC;
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nrows; r += WARPS) {
    float* q = pout + r * ldp;
    float* row = sc + r * lds;
    float* grp_sum = u + r * G * DH;  // [G][DH] of this warp
    const bf16* kr0 = k + r * kv_row_stride;
    const bf16* vr0 = v + r * kv_row_stride;
    for (int d = lane; d < DH; d += 32) q[d] = bf16_round(q[d]);
    __syncwarp();
    for (int j = lane; j < n; j += 32) {
      if (prefetch && j + 32 < n) {  // a key's head row spans two 128-byte lines
        const char* next = reinterpret_cast<const char*>(kr0 + (long)(j + 32) * D);
        prefetch_l2(next);
        prefetch_l2(next + 16 * NC - 1);
      }
      const uint4* kr = reinterpret_cast<const uint4*>(kr0 + (long)j * D);
      uint4 kv[NC];
  #pragma unroll
      for (int c = 0; c < NC; ++c) kv[c] = kr[c];
      float s = 0.0f;
  #pragma unroll
      for (int c = 0; c < NC; ++c) {
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv[c]);
  #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 kf = __bfloat1622float2(k2[e]);
          s += q[8 * c + 2 * e] * kf.x;
          s += q[8 * c + 2 * e + 1] * kf.y;
        }
      }
      row[j] = __fmul_rn(s, scale);
    }
    __syncwarp();
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
      if (prefetch && j < 2 * 32) {  // the first V rows of the PV below
        const char* vrow = reinterpret_cast<const char*>(vr0 + (long)j * D);
        prefetch_l2(vrow);
        prefetch_l2(vrow + 16 * NC - 1);
      }
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = bf16_round(__fmul_rn(row[j], inv));
    __syncwarp();
    // PV: the chunks' sums (pv_chunk) added in chunk order from 0, a lane
    // keeping its dims' running sums
    constexpr int DPL = (DH + 31) / 32;  // context dims a lane sums
    float ctx_sum[DPL];
  #pragma unroll
    for (int i = 0; i < DPL; ++i) ctx_sum[i] = 0.0f;
    for (int j0 = 0; j0 < n; j0 += KEY_CHUNK)
      pv_chunk<NC>(row, vr0, j0, min(n, j0 + KEY_CHUNK), n, D, grp_sum, prefetch,
                   [&](int i, int, float a) { ctx_sum[i] += a; });
  #pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d >= DH) continue;
      if constexpr (kF32)
        reinterpret_cast<float*>(xch + r * xrow)[d] = ctx_sum[i];
      else
        reinterpret_cast<bf16*>(xch + r * xrow)[d] = __float2bfloat16_rn(ctx_sum[i]);
    }
  }
}

// The same attention for tiles of more rows than warps.  The work is cut
// into units of (row, KEY_CHUNK keys) spread over the warps, so the tile
// stays balanced, at the cost of block barriers between the phases (on the
// H100 a tile of 18 rows ran 6% slower with two rows on each of two warps,
// and 2% slower with its first 16 rows a warp each and the rest in units):
//   1. scores: a lane takes one key of a unit and loads its whole head row
//      (NC 16-byte pieces) at once -> sc[r][j];
//   2. softmax: a warp per row;
//   3. PV: pv_chunk over each unit's keys -> parts[r][chunk];
//   4. ctx[r] = the sum of its chunks' parts in chunk order, as bf16 (or,
//      kF32, f32) rows of the exchange buffer.
// K/V row b starts at k + b * kv_row_stride (offsets include the head).
template <int NC, bool kF32>
__device__ __forceinline__ void attend_tile_t(float* pout, int ldp, char* xch, int xrow,
                                              float* sc, int lds, float* u, const bf16* k,
                                              const bf16* v, long kv_row_stride, int n,
                                              int nrows, int D, float scale, bool prefetch) {
  constexpr int DH = 8 * NC, G = 32 / NC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_ch = (n + KEY_CHUNK - 1) / KEY_CHUNK, units = nrows * n_ch;
  float* parts = u;                                  // [nrows][n_ch][DH]
  float* grp_sum = u + nrows * n_ch * DH + warp * G * DH;  // [G][DH] per warp
  for (int idx = threadIdx.x; idx < nrows * DH; idx += blockDim.x) {
    float* q = pout + (idx / DH) * ldp + idx % DH;
    *q = bf16_round(*q);
  }
  __syncthreads();
  // a key's head row (16 NC bytes) spans two 128-byte lines; a lane asks
  // L2 for the rows of one key of a unit ahead of their loads
  auto prefetch_unit = [&](const bf16* src, int unit) {
    const int r = unit / n_ch, j = (unit % n_ch) * KEY_CHUNK + lane;
    if (prefetch && unit < units && j < n) {
      const char* row = reinterpret_cast<const char*>(src + r * kv_row_stride + (long)j * D);
      prefetch_l2(row);
      prefetch_l2(row + 16 * NC - 1);
    }
  };
  prefetch_unit(v, warp);  // the first unit of this warp's PV
  for (int unit = warp; unit < units; unit += WARPS) {
    prefetch_unit(k, unit + WARPS);  // this warp's next unit
    const int r = unit / n_ch, j = (unit % n_ch) * KEY_CHUNK + lane;
    if (j >= n) continue;
    const uint4* kr = reinterpret_cast<const uint4*>(k + r * kv_row_stride + (long)j * D);
    const float* q = pout + r * ldp;
    uint4 kv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) kv[c] = kr[c];
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kv[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 kf = __bfloat1622float2(k2[e]);
        s += q[8 * c + 2 * e] * kf.x;
        s += q[8 * c + 2 * e + 1] * kf.y;
      }
    }
    sc[r * lds + j] = __fmul_rn(s, scale);
  }
  __syncthreads();
  for (int r = warp; r < nrows; r += WARPS) {
    float* row = sc + r * lds;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.0f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.0f / warp_sum(sum);
    for (int j = lane; j < n; j += 32) row[j] = bf16_round(__fmul_rn(row[j], inv));
  }
  __syncthreads();
  for (int unit = warp; unit < units; unit += WARPS) {
    prefetch_unit(v, unit + WARPS);
    const int r = unit / n_ch, ch = unit % n_ch;
    const int j0 = ch * KEY_CHUNK;
    pv_chunk<NC>(sc + r * lds, v + r * kv_row_stride, j0, min(n, j0 + KEY_CHUNK), n, D,
                 grp_sum, false,
                 [&](int, int d, float a) { parts[(r * n_ch + ch) * DH + d] = a; });
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nrows * DH; idx += blockDim.x) {
    const int r = idx / DH, d = idx % DH;
    float a = 0.0f;
    for (int ch = 0; ch < n_ch; ++ch) a += parts[(r * n_ch + ch) * DH + d];
    if constexpr (kF32)
      reinterpret_cast<float*>(xch + r * xrow)[d] = a;
    else
      reinterpret_cast<bf16*>(xch + r * xrow)[d] = __float2bfloat16_rn(a);
  }
}

// kF32 (the int8_w kernel): the context stays f32 in the exchange rows, as
// JAX's int8 _proj quantizes it unrounded.
template <bool kF32 = false>
__device__ __noinline__ void attend_tile(float* pout, int ldp, char* xch, int xrow, float* sc,
                                         int lds, float* u, const bf16* k, const bf16* v,
                                         long kv_row_stride, int n, int nrows, int R, int dh,
                                         int D, float scale, bool prefetch) {
  switch (dh / 8) {
#define MOCR_ATTEND_CASE(NC)                                                                  \
  case NC:                                                                                    \
    if (R <= WARPS)                                                                           \
      attend_rows_t<NC, kF32>(pout, ldp, xch, xrow, sc, lds, u, k, v, kv_row_stride, n, nrows, \
                              D, scale, prefetch);                                            \
    else                                                                                      \
      attend_tile_t<NC, kF32>(pout, ldp, xch, xrow, sc, lds, u, k, v, kv_row_stride, n, nrows, \
                              D, scale, prefetch);                                            \
    break;
    MOCR_ATTEND_CASE(2)
    MOCR_ATTEND_CASE(4)
    MOCR_ATTEND_CASE(6)
    MOCR_ATTEND_CASE(8)
    MOCR_ATTEND_CASE(10)
    MOCR_ATTEND_CASE(12)
    MOCR_ATTEND_CASE(14)
    MOCR_ATTEND_CASE(16)
#undef MOCR_ATTEND_CASE
    default: break;
  }
  // padded rows of the tile exchange zeros
  for (int idx = threadIdx.x; idx < (R - nrows) * dh; idx += blockDim.x) {
    char* row = xch + (nrows + idx / dh) * xrow;
    if constexpr (kF32)
      reinterpret_cast<float*>(row)[idx % dh] = 0.0f;
    else
      reinterpret_cast<bf16*>(row)[idx % dh] = __float2bfloat16_rn(0.0f);
  }
}

// -- int8_w: the row quantization (kernel_utils.quant_rows, bit for bit:
// amax = max(max |x|, 1e-8), inv = 127 / amax, q = rint(x * inv), no clip,
// sx = amax * (1/127)) -------------------------------------------------------

// The attention context's exchange under int8_w, after the cluster
// barrier: a warp per row loads the row's H f32 slices (``dh`` values each)
// from the peers' exchange rows straight into registers (16 bytes a lane
// at a time), takes its max |value| and quantizes the whole row (as
// quant_row) into q[r] and sx[r].  Every CTA gathers the same rows, so all
// make the same bits; the f32 row never lands in shared memory.
__device__ __noinline__ void gather_quant(const char* xch, int xrow, int dh, int H, int R,
                                          int8_t* q, int ldq, float* sx) {
  constexpr int MAXC = MAX_DH * 8 / 4 / 32;  // float4 pieces a lane holds (D <= 8 * MAX_DH)
  const cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31, pieces = H * dh / 4, per_rank = dh / 4;
  for (int r = threadIdx.x >> 5; r < R; r += WARPS) {
    float4 v[MAXC];
    float m = 0.0f;
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      if (c < pieces) {
        const float4* src = reinterpret_cast<const float4*>(xch + r * xrow) + c % per_rank;
        v[i] = *cl.map_shared_rank(src, c / per_rank);
        m = fmaxf(m, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                           fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
      }
    }
    const float amax = quant_amax(warp_max(m));
    const float inv = quant_inv(amax);
#pragma unroll
    for (int i = 0; i < MAXC; ++i) {
      const int c = lane + 32 * i;
      if (c < pieces)
        *reinterpret_cast<char4*>(q + r * ldq + 4 * c) =
            make_char4(quant_i8(v[i].x, inv), quant_i8(v[i].y, inv), quant_i8(v[i].z, inv),
                       quant_i8(v[i].w, inv));
    }
    if (lane == 0) sx[r] = quant_sx(amax);
  }
  __syncthreads();
}

// int8_w's GELU(fc1) rows, quantized with each row's max over the whole
// cluster: this CTA's slice (n f32 columns of pout) through the erf GELU,
// in place, and its per-row max |value| into amax[r]; after a cluster
// barrier, each row's max over the H slices (exact and order-free, so
// every CTA gets the same scale), and the slice quantized with it into the
// int8 exchange rows; sx[r] the row scale.
__device__ __noinline__ void gelu_quant_slice(int H, float* pout, int ldp, int R, int n,
                                              float* amax, char* xch, int xrow, float* sx) {
  const cg::cluster_group cl = cg::this_cluster();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < R; r += WARPS) {
    float m = 0.0f;
    for (int c = lane; c < n; c += 32) {
      const float v = gelu_erf(pout[r * ldp + c]);
      pout[r * ldp + c] = v;
      m = fmaxf(m, fabsf(v));
    }
    m = warp_max(m);
    if (lane == 0) amax[r] = m;
  }
  cl.sync();  // every CTA's slice maxima are written
  for (int r = threadIdx.x >> 5; r < R; r += WARPS) {
    const float m = lane < H ? *cl.map_shared_rank(amax + r, lane) : 0.0f;
    const float a = quant_amax(warp_max(m));
    const float inv = quant_inv(a);
    int8_t* q = reinterpret_cast<int8_t*>(xch + r * xrow);
    for (int c = lane; c < n; c += 32)
      q[c] = quant_i8(pout[r * ldp + c], inv);
    if (lane == 0) sx[r] = quant_sx(a);
  }
  __syncthreads();
}

// pout [R][n] -> the exchange buffer as bf16 (GELU first if asked) or f32.
template <int kMode>  // 0: bf16(v), 1: bf16(gelu_erf(v)), 2: f32 gelu_erf(v)
__device__ __forceinline__ void to_exchange(const Smem& s, char* xch, int R, int n) {
  for (int idx = threadIdx.x; idx < R * n; idx += blockDim.x) {
    const int r = idx / n, c = idx % n;
    const float v = s.pout[r * s.ldp + c];
    if constexpr (kMode == 2)
      reinterpret_cast<float*>(xch + r * s.xrow)[c] = gelu_erf(v);
    else
      reinterpret_cast<bf16*>(xch + r * s.xrow)[c] =
          __float2bfloat16_rn(kMode == 1 ? gelu_erf(v) : v);
  }
}

template <bool kProf>
__global__ void __launch_bounds__(THREADS, 1)
decode_cluster_kernel(ClusterParams p, int* __restrict__ tokens, int* __restrict__ lengths) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  // (the buffer table kept in shared memory instead of registers: 5%
  // faster at B=32, 4% slower at B=256 on the H100)
  const Smem s = carve(smem_raw, p);
  const int D = p.D, dh = D / p.H, fs = p.I / p.H, T = p.steps, R = p.R;
  const int lane = threadIdx.x & 31;
  const int n_clusters = gridDim.x / p.H, n_tiles = (p.B + R - 1) / R;
  const float eps = p.eps;
  const bf16* u_bf16 = reinterpret_cast<const bf16*>(s.u);
  float* u_f32 = reinterpret_cast<float*>(s.u);
  StageClock<kProf> clk(p.prof);
  int buf = 0;
  // every CTA's slice (``w`` bytes a row) of xch[buf] -> full rows of U
  // (``ld`` bytes apart); the next stage writes the other buffer
  auto exchange = [&](int w, int ld) {
    cl.sync();
    gather(cl, s.xch[buf], s.xrow, w, p.H, R, s.u, ld);
    buf ^= 1;
    clk.mark(S_XCH);
  };
  auto proj = [&](const bf16* A, int lda, const uint4* W, const float* bias, int k) {
    project(A, lda, R, W, bias, p.plan[k], rank, s.pout, s.ldp);
    clk.mark(S_PROJ);
  };

  for (int tile = blockIdx.x / p.H; tile < n_tiles; tile += n_clusters) {
    const int row0 = tile * R, nrows = min(R, p.B - row0);
    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      s.prev[r] = p.bos;
      s.done[r] = r < nrows ? 0 : 1;
      s.lens[r] = 1;
    }
    if (rank == 0)
      for (int idx = threadIdx.x; idx < nrows * (T + 1); idx += blockDim.x) {
        const int r = idx / (T + 1), c = idx % (T + 1);
        tokens[(long)(row0 + r) * (T + 1) + c] = c == 0 ? p.bos : p.pad;
      }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
      bool all_done = true;
      for (int r = 0; r < R; ++r) all_done = all_done && s.done[r];
      if (all_done) break;  // the same flags in every CTA of the cluster

      // -- embedding + LN (every CTA; warp w: rows w, w + WARPS, ...) --------
      for (int r = threadIdx.x >> 5; r < R; r += WARPS) {
        bf16* x = s.xs + r * s.ldx;
        const bf16* te = p.tok_emb + (long)s.prev[r] * D;
        const bf16* pe = p.pos_emb + (long)t * D;
        for (int d = 2 * lane; d < D; d += 64) {  // (batches of loads: 7% slower)
          const float2 a = to_f32x2(te + d), b = to_f32x2(pe + d), c = to_f32x2(p.tok_type + d);
          const float e0 = bf16_round(a.x + b.x), e1 = bf16_round(a.y + b.y);
          *reinterpret_cast<__nv_bfloat162*>(x + d) = __floats2bfloat162_rn(e0 + c.x, e1 + c.y);
        }
        __syncwarp();
        warp_ln_row(x, D, p.elns, p.elnb, eps, x);
      }
      __syncthreads();
      clk.mark(S_EMBED);

      for (int l = 0; l < p.L; ++l) {
        const ClusterLayer& w = p.layers[l];
        // -- self-attention: head ``rank``'s q|k|v, its cache slice ---------
        proj(s.xs, s.ldx, w.wqkv, w.bqkv, P_QKV);
        const long cache0 = ((long)l * p.B + row0) * T * D + rank * dh;
        for (int idx = threadIdx.x; idx < nrows * dh; idx += blockDim.x) {
          const int r = idx / dh, d = idx % dh;
          const long o = cache0 + ((long)r * T + t) * D + d;
          p.cache_k[o] = __float2bfloat16_rn(s.pout[r * s.ldp + dh + d]);
          p.cache_v[o] = __float2bfloat16_rn(s.pout[r * s.ldp + 2 * dh + d]);
        }
        __syncthreads();
        attend_tile(s.pout, s.ldp, s.xch[buf], s.xrow, s.sc, s.lds, u_f32, p.cache_k + cache0,
                    p.cache_v + cache0, (long)T * D, t + 1, nrows, R, dh, D, p.scale, p.prefetch);
        clk.mark(S_SELF);
        exchange(dh * 2, s.ldu * 2);
        proj(u_bf16, s.ldu, w.wo, w.bo, P_O);
        to_exchange<0>(s, s.xch[buf], R, dh);
        exchange(dh * 2, s.ldu * 2);
        residual_ln(s.xs, s.ldx, u_bf16, s.ldu, R, D, w.slns, w.slnb, eps);
        clk.mark(S_LN);

        // -- cross-attention over head ``rank``'s slice of the slabs --------
        proj(s.xs, s.ldx, w.wcq, w.bcq, P_CQ);
        const long slab0 = ((long)l * p.B + row0) * p.S * D + rank * dh;
        attend_tile(s.pout, s.ldp, s.xch[buf], s.xrow, s.sc, s.lds, u_f32, p.cross_k + slab0,
                    p.cross_v + slab0, (long)p.S * D, p.S, nrows, R, dh, D, p.scale, p.prefetch);
        clk.mark(S_CROSS);
        exchange(dh * 2, s.ldu * 2);
        proj(u_bf16, s.ldu, w.wco, w.bco, P_CO);
        to_exchange<0>(s, s.xch[buf], R, dh);
        exchange(dh * 2, s.ldu * 2);
        residual_ln(s.xs, s.ldx, u_bf16, s.ldu, R, D, w.clns, w.clnb, eps);
        clk.mark(S_LN);

        // -- MLP: 1/H of fc1 + erf GELU, gathered; 1/H of fc2 -------------
        proj(s.xs, s.ldx, w.w1, w.b1, P_FC1);
        to_exchange<1>(s, s.xch[buf], R, fs);
        exchange(fs * 2, s.ldu * 2);
        proj(u_bf16, s.ldu, w.w2, w.b2, P_FC2);
        to_exchange<0>(s, s.xch[buf], R, dh);
        exchange(dh * 2, s.ldu * 2);
        residual_ln(s.xs, s.ldx, u_bf16, s.ldu, R, D, w.mlns, w.mlnb, eps);
        clk.mark(S_LN);
      }

      // -- head: transform + erf GELU (f32, gathered), LN, vocab argmax ------
      proj(s.xs, s.ldx, p.wt, p.bt, P_TR);
      to_exchange<2>(s, s.xch[buf], R, dh);
      exchange(dh * 4, D * 4);
      for (int r = threadIdx.x >> 5; r < R; r += WARPS)
        warp_ln_row(u_f32 + r * D, D, p.hlns, p.hlnb, eps, s.xs + r * s.ldx);
      __syncthreads();
      clk.mark(S_LN);
      vocab_argmax(s.xs, s.ldx, R, p.wp, p.bp, p.plan[P_VOCAB], rank, p.V, s.red_v, s.red_i,
                   s.cand_v, s.cand_i);
      clk.mark(S_VOCAB);
      cl.sync();

      // -- the cluster's argmax (ranks in order) and the bookkeeping ---------
      if (threadIdx.x < R) {
        const int r = threadIdx.x;
        float v = -INFINITY;
        int i = 0x7fffffff;
        for (int k = 0; k < p.H; ++k) {
          const float kv = *cl.map_shared_rank(s.cand_v + r, k);
          const int ki = *cl.map_shared_rank(s.cand_i + r, k);
          if (better(kv, ki, v, i)) {
            v = kv;
            i = ki;
          }
        }
        if (r < nrows) {
          const int row = row0 + r;
          const int nxt = s.done[r] ? p.pad : i;
          if (rank == 0) tokens[(long)row * (T + 1) + t + 1] = nxt;
          if (!s.done[r]) s.lens[r] += 1;
          s.prev[r] = nxt;
          bool newly = nxt == p.eos;
          if (p.stops) newly = newly || (t + 2 >= p.stops[row]);
          s.done[r] = s.done[r] || newly;
        }
      }
      __syncthreads();
      clk.mark(S_TOKEN);
    }
    if (rank == 0 && threadIdx.x < nrows) lengths[row0 + threadIdx.x] = s.lens[threadIdx.x];
    __syncthreads();
  }
  cl.sync();  // no CTA leaves while a peer may still read its shared memory
}

// The int8_w form (quantize_decoder weights): the bf16 kernel's step with
// the six layer projections on s8 tensor cores and each of their input rows
// quantized by a call of its own.  A kernel of its own, so the serving
// kernel above stays as it was: its body runs at the 128-register cap, and
// one body for both forms moved the serving kernel's spills on the H100
// (the forms as template flags of one kernel ran it 4-14% slower).
// Inlined into this body, the LN pass's and the context's quantization
// spilled it further: 1% and 13% slower at B=256 (the latter with both
// inlined).
template <bool kProf>
__global__ void __launch_bounds__(THREADS, 1)
decode_cluster_i8_kernel(ClusterParamsI8 p, int* __restrict__ tokens, int* __restrict__ lengths) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const Smem s = carve(smem_raw, p);
  const int D = p.D, dh = D / p.H, fs = p.I / p.H, T = p.steps, R = p.R;
  const int lane = threadIdx.x & 31;
  const int n_clusters = gridDim.x / p.H, n_tiles = (p.B + R - 1) / R;
  const float eps = p.eps;
  const bf16* u_bf16 = reinterpret_cast<const bf16*>(s.u);
  float* u_f32 = reinterpret_cast<float*>(s.u);
  StageClock<kProf> clk(p.prof);
  int buf = 0;
  // every CTA's slice (``w`` bytes a row) of xch[buf] -> full rows of U
  // (``ld`` bytes apart); the next stage writes the other buffer
  auto exchange = [&](int w, int ld) {
    cl.sync();
    gather(cl, s.xch[buf], s.xrow, w, p.H, R, s.u, ld);
    buf ^= 1;
    clk.mark(S_XCH);
  };
  // the attention context: every CTA's f32 slice, gathered and quantized
  // whole into the int8 rows
  auto exchange_ctx = [&]() {
    cl.sync();
    gather_quant(s.xch[buf], s.xrow, dh, p.H, R, xq_i8(s, p), ldq_i8(p), sx_i8(s, p));
    buf ^= 1;
    clk.mark(S_XCH);
  };
  // layer l's int8 projection k of int8 rows A (``lda`` bytes apart)
  auto proj8 = [&](const int8_t* A, int lda, const uint4* W, const float* bias, int l, int k) {
    project_i8(A, lda, sx_i8(s, p), R, W, p.scales[l][k], bias, p.plan[k], rank, s.pout, s.ldp);
    clk.mark(S_PROJ);
  };
  // ... of the int8 residual or context rows
  auto proj_q = [&](const uint4* W, const float* bias, int l, int k) {
    proj8(xq_i8(s, p), ldq_i8(p), W, bias, l, k);
  };
  // the exchange of D-wide bf16 rows (D + 8 apart here)
  auto exchange_d = [&]() { exchange(dh * 2, ldu_i8(p) * 2); };
  // the residual rows' post-LN, quantized for the next projection
  auto ln_quant = [&](const float* scale, const float* bias) {
    residual_ln_quant(s.xs, s.ldx, u_bf16, ldu_i8(p), R, D, scale, bias, eps, xq_i8(s, p),
                      ldq_i8(p), sx_i8(s, p));
    clk.mark(S_LN);
  };

  for (int tile = blockIdx.x / p.H; tile < n_tiles; tile += n_clusters) {
    const int row0 = tile * R, nrows = min(R, p.B - row0);
    if (threadIdx.x < R) {
      const int r = threadIdx.x;
      s.prev[r] = p.bos;
      s.done[r] = r < nrows ? 0 : 1;
      s.lens[r] = 1;
    }
    if (rank == 0)
      for (int idx = threadIdx.x; idx < nrows * (T + 1); idx += blockDim.x) {
        const int r = idx / (T + 1), c = idx % (T + 1);
        tokens[(long)(row0 + r) * (T + 1) + c] = c == 0 ? p.bos : p.pad;
      }
    __syncthreads();

    for (int t = 0; t < T; ++t) {
      bool all_done = true;
      for (int r = 0; r < R; ++r) all_done = all_done && s.done[r];
      if (all_done) break;  // the same flags in every CTA of the cluster

      // -- embedding + LN (every CTA; warp w: rows w, w + WARPS, ...) --------
      for (int r = threadIdx.x >> 5; r < R; r += WARPS) {
        bf16* x = s.xs + r * s.ldx;
        const bf16* te = p.tok_emb + (long)s.prev[r] * D;
        const bf16* pe = p.pos_emb + (long)t * D;
        for (int d = 2 * lane; d < D; d += 64) {
          const float2 a = to_f32x2(te + d), b = to_f32x2(pe + d), c = to_f32x2(p.tok_type + d);
          const float e0 = bf16_round(a.x + b.x), e1 = bf16_round(a.y + b.y);
          *reinterpret_cast<__nv_bfloat162*>(x + d) = __floats2bfloat162_rn(e0 + c.x, e1 + c.y);
        }
        __syncwarp();
        warp_ln_row(x, D, p.elns, p.elnb, eps, x);
      }
      __syncthreads();
      clk.mark(S_EMBED);
      quant_rows_tile(s.xs, s.ldx, R, D, xq_i8(s, p), ldq_i8(p), sx_i8(s, p));
      clk.mark(S_QUANT);

      for (int l = 0; l < p.L; ++l) {
        const ClusterLayer& w = p.layers[l];
        // -- self-attention: head ``rank``'s q|k|v, its cache slice ---------
        proj_q(w.wqkv, w.bqkv, l, P_QKV);
        const long cache0 = ((long)l * p.B + row0) * T * D + rank * dh;
        for (int idx = threadIdx.x; idx < nrows * dh; idx += blockDim.x) {
          const int r = idx / dh, d = idx % dh;
          const long o = cache0 + ((long)r * T + t) * D + d;
          p.cache_k[o] = __float2bfloat16_rn(s.pout[r * s.ldp + dh + d]);
          p.cache_v[o] = __float2bfloat16_rn(s.pout[r * s.ldp + 2 * dh + d]);
        }
        __syncthreads();
        attend_tile<true>(s.pout, s.ldp, s.xch[buf], s.xrow, s.sc, s.lds, u_f32,
                          p.cache_k + cache0, p.cache_v + cache0, (long)T * D, t + 1, nrows, R,
                          dh, D, p.scale, p.prefetch);
        clk.mark(S_SELF);
        exchange_ctx();
        proj_q(w.wo, w.bo, l, P_O);
        to_exchange<0>(s, s.xch[buf], R, dh);
        exchange_d();
        ln_quant(w.slns, w.slnb);

        // -- cross-attention over head ``rank``'s slice of the slabs --------
        proj_q(w.wcq, w.bcq, l, P_CQ);
        const long slab0 = ((long)l * p.B + row0) * p.S * D + rank * dh;
        attend_tile<true>(s.pout, s.ldp, s.xch[buf], s.xrow, s.sc, s.lds, u_f32,
                          p.cross_k + slab0, p.cross_v + slab0, (long)p.S * D, p.S, nrows, R,
                          dh, D, p.scale, p.prefetch);
        clk.mark(S_CROSS);
        exchange_ctx();
        proj_q(w.wco, w.bco, l, P_CO);
        to_exchange<0>(s, s.xch[buf], R, dh);
        exchange_d();
        ln_quant(w.clns, w.clnb);

        // -- MLP: 1/H of fc1 + erf GELU, quantized with the row's max over
        //    the cluster and gathered as int8; 1/H of fc2 ------------------
        proj_q(w.w1, w.b1, l, P_FC1);
        gelu_quant_slice(p.H, s.pout, s.ldp, R, fs, sx_i8(s, p) + R, s.xch[buf], s.xrow,
                         sx_i8(s, p));
        clk.mark(S_QUANT);
        exchange(fs, ldh_i8(p));
        proj8(reinterpret_cast<const int8_t*>(s.u), ldh_i8(p), w.w2, w.b2, l, P_FC2);
        to_exchange<0>(s, s.xch[buf], R, dh);
        exchange_d();
        ln_quant(w.mlns, w.mlnb);
      }

      // -- head (bf16, as quantize_decoder leaves it): transform + erf GELU
      //    (f32, gathered), LN, vocab argmax ---------------------------------
      project(s.xs, s.ldx, R, p.wt, p.bt, p.plan[P_TR], rank, s.pout, s.ldp);
      clk.mark(S_PROJ);
      to_exchange<2>(s, s.xch[buf], R, dh);
      exchange(dh * 4, D * 4);
      for (int r = threadIdx.x >> 5; r < R; r += WARPS)
        warp_ln_row(u_f32 + r * D, D, p.hlns, p.hlnb, eps, s.xs + r * s.ldx);
      __syncthreads();
      clk.mark(S_LN);
      vocab_argmax(s.xs, s.ldx, R, p.wp, p.bp, p.plan[P_VOCAB], rank, p.V, s.red_v, s.red_i,
                   s.cand_v, s.cand_i);
      clk.mark(S_VOCAB);
      cl.sync();

      // -- the cluster's argmax (ranks in order) and the bookkeeping ---------
      if (threadIdx.x < R) {
        const int r = threadIdx.x;
        float v = -INFINITY;
        int i = 0x7fffffff;
        for (int k = 0; k < p.H; ++k) {
          const float kv = *cl.map_shared_rank(s.cand_v + r, k);
          const int ki = *cl.map_shared_rank(s.cand_i + r, k);
          if (better(kv, ki, v, i)) {
            v = kv;
            i = ki;
          }
        }
        if (r < nrows) {
          const int row = row0 + r;
          const int nxt = s.done[r] ? p.pad : i;
          if (rank == 0) tokens[(long)row * (T + 1) + t + 1] = nxt;
          if (!s.done[r]) s.lens[r] += 1;
          s.prev[r] = nxt;
          bool newly = nxt == p.eos;
          if (p.stops) newly = newly || (t + 2 >= p.stops[row]);
          s.done[r] = s.done[r] || newly;
        }
      }
      __syncthreads();
      clk.mark(S_TOKEN);
    }
    if (rank == 0 && threadIdx.x < nrows) lengths[row0 + threadIdx.x] = s.lens[threadIdx.x];
    __syncthreads();
  }
  cl.sync();  // no CTA leaves while a peer may still read its shared memory
}

// The launch configuration of ``kernel`` at ``rows`` rows a tile -> the
// clusters the card seats at once (0 if none).
template <class P>
int seated_clusters(void (*kernel)(P, int*, int*), const P& p, int rows, cudaLaunchConfig_t* cfg,
                    cudaLaunchAttribute* attr, cudaStream_t stream) {
  const long smem = smem_bytes(p, rows, std::is_same<P, ClusterParamsI8>::value);
  if (smem > 232448) return 0;  // the per-block opt-in limit
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return 0;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.H;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  *cfg = {};
  cfg->gridDim = dim3(((p.B + rows - 1) / rows) * p.H);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int seated = 0;
  if (cudaOccupancyMaxActiveClusters(&seated, kernel, cfg) != cudaSuccess) return 0;
  return seated;
}

// The tile's rows, the grid and the launch of ``kernel`` on ``p`` (see
// mocr_decode_cluster).
template <class P>
int launch_cluster(void (*kernel)(P, int*, int*), P& p, void* tokens, void* lengths,
                   int* clusters, cudaStream_t st) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  p.R = 16;
  int seated = seated_clusters(kernel, p, p.R, &cfg, attr, st);
  if (seated > 0 && (p.B + 15) / 16 > seated) {
    // more 16-row tiles than the card seats clusters: wider tiles, if one
    // wave of them fits
    const int wide = (p.B + seated - 1) / seated;
    if (wide <= MAX_ROWS) {
      const int wide_seated = seated_clusters(kernel, p, wide, &cfg, attr, st);
      if (wide_seated >= (p.B + wide - 1) / wide) {
        p.R = wide;
        seated = wide_seated;
      } else {
        seated = seated_clusters(kernel, p, p.R, &cfg, attr, st);
      }
    }
  }
  if (seated < 1) return (int)cudaErrorInvalidConfiguration;
  const int n = std::min((p.B + p.R - 1) / p.R, seated);
  clusters[0] = n;
  clusters[1] = seated;
  clusters[2] = p.R;
  // the L2 prefetch ahead of the attention's loads paid on the H100 when the
  // clusters left most of the card idle (B=32: -8%) and cost when they
  // filled it (B=240: +7%): the memory then streams at its rate anyway
  p.prefetch = 2 * n <= seated;
  cfg.gridDim = dim3(n * p.H);
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p, static_cast<int*>(tokens),
                                       static_cast<int*>(lengths));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs: COMMON_PTRS pointers (tok_emb, pos_emb, tok_type, elns, elnb, wt, bt,
// hlns, hlnb, wp, bp, cross_k, cross_v, cache_k, cache_v, stops-or-null),
// then per layer LAYER_PTRS in ClusterLayer order (weights packed per head,
// ops/decode_loop.py pack_fragments), followed, under ``int8`` (int8_w:
// the six projections' weights packed s8), by its INT8_PTRS scales in plan
// order.  ints: B, D, H, I, V, Vs (vocab columns of one CTA), L,
// S, steps, bos, eos, pad, then (kp, t) of each projection in plan order.
// A tile has 16 rows, or, where that takes more clusters than the card
// seats at once, the fewest rows (up to MAX_ROWS and what shared memory
// holds) that let one wave of clusters hold the batch.  clusters[0..2] get
// the clusters launched, the count the card seats at once and the rows of
// a tile.  ``prof`` (a device array of N_STAGES int64 zeros, or null) asks
// for the profiled instance, which adds its first CTA's clocks per stage
// there.
int mocr_decode_cluster(void** ptrs, int n_ptrs, int* ints, int n_ints, float scale, float eps,
                        int int8, void* tokens, void* lengths, int* clusters, void* prof,
                        void* stream) {
  if (n_ints != N_INTS) return (int)cudaErrorInvalidValue;
  ClusterParamsI8 p = {};  // the bf16 instances take its ClusterParams part
  p.B = ints[0]; p.D = ints[1]; p.H = ints[2]; p.I = ints[3]; p.V = ints[4]; p.Vs = ints[5];
  p.L = ints[6]; p.S = ints[7]; p.steps = ints[8]; p.bos = ints[9]; p.eos = ints[10];
  p.pad = ints[11];
  const int layer_ptrs = LAYER_PTRS + (int8 ? INT8_PTRS : 0);
  if (p.L < 1 || p.L > MAX_LAYERS || n_ptrs != COMMON_PTRS + layer_ptrs * p.L || p.B < 1)
    return (int)cudaErrorInvalidValue;
  if ((p.H != 1 && p.H != 2 && p.H != 4 && p.H != 8) || p.D % 64 || p.D % p.H)
    return (int)cudaErrorInvalidValue;
  const int dh = p.D / p.H;
  if (dh % 16 || dh > MAX_DH || p.I % 32 || (p.I / p.H) % 8 || p.I % p.H || p.Vs % 8 ||
      p.Vs * p.H < p.V)
    return (int)cudaErrorInvalidValue;
  // int8: fc2's K in whole k32 pairs, the int8 hidden slices in 16-byte pieces
  if (int8 && (p.I % 64 || (p.I / p.H) % 16)) return (int)cudaErrorInvalidValue;
  const int shapes[N_PLANS][2] = {{p.D, 3 * dh}, {p.D, dh}, {p.D, dh}, {p.D, dh},
                                  {p.D, p.I / p.H}, {p.I, dh}, {p.D, dh}, {p.D, p.Vs}};
  for (int k = 0; k < N_PLANS; ++k) {
    Plan& pl = p.plan[k];
    pl.k = shapes[k][0];
    pl.n = shapes[k][1];
    pl.kp = ints[12 + 2 * k];
    pl.t = ints[13 + 2 * k];
    if (pl.kp < 1 || WARPS % pl.kp || (pl.k / pair_k(int8, k)) % pl.kp || pl.t < 1 ||
        pl.t > MAX_T || (k == P_VOCAB && pl.kp != 1))
      return (int)cudaErrorInvalidValue;
  }
  p.scale = scale;
  p.eps = eps;
  p.tok_emb = (const bf16*)ptrs[0]; p.pos_emb = (const bf16*)ptrs[1];
  p.tok_type = (const bf16*)ptrs[2]; p.elns = (const float*)ptrs[3];
  p.elnb = (const float*)ptrs[4]; p.wt = (const uint4*)ptrs[5]; p.bt = (const float*)ptrs[6];
  p.hlns = (const float*)ptrs[7]; p.hlnb = (const float*)ptrs[8]; p.wp = (const uint4*)ptrs[9];
  p.bp = (const float*)ptrs[10]; p.cross_k = (const bf16*)ptrs[11];
  p.cross_v = (const bf16*)ptrs[12]; p.cache_k = (bf16*)ptrs[13]; p.cache_v = (bf16*)ptrs[14];
  p.stops = (const int*)ptrs[15];
  for (int l = 0; l < p.L; ++l) {
    void** q = ptrs + COMMON_PTRS + layer_ptrs * l;
    ClusterLayer& w = p.layers[l];
    w.wqkv = (const uint4*)q[0]; w.bqkv = (const float*)q[1];
    w.wo = (const uint4*)q[2]; w.bo = (const float*)q[3];
    w.slns = (const float*)q[4]; w.slnb = (const float*)q[5];
    w.wcq = (const uint4*)q[6]; w.bcq = (const float*)q[7];
    w.wco = (const uint4*)q[8]; w.bco = (const float*)q[9];
    w.clns = (const float*)q[10]; w.clnb = (const float*)q[11];
    w.w1 = (const uint4*)q[12]; w.b1 = (const float*)q[13];
    w.w2 = (const uint4*)q[14]; w.b2 = (const float*)q[15];
    w.mlns = (const float*)q[16]; w.mlnb = (const float*)q[17];
    if (int8)
      for (int k = 0; k < N_INT8_PLANS; ++k) p.scales[l][k] = (const float*)q[LAYER_PTRS + k];
  }
  p.prof = static_cast<long long*>(prof);
  // a profiled launch runs the instance with the stage marks
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (int8)
    return launch_cluster(prof ? decode_cluster_i8_kernel<true>
                               : decode_cluster_i8_kernel<false>,
                          p, tokens, lengths, clusters, st);
  ClusterParams& bf16_params = p;
  return launch_cluster(prof ? decode_cluster_kernel<true> : decode_cluster_kernel<false>,
                        bf16_params, tokens, lengths, clusters, st);
}

}  // extern "C"
