// Attention cores of the fused whole-layer decode step (kernels J and K).
//
// Replaces (Pallas, TPU):
//   J  manga_ocr_tpu/ops/decode_layer.py  fused_self_attn_step -> _self_attn_kernel:
//      LN(x + O(SelfAttn(x))) for one decode step, the new K/V row written
//      into the packed [T, B, D] cache at ``step``, keys t <= step;
//   K  manga_ocr_tpu/ops/decode_layer.py  fused_cross_attn_step -> _cross_attn_kernel:
//      LN(x + O(CrossAttn(x))) over packed [B, S, D] cross-K/V, int8 with
//      per-(b, s) K scales and per-(b, d) V scales, or bf16.
//
// The TPU kernels run one Pallas call per layer half with a batch group and
// every weight in VMEM.  Here each layer half is a short chain (ops/
// decode_layer.py): the q|k|v (J) or q (K) projection through the repo's
// GEMMs with an f32-out epilogue, one of the cores below, the out
// projection with the bf16 residual epilogue, and ln_rows_bf16 for the
// post-LN.
//
// Both cores: ``c`` CTAs per batch row (the largest of 8, 4, 2, 1 dividing
// H), each taking H / c heads in turn; under the int8 output the c CTAs
// are one thread-block cluster.  A head's q (and the row's scales) land by
// cp.async in one commit group; its keys then stream through a ring of
// shared-memory stages filled by cp.async (the largest of 16, 8, 4 bytes
// dividing the head's row bytes, or plain loads where none does; rows at a
// stride of an odd number of 16-byte pieces, so the 8 rows that a quarter
// warp reads at one column fall in distinct banks): all of K's chunks, then
// all of V's, so V's first chunks are in flight while the last scores and
// the softmax run.  Scores: 1, 2, 4 or 8 lanes a key (as many keys in one
// pass as the chunk has, up to 256), each lane a strided share of the
// row's vectors, two accumulators, a shuffle sum; int8 keys convert to f32
// exactly without I2F (the byte in the mantissa of 2^23 by a byte permute,
// one subtraction).  Softmax: the block max (of the maxima the score
// writers kept), expf(s - max), the block sum, an exact division (p stays
// f32).  Context: every thread owns a vector of channels and a slice of the
// keys, summed in registers over all of V's chunks; the slices meet by
// shuffles.
//
//   self_attn_step   rounds its heads' new k and v to bf16, writes them into
//                    cache row ``step`` and keeps them in shared memory, so
//                    key ``step`` is scored from the CTA's own fresh values
//                    and no CTA reads memory another writes; streams keys
//                    t < step through the ring (the whole cache at step
//                    303, 117 KB a head, would hold an SM to one CTA).
//                    Scores in f32 from the f32 q (not rounded, as in the
//                    JAX kernel) times the bf16 keys, times 1/sqrt(dh).
//   cross_attn_step  stages the head's K and V slices whole (two commit
//                    groups, V landing while the scores run) where they
//                    fit, else through the ring; scores (q . K) * k_scale *
//                    1/sqrt(dh), keys s >= s_valid weigh 0 (the -1e30 mask:
//                    they are not read), context (sum p V) * v_scale: the
//                    scales apply after the contractions, as in the JAX
//                    kernel.
//
// Output: the f32 or bf16 context, or, for an int8 out projection, the
// context row quantized inside the core (kernel_utils.quant_rows bit for
// bit: the row's max |x| over all D channels is reduced across the cluster
// through distributed shared memory, exact and order-free, then each CTA
// quantizes its own slice), which the int8 GEMM takes as it is.  The f32
// and bf16 outputs need no exchange, and launch without the cluster: on an
// H100 the cluster launch of the same grid took microseconds longer at
// B=32.
//
// Bound: bytes.  Per step a J core reads the live cache rows (t < step) of
// K and V once, a K core the int8 (or bf16) slabs once; the arithmetic is
// two multiply-adds per value.  The design keeps every CTA's next chunks in
// flight (J: two stages of 128 keys, 52 KB at dh = 96; K: its whole 43 KB
// head) while it computes on the chunk that landed, and keeps each phase
// to a few dependent steps: a chunk costs a wait and two barriers, so J
// ran faster in 128-key chunks in two stages than in 32-key chunks in four
// on an H100.  Not carried over: the TPU's 0/1 segment matrix (a Mosaic
// workaround for 96-lane head slices).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;
using namespace mocr;

namespace {

typedef __nv_bfloat16 bf16;

// kernels/launch.py attn_step_plan mirrors these and step_layout.
constexpr int kThreads = 256;       // 8 warps a CTA
constexpr int kStages = 2;          // the ring's stages
constexpr int kMaxCluster = 8;
constexpr int kSmemLimit = 232448;  // the per-block opt-in limit

enum OutMode { kOutF32 = 0, kOutBf16 = 1, kOutI8 = 2 };

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// A ring row's stride: the row rounded up to an odd number of 16 bytes.
__host__ __device__ inline int ring_stride(int row_bytes) {
  const int pieces = (row_bytes + 15) / 16;
  return 16 * (pieces | 1);
}

// Byte offsets of a CTA's dynamic shared memory: the ring of kStages x
// ``chunk`` key rows; q (J: q | k_new | v_new) in f32; the scores of
// ``n_p`` keys; K's int8 k_scale row (n_p floats) and v_scale slice (dh);
// the context sums of rows too wide for registers; the CTA's context slice
// (int8 output); reduction scratch and the cluster's row maxima.
struct StepLayout {
  int ring, q, p, ks, vs, part, cs, red, total;
};

__host__ __device__ inline StepLayout step_layout(int dh, int row_bytes, int chunk, int n_p,
                                                  bool scales, int hpc, bool self_attn) {
  StepLayout L;
  int o = 0;
  L.ring = o;
  o += align16(kStages * chunk * ring_stride(row_bytes));
  L.q = o;
  o += align16((self_attn ? 3 : 1) * dh * 4);
  L.p = o;
  o += align16(n_p * 4);
  L.ks = o;
  o += align16(scales ? n_p * 4 : 0);
  L.vs = o;
  o += align16(scales ? dh * 4 : 0);
  L.part = o;
  o += align16(dh * 4);
  L.cs = o;
  o += align16(hpc * dh * 4);
  L.red = o;
  o += (32 + kMaxCluster) * 4;
  L.total = o;
  return L;
}

struct CoreArgs {
  const float* q;       // J: qkv [B, 3D] (q | k | v); K: q [B, D]; f32
  const char* k;        // J: cache [T, B, D] bf16; K: [B, S, D] int8 or bf16
  const char* v;
  bf16* ck;             // J: the caches, row ``step`` written
  bf16* cv;
  const float* ks;      // K int8: [B, S]
  const float* vs;      // K int8: [B, D]
  void* out;            // [B, D] f32, bf16 or int8
  float* sx;            // int8 output: [B]
  int mode;             // OutMode
  int B, H, dh;
  int keys;             // J: step (keys t < step streamed); K: keys read
  int n_p;              // score slots: J T, K S
  int all_masked;       // K: s_valid < 1, every key masked
  int cluster, hpc, chunk;
  float scale;
};

template <int B> struct Raw;
template <> struct Raw<16> { typedef uint4 T; };
template <> struct Raw<8> { typedef uint2 T; };
template <> struct Raw<4> { typedef uint32_t T; };
template <> struct Raw<2> { typedef uint16_t T; };
template <> struct Raw<1> { typedef uint8_t T; };

// Four int8 values of a word -> f32, exactly and without I2F: each byte,
// sign bit flipped (b + 128), becomes the low mantissa byte of 2^23, and
// 2^23 + 128 is subtracted.
__device__ __forceinline__ void i8x4_f32(uint32_t w, float* f) {
  const uint32_t x = w ^ 0x80808080u;
  f[0] = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440)), 8388736.0f);
  f[1] = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7441)), 8388736.0f);
  f[2] = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7442)), 8388736.0f);
  f[3] = __fsub_rn(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7443)), 8388736.0f);
}

// U values of type KV at ``p`` (shared memory, U * sizeof(KV)-aligned) -> f32.
template <typename KV, int U>
__device__ __forceinline__ void load_unit(const char* p, float (&f)[U]) {
  constexpr int NB = U * (int)sizeof(KV);
  const typename Raw<NB>::T raw = *reinterpret_cast<const typename Raw<NB>::T*>(p);
  if constexpr (NB >= 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < NB / 4; ++i) {
      if constexpr (sizeof(KV) == 2) {
        f[2 * i] = __uint_as_float(w[i] << 16);
        f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        i8x4_f32(w[i], f + 4 * i);
      }
    }
  } else if constexpr (sizeof(KV) == 2) {
    f[0] = __uint_as_float((uint32_t)raw << 16);
  } else {
    f[0] = __fsub_rn(__uint_as_float(0x4B000000u | ((uint32_t)raw ^ 0x80u)), 8388736.0f);
  }
}

// U f32 values at ``p`` (shared memory, 16-byte aligned where U % 4 == 0).
template <int U>
__device__ __forceinline__ void load_f32(const float* p, float (&f)[U]) {
  if constexpr (U % 4 == 0) {
#pragma unroll
    for (int i = 0; i < U; i += 4)
      *reinterpret_cast<float4*>(f + i) = *reinterpret_cast<const float4*>(p + i);
  } else {
#pragma unroll
    for (int i = 0; i < U; ++i) f[i] = p[i];
  }
}

// ``n`` f32 values global -> shared by 4-byte cp.async (the caller commits).
__device__ __forceinline__ void copy_f32(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) cp_async<4>(dst + i, src + i);
}

// ``n`` key rows of ``row_bytes`` at ``src`` (``stride`` bytes apart) into
// rows ``rs`` bytes apart at ``dst``: cp.async of W bytes, or plain loads
// of E bytes (W = 0).  Thread t takes pieces t, t + kThreads, ... in row
// order.
template <int W, int E>
__device__ __forceinline__ void copy_rows(char* dst, int rs, const char* src, long long stride,
                                          int n, int row_bytes) {
  constexpr int C = W ? W : E;
  const int per_row = row_bytes / C;
  const int dr = kThreads / per_row, du = kThreads - dr * per_row;  // a step of kThreads pieces
  int r = threadIdx.x / per_row, u = threadIdx.x - r * per_row;
  while (r < n) {
    char* d = dst + r * rs + u * C;
    const char* g = src + r * stride + u * C;
    if constexpr (W != 0)
      cp_async<W>(d, g);
    else
      *reinterpret_cast<typename Raw<E>::T*>(d) = *reinterpret_cast<const typename Raw<E>::T*>(g);
    r += dr;
    u += du;
    if (u >= per_row) {
      u -= per_row;
      ++r;
    }
  }
}

// A head's K and V key rows as a sequence of tiles through the ring: tiles
// 0 .. nc-1 are K's chunks, nc .. 2nc-1 V's.
struct Stream {
  const char* k;
  const char* v;
  long long stride;  // bytes from one key row to the next
  int n, chunk, nc, row_bytes, rs;
  char* ring;
  __device__ char* tile(int i) const { return ring + (long long)(i % kStages) * chunk * rs; }
};

// Tile ``i`` into its ring slot (nothing past the last), then one commit:
// every call commits a group, so a wait counts tiles.
template <int W, int E>
__device__ __forceinline__ void issue_tile(const Stream& s, int i) {
  if (i < 2 * s.nc) {
    const bool is_v = i >= s.nc;
    const int k0 = (is_v ? i - s.nc : i) * s.chunk;
    copy_rows<W, E>(s.tile(i), s.rs, (is_v ? s.v : s.k) + k0 * s.stride, s.stride,
                    min(s.chunk, s.n - k0), s.row_bytes);
  }
  cp_async_commit();
}

// Lanes a key in the score pass: as many keys in one pass as the tile has
// (up to 256), at most 8 lanes.
__device__ __forceinline__ int score_lanes(int n) {
  return n > kThreads / 2 ? 1 : n > kThreads / 4 ? 2 : n > kThreads / 8 ? 4 : 8;
}

// Scores of keys k0 .. k0+n-1 (a K tile) into p; returns the largest score
// this thread wrote (-inf if none).  G lanes a key, lane g taking the row's
// vectors g, g + G, ...
template <typename KV, int U>
__device__ __forceinline__ float score_tile(const char* tile, int rs, int n, int k0, int nu,
                                            const float* q, float* p, const float* ks,
                                            float scale, bool masked) {
  constexpr int VB = U * (int)sizeof(KV);
  const int G = score_lanes(n), g = threadIdx.x & (G - 1);
  float mx = -INFINITY;
  for (int r0 = 0; r0 < n; r0 += kThreads / G) {
    const int r = r0 + threadIdx.x / G;
    float acc[2] = {0.0f, 0.0f};
    if (r < n) {
      const char* row = tile + r * rs;
      for (int u = g; u < nu; u += G) {
        float f[U], qf[U];
        load_unit<KV, U>(row + u * VB, f);
        load_f32<U>(q + u * U, qf);
#pragma unroll
        for (int e = 0; e < U; ++e) acc[e & 1] = fmaf(qf[e], f[e], acc[e & 1]);
      }
    }
    float sc = acc[0] + acc[1];
    for (int o = G / 2; o > 0; o >>= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
    if (r < n && g == 0) {
      if (ks != nullptr) sc = __fmul_rn(sc, ks[k0 + r]);
      sc = masked ? kNegInf : __fmul_rn(sc, scale);
      p[k0 + r] = sc;
      mx = fmaxf(mx, sc);
    }
  }
  return mx;
}

// The context pass, sum over keys of p[key] * V[key].  Rows of at most
// kThreads vectors: thread t owns vector u = t / nsl and key slice sl =
// t % nsl (nsl the largest power of two up to 32 with nu * nsl <=
// kThreads), sums its keys of every V tile in registers, and the slices
// meet by shuffles at the end.  Wider rows: thread t owns vectors t,
// t + kThreads, ..., summed tile by tile into ``part`` (dh floats).
template <typename KV, int U>
struct Context {
  static constexpr int VB = U * (int)sizeof(KV);
  float acc[U];
  int nu, u, sl, nsl;
  float* part;

  __device__ __forceinline__ void init(int nu_, float* part_) {
    nu = nu_;
    part = part_;
    nsl = 32;
    while (nsl > 1 && nu * nsl > kThreads) nsl >>= 1;
    u = threadIdx.x / nsl;
    sl = threadIdx.x % nsl;
#pragma unroll
    for (int e = 0; e < U; ++e) acc[e] = 0.0f;
    if (nu > kThreads)
      for (int v = threadIdx.x; v < nu; v += kThreads)
#pragma unroll
        for (int e = 0; e < U; ++e) part[v * U + e] = 0.0f;
  }

  // V's tile of keys k0 .. k0+n-1.
  __device__ __forceinline__ void tile(const char* t, int rs, int n, int k0, const float* p) {
    if (nu <= kThreads) {
      if (u < nu)
        for (int r = sl; r < n; r += nsl) {
          float f[U];
          load_unit<KV, U>(t + r * rs + u * VB, f);
          const float pr = p[k0 + r];
#pragma unroll
          for (int e = 0; e < U; ++e) acc[e] = fmaf(pr, f[e], acc[e]);
        }
      return;
    }
    for (int v = threadIdx.x; v < nu; v += kThreads) {
      float a[U];
#pragma unroll
      for (int e = 0; e < U; ++e) a[e] = 0.0f;
      for (int r = 0; r < n; ++r) {
        float f[U];
        load_unit<KV, U>(t + r * rs + v * VB, f);
        const float pr = p[k0 + r];
#pragma unroll
        for (int e = 0; e < U; ++e) a[e] = fmaf(pr, f[e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < U; ++e) part[v * U + e] += a[e];
    }
  }

  // ``emit(d, sum)`` for every channel d of the head, once (every thread
  // calls: the shuffles).
  template <typename Emit>
  __device__ __forceinline__ void finish(Emit emit) {
    if (nu <= kThreads) {
#pragma unroll
      for (int e = 0; e < U; ++e)
        for (int o = nsl / 2; o > 0; o >>= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      if (sl == 0 && u < nu)
#pragma unroll
        for (int e = 0; e < U; ++e) emit(u * U + e, acc[e]);
      return;
    }
    for (int v = threadIdx.x; v < nu; v += kThreads)
#pragma unroll
      for (int e = 0; e < U; ++e) emit(v * U + e, part[v * U + e]);
  }
};

// p[0..n) holds the scores on entry and the softmax (exp(s - max) / sum,
// an exact division) on exit; ``mx`` is the largest score this thread
// wrote.  Called by the whole block.
__device__ __forceinline__ void block_softmax(float* p, int n, float mx, float* red) {
  const float m = block_max(mx, red);
  float sum = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float e = expf(p[i] - m);
    p[i] = e;
    sum += e;
  }
  sum = block_sum(sum, red);
  for (int i = threadIdx.x; i < n; i += kThreads) p[i] = __fdiv_rn(p[i], sum);
  __syncthreads();
}

// One head's stream, after the caller has committed the head's prologue
// group (q and the like): ``ready`` once that group has landed, K's tiles
// scored into p, ``fresh`` (J's own key, between the score tiles and the
// softmax; returns its score, or -inf), the softmax over ``n_soft`` scores,
// V's tiles summed by ``ctx``.
template <typename KV, int W, typename Ctx, typename Ready, typename Fresh>
__device__ __forceinline__ void run_head(const Stream& s, int nu, const float* q, float* p,
                                         const float* ks, float scale, bool masked, Ctx& ctx,
                                         int n_soft, float* red, Ready ready, Fresh fresh) {
  constexpr int E = sizeof(KV), U = W ? W / E : 1;
  for (int i = 0; i < kStages; ++i) issue_tile<W, E>(s, i);
  float mx = -INFINITY;
  if (s.nc == 0) {
    cp_async_wait<0>();
    __syncthreads();
    ready();
    __syncthreads();
    block_softmax(p, n_soft, fmaxf(mx, fresh()), red);
    return;
  }
  for (int i = 0; i < 2 * s.nc; ++i) {
    cp_async_wait<kStages - 1>();  // the prologue and tile i have landed
    __syncthreads();
    if (i == 0) {
      ready();
      __syncthreads();
    }
    const int k0 = (i < s.nc ? i : i - s.nc) * s.chunk, n = min(s.chunk, s.n - k0);
    if (i < s.nc)
      mx = fmaxf(mx, score_tile<KV, U>(s.tile(i), s.rs, n, k0, nu, q, p, ks, scale, masked));
    else
      ctx.tile(s.tile(i), s.rs, n, k0, p);
    __syncthreads();  // every thread is done with tile i's slot
    issue_tile<W, E>(s, i + kStages);
    if (i == s.nc - 1) {
      mx = fmaxf(mx, fresh());
      __syncthreads();
      block_softmax(p, n_soft, mx, red);
    }
  }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The head's context channel to the output, or (int8) into the CTA's
// slice cs for quantize_row.
__device__ __forceinline__ void emit(const CoreArgs& a, long long at, float* cs, int ci,
                                     float v) {
  if (a.mode == kOutF32)
    static_cast<float*>(a.out)[at] = v;
  else if (a.mode == kOutBf16)
    static_cast<bf16*>(a.out)[at] = __float2bfloat16_rn(v);
  else
    cs[ci] = v;
}

// The int8 output: the row's max |x| over the cluster's slices (each CTA
// pushes its slice max into every peer's ``slots``; the cluster barrier
// orders the stores), then this CTA's slice quantized with it.  The peers
// had all started (the caller's cluster_wait), and nobody reads a peer's
// shared memory after the barrier, so a CTA may then leave.
__device__ __forceinline__ void quantize_row(const CoreArgs& a, int b, int rank, const float* cs,
                                             float* red, float* slots) {
  const int n = a.hpc * a.dh;
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) m = fmaxf(m, fabsf(cs[i]));
  m = block_max(m, red);
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x < a.cluster) *cl.map_shared_rank(slots + rank, threadIdx.x) = m;
  cl.sync();
  float mx = 0.0f;
  for (int r = 0; r < a.cluster; ++r) mx = fmaxf(mx, slots[r]);
  const float amax = quant_amax(mx), inv = quant_inv(amax);
  int8_t* q = static_cast<int8_t*>(a.out) + (long long)b * a.H * a.dh + (long long)rank * n;
  for (int i = threadIdx.x; i < n; i += kThreads) q[i] = quant_i8(cs[i], inv);
  if (rank == 0 && threadIdx.x == 0) a.sx[b] = quant_sx(amax);
}

// The ring's stream of a.keys keys (the caller sets each head's k and v).
__device__ __forceinline__ Stream make_stream(const CoreArgs& a, char* ring, long long stride,
                                              int row_bytes) {
  Stream s;
  s.stride = stride;
  s.n = a.keys;
  s.chunk = a.chunk;
  s.nc = (a.keys + a.chunk - 1) / a.chunk;
  s.row_bytes = row_bytes;
  s.rs = ring_stride(row_bytes);
  s.ring = ring;
  return s;
}

// Kernel J's core.  Grid: B groups of ``cluster`` CTAs (one cluster under
// the int8 output); CTA ``rank`` of row b takes heads rank * hpc ..
// (rank + 1) * hpc - 1.
template <int W>
__global__ void __launch_bounds__(kThreads) self_attn_core(const CoreArgs a) {
  constexpr int E = 2, U = W ? W / E : 1;
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x / a.cluster, rank = blockIdx.x % a.cluster;
  const int dh = a.dh, D = a.H * dh, step = a.keys, row_bytes = dh * E, nu = dh / U;
  const StepLayout L = step_layout(dh, row_bytes, a.chunk, a.n_p, false, a.hpc, true);
  float* q = reinterpret_cast<float*>(smem + L.q);
  float* kn = q + dh;
  float* vn = kn + dh;
  float* p = reinterpret_cast<float*>(smem + L.p);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  if (a.mode == kOutI8) cluster_arrive_relaxed();
  Stream s = make_stream(a, smem + L.ring, (long long)a.B * D * E, row_bytes);
  for (int hl = 0; hl < a.hpc; ++hl) {
    const int h = rank * a.hpc + hl;
    const long long col = (long long)b * D + h * dh;  // the head's columns in a [B, D] row
    const float* row = a.q + (long long)b * 3 * D + h * dh;
    for (int j = 0; j < 3; ++j) copy_f32(q + j * dh, row + j * D, dh);  // q | k | v
    cp_async_commit();
    s.k = a.k + col * E;
    s.v = a.v + col * E;
    Context<bf16, U> ctx;
    ctx.init(nu, reinterpret_cast<float*>(smem + L.part));
    const long long at = (long long)step * a.B * D + col;
    run_head<bf16, W>(
        s, nu, q, p, nullptr, a.scale, false, ctx, step + 1, red,
        [&] {  // the new row, rounded to bf16, into the cache and kept
          for (int d = threadIdx.x; d < dh; d += kThreads) {
            const bf16 kb = __float2bfloat16_rn(kn[d]), vb = __float2bfloat16_rn(vn[d]);
            kn[d] = __bfloat162float(kb);
            vn[d] = __bfloat162float(vb);
            a.ck[at + d] = kb;
            a.cv[at + d] = vb;
          }
        },
        [&] {  // key ``step`` from the fresh row
          float acc = -INFINITY;
          if (threadIdx.x < 32) {
            acc = 0.0f;
            for (int d = threadIdx.x; d < dh; d += 32) acc = fmaf(q[d], kn[d], acc);
            acc = __fmul_rn(warp_sum(acc), a.scale);
            if (threadIdx.x == 0) p[step] = acc;
          }
          return acc;
        });
    ctx.finish([&](int d, float v) {
      emit(a, col + d, cs, hl * dh + d, fmaf(p[step], vn[d], v));
    });
    __syncthreads();  // q, p and the ring are free for the next head
  }
  if (a.mode == kOutI8) {
    cluster_wait();
    quantize_row(a, b, rank, cs, red, red + 32);
  }
}

// Kernel K's core; KV int8 (with k_scale and v_scale) or bf16.
template <typename KV, int W>
__global__ void __launch_bounds__(kThreads) cross_attn_core(const CoreArgs a) {
  constexpr int E = sizeof(KV), U = W ? W / E : 1;
  constexpr bool kI8 = E == 1;
  extern __shared__ __align__(16) char smem[];
  const int b = blockIdx.x / a.cluster, rank = blockIdx.x % a.cluster;
  const int dh = a.dh, D = a.H * dh, S = a.n_p, row_bytes = dh * E, nu = dh / U;
  const StepLayout L = step_layout(dh, row_bytes, a.chunk, a.n_p, kI8, a.hpc, false);
  float* q = reinterpret_cast<float*>(smem + L.q);
  float* p = reinterpret_cast<float*>(smem + L.p);
  float* ks = kI8 ? reinterpret_cast<float*>(smem + L.ks) : nullptr;
  float* vs = reinterpret_cast<float*>(smem + L.vs);
  float* cs = reinterpret_cast<float*>(smem + L.cs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  if (a.mode == kOutI8) cluster_arrive_relaxed();
  if constexpr (kI8) copy_f32(ks, a.ks + (long long)b * S, a.keys);  // with the first prologue
  Stream s = make_stream(a, smem + L.ring, (long long)D * E, row_bytes);
  for (int hl = 0; hl < a.hpc; ++hl) {
    const int h = rank * a.hpc + hl;
    const long long col = (long long)b * D + h * dh;
    copy_f32(q, a.q + col, dh);
    if constexpr (kI8) copy_f32(vs, a.vs + col, dh);
    cp_async_commit();
    const long long base = ((long long)b * S * D + h * dh) * E;  // key 0 of the head
    s.k = a.k + base;
    s.v = a.v + base;
    Context<KV, U> ctx;
    ctx.init(nu, reinterpret_cast<float*>(smem + L.part));
    run_head<KV, W>(s, nu, q, p, ks, a.scale, a.all_masked != 0, ctx, a.keys, red, [] {},
                    [] { return -INFINITY; });
    ctx.finish([&](int d, float v) {
      if constexpr (kI8) v = __fmul_rn(v, vs[d]);
      emit(a, col + d, cs, hl * dh + d, v);
    });
    __syncthreads();
  }
  if (a.mode == kOutI8) {
    cluster_wait();
    quantize_row(a, b, rank, cs, red, red + 32);
  }
}

// Checks the plan the caller passes against the kernel's own layout, then
// launches ``kernel`` on B groups of ``cluster`` CTAs (a cluster under the
// int8 output); returns a cudaError_t.
int launch_core(void (*kernel)(CoreArgs), const CoreArgs& a, int width, int elt, int smem,
                bool self_attn, cudaStream_t st) {
  const int row_bytes = a.dh * elt;
  if (a.B < 1 || a.H < 1 || a.dh < 1 || a.cluster < 1 || a.cluster > kMaxCluster ||
      (a.cluster & (a.cluster - 1)) || a.H % a.cluster || a.hpc * a.cluster != a.H ||
      a.chunk < 1 || a.mode < kOutF32 || a.mode > kOutI8 ||
      (a.mode == kOutI8 && a.sx == nullptr) ||
      (width != 0 && width != 4 && width != 8 && width != 16) || (width && row_bytes % width))
    return (int)cudaErrorInvalidValue;
  const StepLayout L =
      step_layout(a.dh, row_bytes, a.chunk, a.n_p, !self_attn && elt == 1, a.hpc, self_attn);
  if (smem < L.total || smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = a.mode == kOutI8 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The core of each copy width (0: plain loads).
void (*self_core(int width))(CoreArgs) {
  switch (width) {
    case 16: return self_attn_core<16>;
    case 8: return self_attn_core<8>;
    case 4: return self_attn_core<4>;
    default: return self_attn_core<0>;
  }
}

template <typename KV>
void (*cross_core(int width))(CoreArgs) {
  switch (width) {
    case 16: return cross_attn_core<KV, 16>;
    case 8: return cross_attn_core<KV, 8>;
    case 4: return cross_attn_core<KV, 4>;
    default: return cross_attn_core<KV, 0>;
  }
}

}  // namespace

extern "C" {

// The plan (cluster, width, chunk, smem) comes from
// kernels/launch.py attn_step_plan; mode: 0 f32, 1 bf16, 2 int8 context
// (out int8 [B, D], sx [B]).
int mocr_self_attn_step(const void* qkv, void* cache_k, void* cache_v, void* out, void* sx,
                        int mode, int B, int T, int H, int dh, int step, float scale,
                        int cluster, int width, int chunk, int smem, void* stream) {
  if (step < 0 || step >= T || H < 1 || cluster < 1) return (int)cudaErrorInvalidValue;
  CoreArgs a = {};
  a.q = static_cast<const float*>(qkv);
  a.k = static_cast<const char*>(cache_k);
  a.v = static_cast<const char*>(cache_v);
  a.ck = static_cast<bf16*>(cache_k);
  a.cv = static_cast<bf16*>(cache_v);
  a.out = out;
  a.sx = static_cast<float*>(sx);
  a.mode = mode;
  a.B = B;
  a.H = H;
  a.dh = dh;
  a.keys = step;
  a.n_p = T;
  a.cluster = cluster;
  a.hpc = H / cluster;
  a.chunk = chunk;
  a.scale = scale;
  return launch_core(self_core(width), a, width, 2, smem, true,
                     static_cast<cudaStream_t>(stream));
}

int mocr_cross_attn_step(const void* q, const void* k, const void* v, const void* k_scale,
                         const void* v_scale, int kv_int8, void* out, void* sx, int mode, int B,
                         int S, int H, int dh, int s_valid, float scale, int cluster, int width,
                         int chunk, int smem, void* stream) {
  if (S < 1 || H < 1 || cluster < 1 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  CoreArgs a = {};
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const char*>(k);
  a.v = static_cast<const char*>(v);
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.out = out;
  a.sx = static_cast<float*>(sx);
  a.mode = mode;
  a.B = B;
  a.H = H;
  a.dh = dh;
  // keys s >= s_valid weigh exactly 0 and are not read; with none valid,
  // every key is masked alike and the softmax is uniform over all S
  a.all_masked = s_valid < 1;
  a.keys = s_valid >= 1 && s_valid < S ? s_valid : S;
  a.n_p = S;
  a.cluster = cluster;
  a.hpc = H / cluster;
  a.chunk = chunk;
  a.scale = scale;
  return launch_core(kv_int8 ? cross_core<int8_t>(width) : cross_core<bf16>(width), a, width,
                     kv_int8 ? 1 : 2, smem, false, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
