// Fused greedy LM head (kernel F): ids[b] = first argmax_n of
// (bf16(LN(gelu_erf(x[b] . Wt + bt))) . Wp[:, n] + bp[n]).
//
// Replaces (Pallas, TPU): manga_ocr_tpu/ops/fused_head.py fused_greedy_head
// -> _head_kernel, which keeps the [B, 6144] logits in VMEM and tracks a
// running (max, argmax) over 512-wide vocab tiles.
//
// Here the head's device code is kernel C's (rows.cuh: head_hidden, then
// gemv_argmax), so the two heads round at the same places.  One launch
// covers a grid of (row blocks, vocab splits): each block recomputes the
// transform for its R rows (768 x 768, small beside the vocab product) and
// takes the first maximum over its contiguous range of whole 512-column
// tiles, writing (value, index) partials; a second tiny kernel keeps, per
// row, the first split whose value is strictly larger, so the first
// maximum wins across splits as it does across the TPU kernel's tiles.
//
// Bound on the H100: per-row multiply-adds on the CUDA cores (every row
// streams the head weights, ~10.6 MB bf16, from L2).  The vocab split only
// raises the number of blocks so that small batches fill the SMs.
// Tensor-core products over a block's rows are the next step, as for C.
#include "rows.cuh"

using namespace mocr;

namespace {

typedef __nv_bfloat16 bf16;

template <int R>
__global__ void __launch_bounds__(ROW_THREADS)
fused_head_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                  const float* __restrict__ bt, const float* __restrict__ lns,
                  const float* __restrict__ lnb, const bf16* __restrict__ wp,
                  const float* __restrict__ bp, int B, int D, int V, int cols_per_split,
                  float eps, float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[32];
  __shared__ float red_v[R * ROW_WARPS];
  __shared__ int red_i[R * ROW_WARPS];
  __shared__ int best[R];
  __shared__ float best_v[R];
  float* xs = sm;            // [R][D]
  float* big = xs + R * D;   // [R][D]
  float* hbuf = big + R * D; // [R][D]
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  const int split = blockIdx.y, n_split = gridDim.y;
  const int col0 = split * cols_per_split;
  const int ncols = min(cols_per_split, V - col0);

  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D;
    xs[idx] = r < nrows ? __bfloat162float(x[(long)(row0 + r) * D + idx % D]) : 0.0f;
    hbuf[idx] = 0.0f;
  }
  __syncthreads();
  head_hidden<R>(xs, D, nrows, wt, bt, lns, lnb, D, eps, big, D, hbuf, D, red);
  gemv_argmax<R>(hbuf, D, wp, V, bp, D, col0, ncols, best, best_v, red_v, red_i);
  if (threadIdx.x < nrows) {
    const long o = (long)(row0 + threadIdx.x) * n_split + split;
    part_v[o] = best_v[threadIdx.x];
    part_i[o] = best[threadIdx.x];
  }
}

// One thread per row: splits in increasing column order, strict >.
__global__ void head_reduce_kernel(const float* __restrict__ part_v, const int* __restrict__ part_i,
                                   int B, int n_split, int* __restrict__ ids) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float v = part_v[(long)b * n_split];
  int i = part_i[(long)b * n_split];
  for (int s = 1; s < n_split; ++s) {
    const float ov = part_v[(long)b * n_split + s];
    if (ov > v) { v = ov; i = part_i[(long)b * n_split + s]; }
  }
  ids[b] = i;
}

template <int R>
int launch(const bf16* x, const bf16* wt, const float* bt, const float* lns, const float* lnb,
           const bf16* wp, const float* bp, int B, int D, int V, int n_split, float eps,
           float* part_v, int* part_i, int* ids, cudaStream_t st) {
  const size_t smem = (size_t)3 * R * D * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_head_kernel<R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cols_per_split = V / n_split;
  dim3 grid((B + R - 1) / R, n_split);
  fused_head_kernel<R><<<grid, ROW_THREADS, smem, st>>>(x, wt, bt, lns, lnb, wp, bp, B, D, V,
                                                        cols_per_split, eps, part_v, part_i);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  head_reduce_kernel<<<(B + 127) / 128, 128, 0, st>>>(part_v, part_i, B, n_split, ids);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [B, D] bf16; wt [D, D] bf16; bt, lns, lnb [D] f32; wp [D, V] bf16;
// bp [V] f32; part_v/part_i [B, n_split] scratch; ids [B] int32.  V is a
// multiple of 2 * n_split; rows_per_block is 1, 2, 4 or 8.
int mocr_fused_head(const void* x, const void* wt, const void* bt, const void* lns,
                    const void* lnb, const void* wp, const void* bp, int B, int D, int V,
                    int n_split, int rows_per_block, float eps, void* part_v, void* part_i,
                    void* ids, void* stream) {
  if (n_split < 1 || V % (2 * n_split) || D % 2) return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wtb = static_cast<const bf16*>(wt);
  const bf16* wpb = static_cast<const bf16*>(wp);
  const float* btf = static_cast<const float*>(bt);
  const float* lnsf = static_cast<const float*>(lns);
  const float* lnbf = static_cast<const float*>(lnb);
  const float* bpf = static_cast<const float*>(bp);
  float* pv = static_cast<float*>(part_v);
  int* pi = static_cast<int*>(part_i);
  int* out = static_cast<int*>(ids);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_per_block) {
    case 1: return launch<1>(xb, wtb, btf, lnsf, lnbf, wpb, bpf, B, D, V, n_split, eps, pv, pi, out, st);
    case 2: return launch<2>(xb, wtb, btf, lnsf, lnbf, wpb, bpf, B, D, V, n_split, eps, pv, pi, out, st);
    case 4: return launch<4>(xb, wtb, btf, lnsf, lnbf, wpb, bpf, B, D, V, n_split, eps, pv, pi, out, st);
    case 8: return launch<8>(xb, wtb, btf, lnsf, lnbf, wpb, bpf, B, D, V, n_split, eps, pv, pi, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
