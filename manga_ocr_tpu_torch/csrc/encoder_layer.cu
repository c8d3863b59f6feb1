// Whole pre-LN ViT blocks: kernels H (one layer per call) and I (a slab of
// layers per call), with every launch of a block issued from here, on the
// caller's stream, with no Python between the attention half and the MLP
// half or between layers.
//
// Replaces (Pallas, TPU):
//   H  manga_ocr_tpu/ops/flash_attention.py  fused_encoder_layer ->
//      _enc_layer_kernel: x += Attn(LN1(x)); x += MLP(LN2(x)) for one layer,
//      int8 W8A8 or bf16 weights, the attention half _attn_core's
//      (softmax as a reciprocal multiply);
//   I  manga_ocr_tpu/ops/encoder_stack.py  encoder_stack -> _stack_call ->
//      _stack_kernel -> _one_layer: ``lpc`` such blocks per call over
//      stacked [L, ...] weight slabs, the softmax a division, no key mask.
//
// The TPU kernels keep a batch block's residual stream in VMEM across the
// attention and MLP halves (H) and across ``lpc`` layers (I), with every
// weight resident.  Here a block is the chain of the repository's kernels
// (csrc/encoder.cu, csrc/gemm_int8.cu, csrc/mlp_bf16.cu):
//   int8:  ln_quant_rows(LN1) -> int8 GEMM q|k|v (bf16 out) -> attention
//          (f32 context) -> ln_quant_rows -> int8 GEMM o (+ x, bf16) ->
//          ln_quant_rows(LN2) -> int8 GEMM fc1 (GELU, f32) ->
//          ln_quant_rows -> int8 GEMM fc2 (+ x2, bf16);
//   bf16:  ln_rows_bf16(LN1) -> bf16 GEMM q|k|v (bias, bf16) -> attention
//          (bf16 context) -> bf16 GEMM o (+ x) -> ln_rows_bf16(LN2) ->
//          bf16 GEMM fc1 (GELU, bf16) -> bf16 GEMM fc2 (+ x2);
// so the residual stream crosses device memory twice per layer, as in A
// followed by B or D.  Bound: the GEMMs' operations at B=256.  A single
// launch per layer (a thread-block cluster keeping a row block's residual
// in distributed shared memory, or o and fc2 GEMMs with a full 768-column
// tile and an epilogue of residual + LN + row quantization) is later work.
#include "common.cuh"
#include "entry.cuh"

using namespace mocr;

namespace {

// A projection: weight (int8 [N, K], the int8 GEMM's layout, or bf16
// [K, N]), per-column int8 scales (null for bf16), f32 bias.
struct Dense {
  const void* w;
  const void* scale;
  const void* bias;
};

struct Layer {
  Dense qkv, o;
  const void *ln1_s, *ln1_b;
  Dense fc1, fc2;
  const void *ln2_s, *ln2_b;
};

// Weight slots of the pointer array, in the order of
// ops/encoder_weights.py ``flat_weights``.
enum Slot {
  kQkvW, kQkvS, kQkvB, kOW, kOS, kOB, kLn1S, kLn1B,
  kFc1W, kFc1S, kFc1B, kFc2W, kFc2S, kFc2B, kLn2S, kLn2B, kSlots
};

// Layer ``j`` of a slab whose first layer's pointers are ``w``: every
// array is a contiguous stack [L, ...], so layer j sits j per-layer sizes
// further on.
Layer layer_at(const void* const* w, int j, bool int8, int D, int I) {
  const long long es = int8 ? 1 : 2, f = 4;
  auto at = [&](int slot, long long bytes) -> const void* {
    return w[slot] ? static_cast<const char*>(w[slot]) + j * bytes : nullptr;
  };
  Layer L;
  L.qkv = {at(kQkvW, 3LL * D * D * es), at(kQkvS, 3LL * D * f), at(kQkvB, 3LL * D * f)};
  L.o = {at(kOW, 1LL * D * D * es), at(kOS, D * f), at(kOB, D * f)};
  L.ln1_s = at(kLn1S, D * f);
  L.ln1_b = at(kLn1B, D * f);
  L.fc1 = {at(kFc1W, 1LL * D * I * es), at(kFc1S, I * f), at(kFc1B, I * f)};
  L.fc2 = {at(kFc2W, 1LL * I * D * es), at(kFc2S, D * f), at(kFc2B, D * f)};
  L.ln2_s = at(kLn2S, D * f);
  L.ln2_b = at(kLn2B, D * f);
  return L;
}

// Scratch of one block at M rows, allocated once by the caller and reused
// by every layer:
//   rows    int8 [M, I] (row-quantized activations) | bf16 [M, D] (LN out)
//   row_sx  f32 [M] (int8 row scales; null for bf16)
//   qkv     bf16 [M, 3D]
//   ctx     f32 [M, D] (int8) | bf16 [M, D]
//   x2      bf16 [M, D] (the residual stream between the halves)
//   hidden  f32 [M, I] (GELU out, int8) | bf16 [M, I]
enum ScratchSlot { kRows, kRowSx, kQkv, kCtx, kX2, kHidden, kScratch };

#define TRY(call)                 \
  do {                            \
    const int err_ = (call);      \
    if (err_ != 0) return err_;   \
  } while (0)

int run_layer(const Layer& L, void* const* s, const void* x, void* out, bool int8, bool sigmoid,
              bool divide, int B, int S, int D, int H, int I, float eps, float scale,
              void* st) {
  const int M = B * S, dh = D / H;
  const char* qkv = static_cast<const char*>(s[kQkv]);
  // q, k, v: rows of the [M, 3D] GEMM output; context rows [M, D]
  const long long in_b = 3LL * S * D, in_s = 3LL * D, out_b = 1LL * S * D;
  const int ctx_bf16 = int8 ? 0 : 1;
  if (int8) {
    TRY(mocr_ln_quant_rows(x, 1, L.ln1_s, L.ln1_b, 1, eps, s[kRows], s[kRowSx], M, D, st));
    TRY(mocr_int8_gemm(s[kRows], L.qkv.w, s[kRowSx], L.qkv.scale, L.qkv.bias, nullptr, s[kQkv],
                       M, 3 * D, D, kI8Bf16, st));
  } else {
    TRY(mocr_ln_rows_bf16(x, L.ln1_s, L.ln1_b, eps, s[kRows], M, D, st));
    TRY(mocr_bf16_gemm(s[kRows], L.qkv.w, L.qkv.bias, nullptr, s[kQkv], M, 3 * D, D, kBfBias,
                       st));
  }
  TRY(mocr_attention(qkv, qkv + 2LL * D, qkv + 4LL * D, in_b, dh, in_s, s[kCtx], out_b, dh, D,
                     ctx_bf16, divide ? 1 : 0, B, S, H, dh, S, scale, st));
  if (int8) {
    TRY(mocr_ln_quant_rows(s[kCtx], 0, nullptr, nullptr, 0, eps, s[kRows], s[kRowSx], M, D, st));
    TRY(mocr_int8_gemm(s[kRows], L.o.w, s[kRowSx], L.o.scale, L.o.bias, x, s[kX2], M, D, D,
                       kI8ResidualBf16, st));
    TRY(mocr_ln_quant_rows(s[kX2], 1, L.ln2_s, L.ln2_b, 1, eps, s[kRows], s[kRowSx], M, D, st));
    TRY(mocr_int8_gemm(s[kRows], L.fc1.w, s[kRowSx], L.fc1.scale, L.fc1.bias, nullptr,
                       s[kHidden], M, I, D, sigmoid ? kI8GeluSigmoidF32 : kI8GeluErfF32, st));
    TRY(mocr_ln_quant_rows(s[kHidden], 0, nullptr, nullptr, 0, eps, s[kRows], s[kRowSx], M, I,
                           st));
    TRY(mocr_int8_gemm(s[kRows], L.fc2.w, s[kRowSx], L.fc2.scale, L.fc2.bias, s[kX2], out, M, D,
                       I, kI8ResidualBf16, st));
  } else {
    TRY(mocr_bf16_gemm(s[kCtx], L.o.w, L.o.bias, x, s[kX2], M, D, D, kBfResidual, st));
    TRY(mocr_ln_rows_bf16(s[kX2], L.ln2_s, L.ln2_b, eps, s[kRows], M, D, st));
    TRY(mocr_bf16_gemm(s[kRows], L.fc1.w, L.fc1.bias, nullptr, s[kHidden], M, I, D,
                       sigmoid ? kBfGeluSigmoid : kBfGeluErf, st));
    TRY(mocr_bf16_gemm(s[kHidden], L.fc2.w, L.fc2.bias, s[kX2], out, M, D, I, kBfResidual, st));
  }
  return 0;
}

}  // namespace

extern "C" {

// Layers [0, n_layers) of the slab whose first layer's pointers are ``w``:
// kernel H is one layer with the softmax multiplying by the reciprocal of
// its sum (divide = 0, as _attn_core), kernel I a slab of ``lpc`` layers
// with the softmax dividing (divide = 1, as _one_layer).  The first layer
// reads x, each writes ``out``, and every later one reads ``out`` back (its
// input is dead once its attention half has written x2, so fc2 may
// overwrite it).
int mocr_encoder_layers(const void* const* w, int n_w, void* const* s, int n_s, const void* x,
                        void* out, int n_layers, int int8, int gelu_sigmoid, int divide, int B,
                        int S, int D, int H, int I, float eps, float scale, void* stream) {
  if (n_w != kSlots || n_s != kScratch || n_layers < 1 || H < 1 || D % H)
    return (int)cudaErrorInvalidValue;
  for (int j = 0; j < n_layers; ++j) {
    TRY(run_layer(layer_at(w, j, int8 != 0, D, I), s, j == 0 ? x : out, out, int8 != 0,
                  gelu_sigmoid != 0, divide != 0, B, S, D, H, I, eps, scale, stream));
  }
  return 0;
}

}  // extern "C"
