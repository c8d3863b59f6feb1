// The C entry points that one source chains from another (the whole
// encoder blocks of csrc/encoder_layer.cu run the kernels of encoder.cu and
// mlp_bf16.cu), and the epilogue codes of the two GEMMs.  The Python
// launchers (manga_ocr_tpu_torch/kernels/launch.py) use the same codes.
// Every entry point launches on ``stream`` and returns cudaGetLastError().
#pragma once

namespace mocr {

// mocr_int8_gemm: y = (acc * sx[m]) * sw[n] + b[n], then
enum Int8Epilogue {
  kI8Bf16 = 0,           // bf16 out
  kI8GeluSigmoidF32 = 1, // sigmoid GELU, f32 out
  kI8ResidualBf16 = 2,   // bf16(y) + bf16 residual, bf16 out
  kI8F32 = 3,            // f32 out
  kI8GeluErfF32 = 4,     // erf-polynomial GELU, f32 out
};

// mocr_bf16_gemm: y = acc + b[n], then
enum Bf16Epilogue {
  kBfGeluErf = 0,      // erf-polynomial GELU in f32, bf16 out
  kBfGeluSigmoid = 1,  // sigmoid GELU in f32, bf16 out
  kBfResidual = 2,     // bf16(y) + bf16 residual, bf16 out
  kBfF32 = 3,          // f32 out
  kBfBias = 4,         // bf16 out
};

}  // namespace mocr

extern "C" {

int mocr_ln_quant_rows(const void* x, int x_is_bf16, const void* ln_scale, const void* ln_bias,
                       int do_ln, float eps, void* q_out, void* sx_out, int M, int K,
                       void* stream);

int mocr_int8_gemm(const void* a, const void* b_t, const void* sx, const void* sw,
                   const void* bias, const void* residual, void* out, int M, int N, int K,
                   int mode, void* stream);

int mocr_attention(const void* q, const void* k, const void* v, long long in_b, long long in_h,
                   long long in_s, void* out, long long out_b, long long out_h, long long out_s,
                   int out_bf16, int divide, int B, int S, int H, int dh, int valid_len,
                   float scale, void* stream);

int mocr_ln_rows_bf16(const void* x, const void* ln_scale, const void* ln_bias, float eps,
                      void* y, int M, int K, void* stream);

int mocr_bf16_gemm(const void* a, const void* b, const void* bias, const void* residual,
                   void* out, int M, int N, int K, int mode, void* stream);

}  // extern "C"
