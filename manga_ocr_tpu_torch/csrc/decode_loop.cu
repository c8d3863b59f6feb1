// Kernel C's C entry point: unpacks the pointers and ints the wrapper
// (ops/decode_loop.py) passes and launches the form they ask for; the
// kernel and its design notes are in decode_loop.cuh, each form compiled in
// its own source.
#include "decode_loop.cuh"

using namespace mocr;

namespace mocr {
extern template int launch_decode_loop<false, false>(bool, int, const DecodeParams&, int, int,
                                                     int*, int*, cudaStream_t);
extern template int launch_decode_loop<false, true>(bool, int, const DecodeParams&, int, int,
                                                    int*, int*, cudaStream_t);
extern template int launch_decode_loop<true, false>(bool, int, const DecodeParams&, int, int,
                                                    int*, int*, cudaStream_t);
extern template int launch_decode_loop<true, true>(bool, int, const DecodeParams&, int, int,
                                                   int*, int*, cudaStream_t);
extern template int decode_loop_blocks_per_sm<false, false>(bool, int, int, int*);
extern template int decode_loop_blocks_per_sm<false, true>(bool, int, int, int*);
extern template int decode_loop_blocks_per_sm<true, false>(bool, int, int, int*);
extern template int decode_loop_blocks_per_sm<true, true>(bool, int, int, int*);
}  // namespace mocr

extern "C" {

// Blocks per SM of the form (int8_w, fuse_kv, opts) at ``rows`` per block
// and ``smem`` dynamic bytes, into *blocks.
int mocr_decode_loop_blocks_per_sm(int int8, int fuse_kv, int opts, int rows, int smem,
                                   int* blocks) {
  if (fuse_kv)
    return int8 ? decode_loop_blocks_per_sm<true, true>(opts, rows, smem, blocks)
                : decode_loop_blocks_per_sm<false, true>(opts, rows, smem, blocks);
  return int8 ? decode_loop_blocks_per_sm<true, false>(opts, rows, smem, blocks)
              : decode_loop_blocks_per_sm<false, false>(opts, rows, smem, blocks);
}

// ptrs: COMMON_PTRS pointers (tok_emb, pos_emb, tok_type, elns, elnb, twt, tbt,
// hlns, hlnb, wp, bp, cross_k, cross_v, cache_k, cache_v, stops-or-null,
// enc-or-null, fns-or-null, fnb-or-null) then LAYER_PTRS per layer in LayerW
// order (null for an absent scale or fuse_kv weight).  ints: B, D, H, I, V,
// L, S (slab rows = keys attended), steps, bos, eos, pad, rows_per_block,
// int8_w, fuse_kv, S_enc (rows of enc), ablate, gelu_sigmoid.
int mocr_decode_loop(void** ptrs, int n_ptrs, int* ints, int n_ints, float scale, float eps,
                     void* tokens, void* lengths, void* stream) {
  if (n_ints != N_INTS) return (int)cudaErrorInvalidValue;
  DecodeParams p = {};
  p.B = ints[0]; p.D = ints[1]; p.H = ints[2]; p.I = ints[3]; p.V = ints[4]; p.L = ints[5];
  p.S = ints[6]; p.steps = ints[7]; p.bos = ints[8]; p.eos = ints[9]; p.pad = ints[10];
  const int rows = ints[11], int8 = ints[12], fuse_kv = ints[13];
  p.S_enc = ints[14]; p.ablate = ints[15]; p.gelu_sigmoid = ints[16];
  if (p.L > MAX_LAYERS || n_ptrs != COMMON_PTRS + LAYER_PTRS * p.L) return (int)cudaErrorInvalidValue;
  if (p.D % 8 || p.I % 8 || p.V % 2 || (fuse_kv && (!ptrs[16] || p.S > p.S_enc)))
    return (int)cudaErrorInvalidValue;
  p.scale = scale;
  p.eps = eps;
  p.tok_emb = (const bf16*)ptrs[0]; p.pos_emb = (const bf16*)ptrs[1];
  p.tok_type = (const bf16*)ptrs[2]; p.elns = (const float*)ptrs[3];
  p.elnb = (const float*)ptrs[4]; p.twt = (const bf16*)ptrs[5]; p.tbt = (const float*)ptrs[6];
  p.hlns = (const float*)ptrs[7]; p.hlnb = (const float*)ptrs[8]; p.wp = (const bf16*)ptrs[9];
  p.bp = (const float*)ptrs[10]; p.cross_k = (bf16*)ptrs[11];
  p.cross_v = (bf16*)ptrs[12]; p.cache_k = (bf16*)ptrs[13]; p.cache_v = (bf16*)ptrs[14];
  p.stops = (const int*)ptrs[15];
  p.enc = fuse_kv ? (const bf16*)ptrs[16] : nullptr;
  p.fns = (const float*)ptrs[17]; p.fnb = (const float*)ptrs[18];
  for (int l = 0; l < p.L; ++l) {
    void** q = ptrs + COMMON_PTRS + LAYER_PTRS * l;
    LayerW& w = p.layers[l];
    w.wqkv = q[0]; w.sqkv = (const float*)q[1]; w.bqkv = (const float*)q[2];
    w.wo = q[3]; w.so = (const float*)q[4]; w.bo = (const float*)q[5];
    w.slns = (const float*)q[6]; w.slnb = (const float*)q[7];
    w.cwq = q[8]; w.csq = (const float*)q[9]; w.cbq = (const float*)q[10];
    w.cwo = q[11]; w.cso = (const float*)q[12]; w.cbo = (const float*)q[13];
    w.clns = (const float*)q[14]; w.clnb = (const float*)q[15];
    w.w1 = q[16]; w.s1 = (const float*)q[17]; w.b1 = (const float*)q[18];
    w.w2 = q[19]; w.s2 = (const float*)q[20]; w.b2 = (const float*)q[21];
    w.mlns = (const float*)q[22]; w.mlnb = (const float*)q[23];
    w.cwk = (const bf16*)q[24]; w.cbk = (const float*)q[25];
    w.cwv = (const bf16*)q[26]; w.cbv = (const float*)q[27];
    if (int8 && !(w.sqkv && w.so && w.csq && w.cso && w.s1 && w.s2)) return (int)cudaErrorInvalidValue;
    if (fuse_kv && !(w.cwk && w.cbk && w.cwv && w.cbv)) return (int)cudaErrorInvalidValue;
  }
  const int big_n = std::max(3 * p.D, std::max(p.I, p.D));
  const int ld_scores = std::max(p.steps, p.S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* tok = static_cast<int*>(tokens);
  int* len = static_cast<int*>(lengths);
  const bool opts = p.ablate || p.gelu_sigmoid;
  if (fuse_kv)
    return int8 ? launch_decode_loop<true, true>(opts, rows, p, big_n, ld_scores, tok, len, st)
                : launch_decode_loop<false, true>(opts, rows, p, big_n, ld_scores, tok, len, st);
  return int8 ? launch_decode_loop<true, false>(opts, rows, p, big_n, ld_scores, tok, len, st)
              : launch_decode_loop<false, false>(opts, rows, p, big_n, ld_scores, tok, len, st);
}

}  // extern "C"
