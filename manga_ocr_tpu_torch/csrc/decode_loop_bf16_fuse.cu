// Kernel C in one form: bf16 decoder weights, the fuse_kv prologue (decode_loop.cuh).
#include "decode_loop.cuh"

template int mocr::launch_decode_loop<false, true>(
    bool, int, const mocr::DecodeParams&, int, int, int*, int*, cudaStream_t);
