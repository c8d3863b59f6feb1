// Kernel C in one form: int8 decoder weights, the fuse_kv prologue (decode_loop.cuh).
#include "decode_loop.cuh"

template int mocr::launch_decode_loop<true, true>(
    bool, int, const mocr::DecodeParams&, int, int, int*, int*, cudaStream_t);
