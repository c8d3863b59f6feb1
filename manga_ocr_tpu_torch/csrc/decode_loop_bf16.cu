// Kernel C in one form: bf16 decoder weights, precomputed slabs (decode_loop.cuh).
#include "decode_loop.cuh"

template int mocr::launch_decode_loop<false, false>(
    bool, int, const mocr::DecodeParams&, int, int, int*, int*, cudaStream_t);
template int mocr::decode_loop_blocks_per_sm<false, false>(bool, int, int, int*);
