// Kernel C in one form: int8 decoder weights, precomputed slabs (decode_loop.cuh).
#include "decode_loop.cuh"

template int mocr::launch_decode_loop<true, false>(
    bool, int, const mocr::DecodeParams&, int, int, int*, int*, cudaStream_t);
template int mocr::decode_loop_blocks_per_sm<true, false>(bool, int, int, int*);
