"""%: the least time of what kernel C computes for the crops returned (each
row's own steps, no padding rows; its bf16 products or its bytes, each
once: ``flops.decode_bound_s``) over its summed device time in the trace."""


def read(run):
    if run.trace is None or not run.returned:
        return None
    t = run.trace.device_time_s(run.kernels["decode"])
    return 100.0 * run.decode_bound_s() / t if t > 0 else None
