"""%: the least time of what the encoder's kernels compute for the crops
returned (their operations at the peak of their type, or their bytes, each
byte once, no padding rows: ``flops.encoder_bound_s``) over the family's
summed device time in the trace."""


def read(run):
    if run.trace is None or not run.returned:
        return None
    t = run.trace.device_time_s(run.kernels["encoder"])
    return 100.0 * run.encoder_bound_s() / t if t > 0 else None
