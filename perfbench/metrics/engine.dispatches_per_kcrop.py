"""count: CUDA graph launches (``cudaGraphLaunch`` in the trace: one a
(bucket, padded batch) dispatch under ``aot``) per 1,000 crops returned."""


def read(run):
    if run.trace is None or not run.returned:
        return None
    n = run.trace.count_host("cudaGraphLaunch")
    return 1000.0 * n / run.returned if n else None
