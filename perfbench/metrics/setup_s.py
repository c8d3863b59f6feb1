"""s: from the process's start to the first timed item: imports, the kernel
library (built only by a checkout's first run), weights, engine, pool,
schedule, every shape's CUDA graph, and one untimed pass."""


def read(run):
    return run.setup_s
