"""%: the model FLOPs of the crops returned (the benchmark's own arithmetic:
each crop's real tokens and its own decode steps, self-attention as a
triangle, no padding) over the window, over the H100's bf16 dense peak."""

from perfbench.harness import flops


def read(run):
    if run.trace is None or run.window_s <= 0 or not run.returned:
        return None
    return 100.0 * run.model_flops() / run.window_s / flops.PEAK_BF16
