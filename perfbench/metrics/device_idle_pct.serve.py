"""%: the share of the traced window that no device operation covers, in
the serve cell (its window ends when the last answer came)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
