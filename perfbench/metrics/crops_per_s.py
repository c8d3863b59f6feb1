"""crops/s: every crop whose string came back, over the window (from handing
in the first item to the entry's return)."""


def read(run):
    if run.outcome.batches is not None or run.window_s <= 0:
        return None
    return run.returned / run.window_s
