"""ms: the 95th percentile, over the requests an engine call carried, of the
time from a request's scheduled send to the start of that call."""

from perfbench.harness.record import percentile


def read(run):
    batches, due = run.outcome.batches, run.outcome.scheduled
    if not batches:
        return None
    waits = [start - due[k] for start, _, ks in batches for k in ks if k >= 0]
    return percentile(waits, 95) * 1000.0 if waits else None
