"""ms: the 95th percentile of the latency of every request due in the window,
from its scheduled send to its answer; an unanswered request (or one
answered with the engine's error sentinel) counts as infinite, written as
the largest double."""

import math
import sys

from perfbench.harness.record import percentile


def read(run):
    lat = run.outcome.latency_s
    if not lat:
        return None
    v = percentile(lat, 95) * 1000.0
    return v if math.isfinite(v) else sys.float_info.max
