"""ms: the median latency over the same requests as ``crop_p95_ms``."""

import math
import sys

from perfbench.harness.record import percentile


def read(run):
    lat = run.outcome.latency_s
    if not lat:
        return None
    v = percentile(lat, 50) * 1000.0
    return v if math.isfinite(v) else sys.float_info.max
