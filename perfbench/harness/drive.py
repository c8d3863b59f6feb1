"""What the drivers share: the outcome of a window and the waits.

A driver (``perfbench/drivers/<name>.py``, named by the mix's ``driver``)
hands a schedule to one of the program's entry points.  Its ``warm`` is
set-up: every shape the schedule can dispatch captured, the entry run once
untimed; its ``drive`` is the window and returns an ``Outcome``: every item
attempted with its pool index, its answer (None where none came), its
latency where it has one, and the window's length.
"""

from __future__ import annotations

import dataclasses

DRAIN_S = 60.0  # an open loop's wait for its answers past the window
WARM_S = 120.0  # the untimed pass's wait: every shape is captured before it


@dataclasses.dataclass
class Outcome:
    pool_index: list[int]
    answers: list  # str, or None where no answer came
    window_s: float
    latency_s: list[float] | None = None  # inf where no answer came
    batches: list | None = None  # (start, end, [request index]) an engine call
    scheduled: list[float] | None = None  # due time a request, window-relative
    send_lag_s: list[float] | None = None
    page_sizes: list[int] | None = None  # crops a page handed in, in order
