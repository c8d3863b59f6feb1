"""What a run leaves for the metric readers (``perfbench/metrics/*.py``).

A reader gets one ``Record`` and returns a number, or None where the run
gave it nothing to read (the harness then leaves the metric out).
"""

from __future__ import annotations

import dataclasses
import math

from perfbench.harness import flops
from perfbench.harness.drive import Outcome
from perfbench.harness.trace import Trace
from perfbench.reference.dims import Dims


@dataclasses.dataclass
class Record:
    cell: str
    config: dict
    mix: dict
    dims: Dims
    setup_s: float
    outcome: Outcome
    lengths: list  # served token count an item (BOS and EOS included), None where invalid
    kernels: dict  # kernel families: name -> regular expression over device op names
    trace: Trace | None = None

    @property
    def returned(self) -> int:
        """Items whose answer came back and spells a valid row."""
        return sum(1 for n in self.lengths if n is not None)

    @property
    def window_s(self) -> float:
        return self.outcome.window_s

    def steps(self) -> list[int]:
        """The decode steps of every valid answer (the tokens after BOS)."""
        return [n - 1 for n in self.lengths if n is not None]

    def model_flops(self) -> float:
        """The model FLOPs of every valid answer (its own steps, no padding)."""
        return sum(flops.crop_flops(self.dims, n) for n in self.steps())

    def encoder_bound_s(self) -> float:
        form = self.config["serving"]["encoder_kernels"]
        return flops.encoder_bound_s(self.dims, self.returned, form)

    def decode_bound_s(self) -> float:
        return flops.decode_bound_s(self.dims, self.steps())


def percentile(values: list[float], q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, by the nearest rank:
    the smallest value with at least q% of the values at or below it, so an
    infinite value (a request never answered) is a value like the others."""
    if not values:
        return math.nan
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]
