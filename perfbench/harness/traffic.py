"""The traffic generator: a mix's parameters -> the run's schedule.

A mix file (``perfbench/traffic/<name>.json``) names a ``pattern``, the
program entry that its ``driver`` drives, and its numbers.  The pattern is
a file of its own, ``perfbench/patterns/<pattern>.py``, with
``schedule(mix, seed, seconds) -> Schedule``; a new pattern is a new file.

Every pattern gives every seed the same work: the same crop sizes, page
sizes and gaps between arrivals (drawn from the pool's fixed
``size_seed``), in an order drawn from the seed.  The pool holds its crops
in the fixed size order (``crops.draw``), so a pool index names a size.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from perfbench.harness import spec


@dataclasses.dataclass
class Schedule:
    pages: list | None = None  # closed loops: pool indices a page
    arrivals: np.ndarray | None = None  # open loops: seconds after the start
    requests: np.ndarray | None = None  # open loops: pool index a request


def rng(seed: int, stream: int) -> np.random.Generator:
    """The seed's generator of one stream (a seed may take more than 63 bits)."""
    return np.random.default_rng([int(seed) % 2**63, stream])


def fixed(mix: dict, stream: int) -> np.random.Generator:
    """The generator every seed shares: the pool's ``size_seed`` plus the
    stream's number."""
    return np.random.default_rng(mix["pool"].get("size_seed", 0) + stream)


def cycle(gen: np.random.Generator, pool_n: int, count: int) -> np.ndarray:
    """``count`` pool indices: permutations of the pool, one after another."""
    reps = -(-count // pool_n)
    return np.concatenate([gen.permutation(pool_n) for _ in range(reps)])[:count]


def schedule(root: str, mix: dict, seed: int, seconds: float) -> Schedule:
    return spec.pattern(root, mix["pattern"]).schedule(mix, seed, seconds)
