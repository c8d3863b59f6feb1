"""Single-crop requests with Poisson arrivals, sent at their scheduled
times whatever the system does.

Parameters: ``rate_per_s``, the mean rate over the window; optional
``bursts`` {``period_s``, ``on_share``}: arrivals only in the first
``on_share`` of each period, at the same mean rate (so ``1 / on_share``
times it while on).

``round(rate * seconds)`` exponential gaps from the fixed generator, scaled
so that they sum to the time the source is on, in an order drawn from the
seed; the first request is due at 0.  Requests take the pool's crops in
permutations drawn from the seed.
"""

from __future__ import annotations

import numpy as np

from perfbench.harness import traffic


def on_time_to_wall(t: np.ndarray, seconds: float, bursts: dict | None) -> np.ndarray:
    """Times on the source's own clock (which runs only while it is on) ->
    seconds after the window's start."""
    if not bursts:
        return t
    on = bursts["period_s"] * bursts["on_share"]
    return np.floor(t / on) * bursts["period_s"] + np.mod(t, on)


def schedule(mix: dict, seed: int, seconds: float) -> traffic.Schedule:
    bursts = mix.get("bursts")
    count = max(1, int(round(mix["rate_per_s"] * seconds)))
    span = seconds * (bursts["on_share"] if bursts else 1.0)
    gaps = traffic.fixed(mix, 2).exponential(1.0, size=count)
    gaps *= span / gaps.sum()
    gen = traffic.rng(seed, 3)
    gaps = gaps[gen.permutation(count)]
    arrivals = on_time_to_wall(np.concatenate([[0.0], np.cumsum(gaps)[:-1]]), seconds, bursts)
    return traffic.Schedule(arrivals=arrivals,
                            requests=traffic.cycle(gen, mix["pool"]["size"], count))
