"""One client that streams pages into the entry and hands in the next page
as soon as the entry takes it.

Parameters: ``page_crops`` [lo, hi], crops a page (uniform).  The pages
hold every crop of the pool once (the last page what is left), and the
driver cycles them, so every pass over them is the same work.  Which crops
make a page is fixed (the pool's ``size_seed``), so every seed's pages fall
into the same buckets; the seed draws the order of the pages and of the
crops within each.
"""

from __future__ import annotations

import numpy as np

from perfbench.harness import traffic


def schedule(mix: dict, seed: int, seconds: float) -> traffic.Schedule:
    lo, hi = mix["page_crops"]
    pool_n = mix["pool"]["size"]
    fixed = traffic.fixed(mix, 1)
    counts = fixed.integers(lo, hi + 1, size=pool_n // lo + 1)
    n = int(np.searchsorted(np.cumsum(counts), pool_n)) + 1
    counts = counts[:n]
    counts[-1] -= int(counts.sum()) - pool_n
    members = fixed.permutation(pool_n)
    bounds = np.concatenate([[0], np.cumsum(counts)])
    pages = [members[a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    gen = traffic.rng(seed, 2)
    return traffic.Schedule(pages=[gen.permutation(pages[k]).tolist()
                                   for k in gen.permutation(n)])
