"""The crop pool and the traffic generator: deterministic from the seed, the
size law of the mix files, the same sizes, pages and gaps for every seed,
and the buckets the pool falls into under the program's rules."""

from __future__ import annotations

import collections

import numpy as np
import pytest

from perfbench.harness import crops, spec, system, traffic
from perfbench.tests.conftest import ROOT

SEED = 2_200_000_017  # above 2**31: a run's seed may take more than 32 bits


@pytest.fixture(scope="module")
def chapter():
    return spec.traffic(ROOT, "chapter")


def small(mix: dict, size: int = 64) -> dict:
    out = dict(mix)
    out["pool"] = dict(mix["pool"], size=size)
    return out


def test_pool_is_deterministic_from_the_seed(chapter):
    mix = small(chapter)
    a, b = crops.draw(mix["pool"], SEED), crops.draw(mix["pool"], SEED)
    assert all(x.dtype == np.uint8 and x.ndim == 3 and x.shape[2] == 3 for x in a)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    c = crops.draw(mix["pool"], SEED + 1)
    assert any(x.shape != y.shape or not np.array_equal(x, y) for x, y in zip(a, c))


def test_every_seed_gets_the_same_sizes_in_the_fixed_order(chapter):
    mix = small(chapter)
    a = [x.shape[:2] for x in crops.draw(mix["pool"], 1)]
    b = [x.shape[:2] for x in crops.draw(mix["pool"], SEED)]
    assert a == b == [tuple(hw) for hw in crops.sizes(mix["pool"]).tolist()]


def test_size_law_of_the_mix_files():
    for name in ("chapter", "pages", "serve"):
        mix = spec.traffic(ROOT, name)
        hw = crops.sizes(mix["pool"])
        (h0, h1), (w0, w1) = mix["pool"]["height"], mix["pool"]["width"]
        assert (h0, h1, w0, w1) == (96, 480, 64, 320)
        assert hw[:, 0].min() >= h0 and hw[:, 0].max() <= h1
        assert hw[:, 1].min() >= w0 and hw[:, 1].max() <= w1
        # uniform: the mean within 5% of the range's middle, both halves filled
        assert abs(hw[:, 0].mean() - (h0 + h1) / 2) < 0.05 * (h1 - h0)
        assert abs(hw[:, 1].mean() - (w0 + w1) / 2) < 0.05 * (w1 - w0)
        assert mix["pool"]["size"] == 1024 and len(hw) == 1024


def test_crops_are_light_paper_with_dark_strokes(chapter):
    for c in crops.draw(small(chapter, 16)["pool"], SEED):
        g = c[..., 0]
        assert np.median(g) > 200 and g.min() < 80
        assert np.array_equal(c[..., 0], c[..., 1]) and np.array_equal(c[..., 1], c[..., 2])


def test_bucket_spread_under_the_program_rules(chapter):
    pool = [np.zeros((int(h), int(w), 3), np.uint8) for h, w in crops.sizes(chapter["pool"])]
    counts = collections.Counter(hw for hw, _, idx in system.dispatches(pool, "vertical")
                                 for _ in idx)
    # vertical text: a crop wider than tall is turned, so no wide bucket occurs
    assert set(counts) == {(128, 128), (256, 128), (256, 256), (512, 256), (512, 512)}
    assert counts[(512, 256)] > counts[(256, 256)] > counts[(512, 512)] > counts[(128, 128)]


def _buckets(page: list[int], hw: np.ndarray) -> tuple:
    pool = [np.zeros((int(hw[j][0]), int(hw[j][1]), 3), np.uint8) for j in page]
    return tuple((b, n) for b, n, _ in system.dispatches(pool, "vertical"))


def test_closed_pages_schedule(chapter):
    a = traffic.schedule(ROOT, chapter, SEED, 10)
    b = traffic.schedule(ROOT, chapter, SEED, 10)
    assert a.pages == b.pages and len(a.pages) == 4
    assert all(len(p) == 256 for p in a.pages)
    # the pages hold every crop of the pool once: every pass is the same work
    assert sorted(j for p in a.pages for j in p) == list(range(1024))
    pages = spec.traffic(ROOT, "pages")
    s1, s2 = traffic.schedule(ROOT, pages, 1, 10), traffic.schedule(ROOT, pages, SEED, 10)
    n1, n2 = [len(p) for p in s1.pages], [len(p) for p in s2.pages]
    assert sum(n1) == 1024 and sorted(j for p in s1.pages for j in p) == list(range(1024))
    assert min(n1) >= 1 and max(n1) <= 20 and sorted(n1) == sorted(n2) and n1 != n2
    assert sorted(n1)[1] >= 4  # only the last page drawn may hold fewer than 4
    assert abs(np.mean(n1) - 12) < 1.0


@pytest.mark.parametrize("name", ["chapter", "pages"])
def test_every_seed_gets_the_same_pages_in_another_order(name):
    mix = spec.traffic(ROOT, name)
    a = traffic.schedule(ROOT, mix, 1, 10).pages
    b = traffic.schedule(ROOT, mix, SEED, 10).pages
    assert sorted(sorted(p) for p in a) == sorted(sorted(p) for p in b)
    assert a != b and [sorted(p) for p in a] != [sorted(p) for p in b]
    # so every seed's pages make the same dispatches: the same work
    hw = crops.sizes(mix["pool"])
    assert sorted(_buckets(p, hw) for p in a) == sorted(_buckets(p, hw) for p in b)


def test_open_poisson_schedule():
    mix = dict(spec.traffic(ROOT, "serve"), rate_per_s=500.0)
    a, b = traffic.schedule(ROOT, mix, SEED, 20), traffic.schedule(ROOT, mix, SEED, 20)
    assert np.array_equal(a.arrivals, b.arrivals) and np.array_equal(a.requests, b.requests)
    assert len(a.arrivals) == 10_000 and a.arrivals[0] == 0.0
    assert np.all(np.diff(a.arrivals) >= 0) and a.arrivals[-1] < 20
    c = traffic.schedule(ROOT, mix, 7, 20)
    ga, gc = np.diff(np.append(a.arrivals, 20)), np.diff(np.append(c.arrivals, 20))
    np.testing.assert_allclose(np.sort(ga), np.sort(gc))
    assert not np.array_equal(ga, gc)
    # exponential gaps: their spread is their mean
    assert abs(ga.std() / ga.mean() - 1) < 0.05


def test_open_poisson_bursts_keep_the_mean_rate():
    mix = dict(spec.traffic(ROOT, "serve"), rate_per_s=500.0,
               bursts={"period_s": 2.0, "on_share": 0.25})
    a = traffic.schedule(ROOT, mix, SEED, 20)
    assert len(a.arrivals) == 10_000 and np.all(np.diff(a.arrivals) >= 0)
    assert a.arrivals[-1] < 20
    # every arrival in the first half second of its 2 s period
    assert np.all(np.mod(a.arrivals, 2.0) < 0.5 + 1e-9)
    per_period = np.bincount((a.arrivals // 2.0).astype(int), minlength=10)
    assert len(per_period) == 10 and abs(per_period.mean() - 1000) < 1e-9
    assert per_period.min() > 800
