"""The benchmark's arithmetic against hand counts for manga-ocr-base."""

from __future__ import annotations

import pytest

from perfbench.harness import flops, spec
from perfbench.reference import dims as dimslib
from perfbench.tests.conftest import ROOT


@pytest.fixture(scope="module")
def base():
    bench = spec.load(ROOT)
    return dimslib.read(spec.config(ROOT, bench, "mangaocr-base-int8"))


def test_sizes_are_the_published_widths(base):
    e, d = base.encoder, base.decoder
    assert (e.image_size, e.patch_size, e.hidden, e.layers, e.heads, e.intermediate) == (
        224, 16, 768, 12, 12, 3072)
    assert e.seq_len == 197
    assert (d.vocab, d.hidden, d.layers, d.intermediate) == (6144, 768, 2, 3072)
    assert base.max_length == 32


def test_encoder_flops_by_hand(base):
    patch = 2 * 196 * (16 * 16 * 3) * 768  # 231,211,008
    qkvo = 2 * 197 * 768 * 4 * 768  # 929,562,624
    attn = 2 * 2 * 197 * 197 * 768  # 119,221,248
    mlp = 2 * 2 * 197 * 768 * 3072  # 1,859,125,248
    assert patch + 12 * (qkvo + attn + mlp) == 35_126_120_448
    assert flops.encoder_flops(base) == 35_126_120_448


def test_decode_flops_by_hand_with_the_triangle(base):
    steps = 31
    cross_kv = 2 * 2 * 2 * 197 * 768 * 768  # 2 layers, k and v: 929,562,624
    per_step = 2 * (2 * 4 * 768**2 + 2 * 2 * 768**2 + 2 * 2 * 197 * 768 + 2 * 2 * 768 * 3072)
    self_attn = 2 * 2 * 2 * 768 * (31 * 32 // 2)  # keys 1 + 2 + ... + 31 = 496
    head = 31 * (2 * 768**2 + 2 * 768 * 6144)
    total = cross_kv + steps * per_step + self_attn + head
    assert total == 2_323_187_712
    assert flops.decode_flops(base, steps) == total
    # a full cache at every step counts 31 keys at each: more than the triangle
    full = cross_kv + steps * per_step + 2 * 2 * 2 * 768 * 31 * 31 + head
    assert full - total == 2 * 2 * 2 * 768 * (31 * 31 - 496)
    assert flops.crop_flops(base, steps) == 35_126_120_448 + total


PEAK8, PEAK16, BW = 1979e12, 989e12, 3.35e12


@pytest.mark.parametrize("rows", [1, 8, 256])
def test_encoder_bound_by_hand(base, rows):
    m, d, i, s, layers = rows * 197, 768, 3072, 197, 12
    attn = 2 * 2 * rows * s * s * d
    # int8: the whole block; its input and output once, its weights once
    ops8 = layers * (2 * m * d * 3 * d + 2 * m * d * d + 2 * 2 * m * d * i + attn)
    bytes8 = layers * (m * d * 2 + m * d * 2 + 4 * d * d + 2 * d * i)
    assert flops.encoder_bound_s(base, rows, "int8") == pytest.approx(
        max(ops8 / PEAK8, bytes8 / BW))
    # bf16: the attention core and the MLP block
    ops16 = layers * (attn + 2 * 2 * m * d * i)
    bytes16 = layers * (m * 3 * d * 2 + m * d * 2 + 2 * m * d * 2 + 2 * d * i * 2)
    assert flops.encoder_bound_s(base, rows, "bf16") == pytest.approx(
        max(ops16 / PEAK16, bytes16 / BW))


def test_encoder_bound_is_compute_bound_over_a_window(base):
    # one crop: the weights' bytes bound it; a window's thousands of crops:
    # the products, at a share of the time linear in the crops
    one = flops.encoder_bound_s(base, 1, "int8")
    many = flops.encoder_bound_s(base, 1000, "int8")
    assert one > flops.encoder_bound_s(base, 1000, "int8") / 1000
    assert flops.encoder_bound_s(base, 2000, "int8") == pytest.approx(2 * many)
    assert flops.encoder_bound_s(base, 256, "bf16") > flops.encoder_bound_s(base, 256, "int8")
    with pytest.raises(ValueError):
        flops.encoder_bound_s(base, 8, "fp8")


def test_decode_bound_by_hand(base):
    # 8 rows of 31 steps and 8 of 5: bytes (weights once, slabs, tokens)
    # against bf16 products
    steps = [31] * 8 + [5] * 8
    slabs = 2 * 2 * 2 * 197 * 768 * 768
    ops = sum(flops.decode_flops(base, n) - slabs for n in steps)
    weights = 2 * (6 * 768**2 + 2 * 768 * 3072) + 768**2 + 768 * 6144
    nbytes = 2 * weights + 16 * (2 * 2 * 197 * 768 * 2) + 4 * sum(steps)
    assert flops.decode_bound_s(base, steps) == pytest.approx(max(ops / PEAK16, nbytes / BW))
    # few rows: the weights' bytes bound it; many: the products
    assert nbytes / BW > ops / PEAK16
    many = [31] * 4096
    assert flops.decode_bound_s(base, many) == pytest.approx(
        sum(flops.decode_flops(base, 31) - slabs for _ in many) / PEAK16)
