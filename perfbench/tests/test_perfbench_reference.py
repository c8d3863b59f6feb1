"""The plain reference against the port's CPU path at ``MangaOCRConfig.tiny()``:
the host preparation and ``model_preprocess``, the encoder in float32 and in
the int8 serving form, the teacher-forced decoder, and the served tokens of
the engine judged by the reference."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from perfbench.harness import check, crops, spec, weights
from perfbench.reference import dims as dimslib
from perfbench.reference import model as ref
from perfbench.tests.conftest import ROOT, tiny_config

SEED = 3_000_000_019


@pytest.fixture(scope="module")
def tiny():
    with open(os.path.join(ROOT, "perfbench", "configs", "mangaocr-base-int8.json")) as f:
        cfg = tiny_config(json.load(f), "tiny-int8")
    return cfg, dimslib.read(cfg)


@pytest.fixture(scope="module")
def pool():
    mix = spec.traffic(ROOT, "chapter")
    return crops.draw(dict(mix["pool"], size=12), SEED)


@pytest.fixture(scope="module")
def port_cfg():
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig

    return MangaOCRConfig.tiny()


def test_tiny_dims_are_the_ports_tiny(tiny, port_cfg):
    _, d = tiny
    e, pe = d.encoder, port_cfg.encoder
    assert (e.image_size, e.patch_size, e.hidden, e.layers, e.heads, e.intermediate) == (
        pe.image_size, pe.patch_size, pe.hidden_size, pe.num_layers, pe.num_heads,
        pe.intermediate_size)
    dd, pd = d.decoder, port_cfg.decoder
    assert (dd.vocab, dd.hidden, dd.layers, dd.heads, dd.intermediate, dd.positions) == (
        pd.vocab_size, pd.hidden_size, pd.num_layers, pd.num_heads, pd.intermediate_size,
        pd.max_position_embeddings)
    assert (dd.bos_id, dd.eos_id, dd.pad_id) == (pd.bos_token_id, pd.eos_token_id,
                                                  pd.pad_token_id)


def test_pixels_match_host_prep_and_model_preprocess(pool):
    from manga_ocr_tpu_torch.ops.preprocess import model_preprocess
    from manga_ocr_tpu_torch.parallel import batching

    for size in (32, 224):
        want = ref.pixels(pool, "vertical", size, "cpu")
        rows = [None] * len(pool)
        for b in batching.prep_page_gray(pool, 1):
            px = model_preprocess(torch.from_numpy(b.crops), torch.from_numpy(b.sizes), size)
            for row, i in enumerate(b.indices):
                rows[i] = px[row]
        got = torch.stack(rows)
        assert got.shape == want.shape == (len(pool), size, size, 3)
        assert float((got - want).abs().max()) < 1e-4  # float32 sums over <= 480 taps


def test_encoder_float32(tiny, pool, port_cfg):
    from manga_ocr_tpu_torch.models import vit

    cfg, d = tiny
    tree = weights.make(d, SEED, 0.1, "cpu")
    px = ref.pixels(pool, "vertical", d.encoder.image_size, "cpu")
    want = ref.encode(tree["encoder"], px, d, "f32", "erf")
    got = vit.encode(tree["encoder"], px, port_cfg.encoder, use_kernels=False)
    assert float((got - want).abs().max()) < 1e-4


def test_encoder_int8_serving_form(tiny, pool, port_cfg):
    from manga_ocr_tpu_torch.models import vit
    from manga_ocr_tpu_torch.models.config import with_serving_kernels
    from manga_ocr_tpu_torch.models.quantize import quantize_encoder

    cfg, d = tiny
    tree = weights.make(d, SEED, 0.1, "cpu")
    px = ref.pixels(pool, "vertical", d.encoder.image_size, "cpu")
    serving = with_serving_kernels(port_cfg, quantized=True)
    assert serving.encoder.gelu_mode == cfg["reference"]["encoder_gelu"] == "sigmoid"
    got = vit.encode(quantize_encoder(tree["encoder"], quantize_attn_proj=True), px,
                     serving.encoder, use_kernels=False)
    want = ref.encode(tree["encoder"], px, d, "int8", "sigmoid")
    plain = ref.encode(tree["encoder"], px, d, "f32", "sigmoid")
    err = float((got - want).abs().max())
    # the same quantization up to a few roundings at a level's edge; the
    # float32 form differs by the quantization itself, far more
    assert err < 2e-3
    assert float((got - plain).abs().max()) > 5 * err


def test_decoder_teacher_forced(tiny, pool, port_cfg):
    from manga_ocr_tpu_torch.models import decoder

    cfg, d = tiny
    tree = weights.make(d, SEED, 0.1, "cpu")
    px = ref.pixels(pool, "vertical", d.encoder.image_size, "cpu")
    enc = ref.encode(tree["encoder"], px, d, "f32", "erf")
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, d.decoder.vocab,
                                                             size=(len(pool), 9)))
    ids[:, 0] = d.decoder.bos_id
    want = ref.decoder_logits(tree["decoder"], enc, ids, d, "f32")
    got = decoder.forward_full(tree["decoder"], ids, enc, port_cfg.decoder)
    assert float((got - want).abs().max()) < 1e-4


def test_engine_answers_judged_by_the_reference(tiny, pool):
    from perfbench.harness import system

    cfg, d = tiny
    tree = weights.make(d, SEED, 0.1, "cpu")
    eng = system.engine(tree, cfg, d, "cpu")
    answers = eng.ocr_page(pool, 1)
    rows = [check.parse(a, d) for a in answers]
    assert all(r is not None for r in rows)
    assert all(r[0] == d.decoder.bos_id for r in rows)
    read = check.readings(tree, d, cfg, pool, rows, "vertical", "cpu", control=True)
    assert read["tokens"] >= len(pool)
    assert read["max_gap"] < 0.1 < read["control_max_gap"]
    assert read["row_gap"] >= read["max_gap"] >= read["mean_gap"] > 0
    assert read["control_row_gap"] >= read["control_max_gap"] > 0.1
    # another crop's answer lies far below the reference's best
    swapped = rows[1:] + rows[:1]
    wrong = check.readings(tree, d, cfg, pool, swapped, "vertical", "cpu")["max_gap"]
    assert wrong > max(0.1, 5 * read["max_gap"])
