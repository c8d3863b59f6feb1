"""Closed-loop synthetic accuracy of the port (counterpart of
``tests/test_closed_loop_accuracy.py``): train a small model from scratch
with ``manga_ocr_tpu_torch.train`` on rendered glyph crops, then read
held-out crops through ``TorchMangaOcrEngine.ocr_page`` on the CPU and hold
the JAX test's bars (final loss < 0.25, >= 28 of 32 exact, mean CER <=
0.05).  It shows the whole port reads: the training objective, encoder and
decoder math, bucketing, valid-region preprocessing, greedy decode and
detokenization agree end to end, not only piece by piece against JAX.

Slow (up to 1500 steps of B=32 on the CPU), as the JAX test is."""

import numpy as np
import pytest
import torch

from manga_ocr_tpu_torch import train as tr
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
from manga_ocr_tpu_torch.eval import cer
from manga_ocr_tpu_torch.models.config import DecoderConfig, EncoderConfig, MangaOCRConfig
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from manga_ocr_tpu_torch.ops import preprocess as pp
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SEQ = 6  # [CLS] + up to 3 chars + [SEP]


def _cfg() -> MangaOCRConfig:
    # the JAX test's config: reads 3 vertical glyphs (17 encoder tokens)
    return MangaOCRConfig(
        encoder=EncoderConfig(
            image_size=64, patch_size=16, hidden_size=64,
            num_layers=2, num_heads=4, intermediate_size=128,
        ),
        decoder=DecoderConfig(
            vocab_size=100, hidden_size=64, num_layers=2,
            num_heads=4, intermediate_size=128, max_position_embeddings=16,
        ),
    )


def _render(text, rng):
    return tr.render_text_crop(
        text, rng, 64, hw=(int(rng.integers(52, 62)), int(rng.integers(36, 46))),
    )


def _sample_text(rng, chars):
    n = int(rng.integers(1, 4))
    return "".join(rng.choice(chars) for _ in range(n))


@pytest.mark.slow
def test_trained_from_scratch_reads_through_the_engine():
    cfg = _cfg()
    tok = CharTokenizer.synthetic()
    chars = [t for t in tok.id_to_token[4 : cfg.decoder.vocab_size] if len(t) == 1][:8]

    def make_batch(rng, bs=32):
        crops, texts = [], []
        for _ in range(bs):
            texts.append(_sample_text(rng, chars))
            crops.append(_render(texts[-1], rng))
        mh = max(c.shape[0] for c in crops)
        mw = max(c.shape[1] for c in crops)
        sizes = np.array([c.shape[:2] for c in crops], np.int32)
        arr = np.zeros((bs, mh, mw, 3), np.uint8)
        for i, c in enumerate(crops):
            arr[i, : c.shape[0], : c.shape[1]] = c
        # the preprocessing the serving engine runs
        px = pp.model_preprocess(torch.from_numpy(arr), torch.from_numpy(sizes), image_size=64)
        tokens = np.full((bs, SEQ), cfg.decoder.pad_token_id, np.int32)
        mask = np.zeros((bs, SEQ), np.float32)
        for i, t in enumerate(texts):
            ids = tok.encode(t)[:SEQ]
            tokens[i, : len(ids)] = ids
            mask[i, : len(ids)] = 1.0
        return tr.TrainBatch(px.float(), torch.from_numpy(tokens), torch.from_numpy(mask))

    opt = tr.make_optimizer(lr=1e-3)
    params, opt_state = tr.init_train_state(cfg, opt, 0, "cpu")
    step = tr.make_train_step(cfg)
    rng = np.random.default_rng(0)
    loss = float("inf")
    for _ in range(1500):
        params, opt_state, loss = step(params, opt_state, make_batch(rng))
        if loss.item() < 0.02:
            break
    assert loss.item() < 0.25, f"did not learn the synthetic task: loss={loss.item()}"

    engine = TorchMangaOcrEngine(params, cfg, tok, max_length=SEQ, dtype=torch.float32,
                                 device="cpu")
    erng = np.random.default_rng(99)
    refs, crops = [], []
    for _ in range(32):
        refs.append(_sample_text(erng, chars))
        crops.append(_render(refs[-1], erng))
    got = engine.ocr_page(crops, orientation=pp.ORIENT_NONE)
    exact = sum(g == r for g, r in zip(got, refs))
    mean_cer = float(np.mean([cer(g, r) for g, r in zip(got, refs)]))
    assert exact >= 28, (exact, list(zip(refs, got)))
    assert mean_cer <= 0.05, (mean_cer, list(zip(refs, got)))
