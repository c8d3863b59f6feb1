"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA GPU and nvcc; without them every test skips (the
decision is made inside the fixture, never at import).  Run on the card:

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest

(``--noconftest``: tests/conftest.py sets up JAX, which the card's machine
does not need and may not have.)

Shapes are small but satisfy the kernels' constraints (K % 64 == 0, even
N, head dims multiples of 8).  Tolerances: see chip_smoke.py — the int8
products are exact, so encoder outputs differ by at most a few bf16 ulps of
the largest output; decode tokens are scored by the plain version fed the
kernel's tokens (teacher forcing).
"""

import os
import shutil

import numpy as np
import pytest
import torch

from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.tokenizer import CharTokenizer

pytestmark = pytest.mark.cuda

ENC_MAX_REL = 2.0**-5
DECODE_GAP_REL = 2.0**-6


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not (shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc")):
        pytest.skip("needs nvcc")
    return torch.device("cuda")


def _quantized_dense(rng, k, n, device):
    from manga_ocr_tpu_torch.ops.quant import quantize_weight_per_col

    w_q, scale = quantize_weight_per_col(torch.from_numpy(rng.normal(size=(k, n)) * 0.05))
    return {"w_q": w_q.to(device), "scale": scale.to(device),
            "bias": torch.from_numpy(0.1 * rng.normal(size=(n,))).float().to(device)}


def test_attention_layer_kernel_matches_plain(device):
    from manga_ocr_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(0)
    d, heads = 128, 2
    p = {n: _quantized_dense(rng, d, d, device) for n in "qkvo"}
    x = torch.from_numpy(rng.normal(size=(3, 37, d))).to(device, torch.bfloat16)
    ln = (torch.ones(d, device=device), torch.zeros(d, device=device))
    for valid in (37, 30):
        before = fa.fused_attn_layer.launches
        got = fa.fused_attn_layer(x, p, *ln, heads, valid_len=valid)
        want = fa.fused_attn_layer_reference(x, p, *ln, heads, valid_len=valid)
        assert fa.fused_attn_layer.launches == before + 1
        err = float((got.float() - want.float()).abs().max())
        assert err <= ENC_MAX_REL * float(want.float().abs().max())


def test_mlp_block_kernel_matches_plain(device):
    from manga_ocr_tpu_torch.ops import fused_mlp as fm

    rng = np.random.default_rng(1)
    d, inter = 128, 256
    fc1, fc2 = _quantized_dense(rng, d, inter, device), _quantized_dense(rng, inter, d, device)
    x = torch.from_numpy(rng.normal(size=(70, d))).to(device, torch.bfloat16)
    ln = (torch.ones(d, device=device), torch.zeros(d, device=device))
    args = (x, *ln, (fc1["w_q"], fc1["scale"]), fc1["bias"], (fc2["w_q"], fc2["scale"]),
            fc2["bias"])
    got = fm.fused_mlp_block(*args, gelu_mode="sigmoid")
    want = fm.fused_mlp_block_reference(*args, gelu_mode="sigmoid")
    err = float((got.float() - want.float()).abs().max())
    assert err <= ENC_MAX_REL * float(want.float().abs().max())


def test_kernel_wrappers_reject_what_they_do_not_take(device):
    from manga_ocr_tpu_torch.kernels import launch

    a = torch.zeros((4, 96), dtype=torch.int8, device=device)  # K % 64 != 0
    with pytest.raises(ValueError):
        launch.int8_gemm(a, a, torch.zeros(4, device=device), torch.zeros(4, device=device),
                         torch.zeros(4, device=device), launch.GEMM_BF16)


def test_decode_loop_kernel_tokens_are_greedy_under_plain_model(device):
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops import decode_loop as dl

    cfg = MangaOCRConfig.tiny()
    params = mdl.cast_params(init_params(cfg, 0, device)["decoder"], torch.bfloat16)
    enc = torch.randn((5, cfg.encoder.seq_len, 64), device=device).to(torch.bfloat16)
    cross = dec.precompute_cross_kv_packed(params, enc, cfg.decoder)
    for stops in (None, torch.tensor([2, 4, 6, 8, 30], device=device)):
        tokens, lengths = dl.greedy_decode_loop(params, cross, cfg.decoder, 20, stop_lengths=stops)
        assert tokens.shape == (5, 21) and bool((tokens[:, 0] == cfg.decoder.bos_token_id).all())
        gaps, top = dl.teacher_forced_gaps(params, cross, cfg.decoder, tokens)
        live = torch.arange(20, device=device)[None, :] + 1 < lengths[:, None]
        assert float((gaps[live] / top[live].abs()).max()) <= DECODE_GAP_REL
        if stops is not None:
            assert bool((lengths <= stops).all())


def test_engine_runs_through_all_three_kernels(device):
    from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
    from manga_ocr_tpu_torch.models.params import init_params
    from manga_ocr_tpu_torch.ops.decode_loop import greedy_decode_loop
    from manga_ocr_tpu_torch.ops.flash_attention import fused_attn_layer
    from manga_ocr_tpu_torch.ops.fused_mlp import fused_mlp_block

    cfg = MangaOCRConfig.tiny()
    engine = TorchMangaOcrEngine(init_params(cfg, 0, "cpu"), cfg, CharTokenizer.synthetic(),
                                 max_length=10, device=device)
    before = [w.launches for w in (fused_attn_layer, fused_mlp_block, greedy_decode_loop)]
    crops = [np.random.default_rng(i).integers(0, 256, (40, 60, 3), dtype=np.uint8)
             for i in range(3)]
    texts = engine.ocr_page(crops)
    after = [w.launches for w in (fused_attn_layer, fused_mlp_block, greedy_decode_loop)]
    assert len(texts) == 3 and all(isinstance(t, str) for t in texts)
    layers = cfg.encoder.num_layers
    assert [a - b for a, b in zip(after, before)] == [layers, layers, 1]
