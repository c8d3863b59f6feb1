"""The port's checkpoint store (``manga_ocr_tpu_torch/models/checkpoint.py``)
against the JAX package's: a checkpoint saved by either loads in the other
with equal arrays, config and list nodes; and the committed
``tests/fixtures/tiny_random_seed0`` (the engine that
``tests/fixtures/eval/manifest.json`` describes) equals JAX's
``init_params(MangaOCRConfig.tiny(), PRNGKey(0))``."""

import os

import numpy as np
import pytest
import torch

import jax

from manga_ocr_tpu.models import checkpoint as jck
from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu_torch.models import checkpoint as tck
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.models.quantize import quantize_encoder
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SEED0 = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_random_seed0")


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in _flat(v, f"{prefix}/{k}").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree) for k2, v2 in _flat(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_trees_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)


def _with_lists(tree):
    """A model tree plus list nodes (U-Net-style stacks), 12 long so numeric
    order differs from lexicographic."""
    return {**tree, "down": [{"kernel": np.full((2, 2), i, np.float32)} for i in range(12)]}


def test_jax_saved_checkpoint_loads_in_the_port(tmp_path):
    cfg = MangaOCRConfig.tiny()
    params = _with_lists(jax.tree.map(np.asarray, jmdl.init_params(cfg, jax.random.PRNGKey(1))))
    jck.save_checkpoint(str(tmp_path), params, cfg)
    loaded, tcfg = tck.load_checkpoint(str(tmp_path), device="cpu")
    assert tcfg == port_config(cfg)
    assert isinstance(loaded["down"], list) and len(loaded["down"]) == 12
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in _flat(loaded).values())
    _assert_trees_equal(loaded, params)


def test_port_saved_checkpoint_loads_in_jax(tmp_path):
    cfg = MangaOCRConfig.tiny()
    params = _with_lists(params_from_jax(init_params_numpy(cfg, 2), "cpu"))
    tck.save_checkpoint(str(tmp_path), params, port_config(cfg))
    loaded, jcfg = jck.load_checkpoint(str(tmp_path))
    assert jcfg == cfg
    assert isinstance(loaded["down"], list) and len(loaded["down"]) == 12
    _assert_trees_equal(loaded, params)
    for i, leaf in enumerate(loaded["down"]):
        assert float(np.asarray(leaf["kernel"])[0, 0]) == float(i)


def test_port_roundtrip_keeps_integers_and_widens_bf16(tmp_path):
    """int8 weights come back as int8 whatever ``dtype``; bf16 leaves are
    saved as f32 (lossless) and floating leaves load in ``dtype``."""
    cfg = MangaOCRConfig.tiny()
    raw = params_from_jax(init_params_numpy(cfg, 3), "cpu")
    params = {"encoder": quantize_encoder(raw["encoder"], quantize_attn_proj=True),
              "decoder": {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) else v
                          for k, v in raw["decoder"].items()}}
    tck.save_checkpoint(str(tmp_path), params, port_config(cfg))
    with np.load(tmp_path / tck.WEIGHTS) as data:
        assert data["decoder/tok_embed"].dtype == np.float32
        assert data["encoder/layers/mlp/fc1/w_q"].dtype == np.int8
    loaded, _ = tck.load_checkpoint(str(tmp_path), dtype=torch.bfloat16, device="cpu")
    flat, want = _flat(loaded), _flat(params)
    for k, w in want.items():
        if w.is_floating_point():
            assert flat[k].dtype == torch.bfloat16, k
            assert torch.equal(flat[k], w.to(torch.bfloat16)), k
        else:
            assert flat[k].dtype == w.dtype and torch.equal(flat[k], w), k


def test_committed_seed0_checkpoint_equals_jax_prng_init():
    cfg = MangaOCRConfig.tiny()
    want = jax.tree.map(np.asarray, jmdl.init_params(cfg, jax.random.PRNGKey(0)))
    loaded, tcfg = tck.load_checkpoint(SEED0, device="cpu")
    assert tcfg == port_config(cfg)
    _assert_trees_equal(loaded, want)
    jloaded, jcfg = jck.load_checkpoint(SEED0)
    assert jcfg == cfg
    _assert_trees_equal(jloaded, want)


def test_load_on_cuda_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tck.load_checkpoint(SEED0, device="cuda")
