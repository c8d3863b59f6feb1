"""``scripts/torch_closed_loop_fullsize.py`` (the port of
``scripts/closed_loop_fullsize.py``) on the CPU, against the JAX package:

- ``clip_by_global_norm`` against optax's on the same numpy gradients,
  below and above the threshold (below: the gradients unchanged, bit for
  bit);
- two clipped AdamW steps of the script's optimizer and step against JAX's
  ``optax.chain(clip_by_global_norm(max_norm), make_optimizer(schedule))``
  on the tiny config's numpy weights, with the threshold under the
  gradients' global norm (clipped, the script's 1.0) and over it: losses
  within 1e-5 relative, the port's clipped gradients of the first step
  within 1e-4 of each leaf's largest |g| of optax's clip of JAX's, params
  as ``tests/test_torch_train.py`` holds one AdamW step (1e-5 on 99.9% of
  each leaf, 3 lr everywhere).  The first step runs at lr 0 (the warmup),
  so the second's moments carry both steps' clip scales;
- the held-out texts and crops (seed 9999) and the render process's
  stream byte for byte against JAX's code on ``manga_ocr_tpu.train``'s
  ``render_text_crop`` (JAX's script is not imported: it enables a
  persistent compile cache when imported);
- the script's ``run`` at the tiny config (its vocabulary widened to the
  script's kana ids) for 3 steps: the summary's keys, the render process
  and its thread stopped, the checkpoint loaded by both packages into equal
  trees, and a second run reusing it; ``main`` keeps JAX's command line
  and runs ``base()``;
- the script imports nothing of JAX (a subprocess reads ``sys.modules``)."""

import multiprocessing
import os
import subprocess
import sys
import textwrap
import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from manga_ocr_tpu import train as jtr
from manga_ocr_tpu.models import checkpoint as jck
from manga_ocr_tpu.models.config import MangaOCRConfig as JaxConfig
from manga_ocr_tpu.models.tokenizer import CharTokenizer as JaxTokenizer
from manga_ocr_tpu_torch import train as ttr
from manga_ocr_tpu_torch.models import checkpoint as tck
from manga_ocr_tpu_torch.models.config import MangaOCRConfig as TorchConfig
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import torch_closed_loop_fullsize as cl  # noqa: E402

JCFG = JaxConfig.tiny()
TCFG = port_config(JCFG)
PEAK_LR, STEPS = 1e-3, 8  # the script's schedule: warmup min(1500, 8 // 8) = 1 step
LOSS_REL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
STEP_ATOL, STEP_SHARE = 1e-5, 0.999
CLIP_REL = 1e-6


def _batch(seed: int):
    """Pixels, tokens (BOS first, EOS in row 0) and a loss mask with padding:
    batch 3, sequence 9."""
    rng = np.random.default_rng(seed)
    img = JCFG.encoder.image_size
    px = rng.normal(size=(3, img, img, 3)).astype(np.float32)
    toks = rng.integers(4, JCFG.decoder.vocab_size, size=(3, 9)).astype(np.int32)
    toks[:, 0] = JCFG.decoder.bos_token_id
    toks[0, -1] = JCFG.decoder.eos_token_id
    mask = np.ones((3, 9), np.float32)
    mask[2, 5:] = 0.0
    return px, toks, mask


def _np_tree(tree) -> dict:
    return jck._flatten(jax.tree.map(lambda x: np.asarray(x.detach() if isinstance(
        x, torch.Tensor) else x, np.float32), tree))


# -- the clip ----------------------------------------------------------------------


@pytest.mark.parametrize("max_norm", [100.0, 1.0], ids=["below", "above"])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(5)
    leaves = [rng.normal(size=s).astype(np.float32) for s in ((7, 3), (11,), (2, 4, 5))]
    want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(a) for a in leaves], None)
    got = [torch.from_numpy(a.copy()) for a in leaves]
    norm = cl.clip_by_global_norm(got, max_norm)
    assert abs(norm.item() - float(optax.global_norm(leaves))) <= CLIP_REL * norm.item()
    for g, w, a in zip(got, want, leaves):
        if max_norm > norm.item():
            assert np.array_equal(g.numpy(), a)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=CLIP_REL, atol=0)


# -- two clipped steps against optax ---------------------------------------------


def _jax_opt(max_norm):
    return optax.chain(optax.clip_by_global_norm(max_norm), jtr.make_optimizer(
        lr=jtr.make_lr_schedule(peak_lr=PEAK_LR, warmup_steps=min(1500, STEPS // 8),
                                decay_steps=STEPS)))


@jax.jit
def _jax_step(params, state, batch, max_norm):
    """JAX's train step under ``_jax_opt(max_norm)`` (the threshold traced:
    one compile for both), with optax's clip of the step's gradients and
    their global norm."""
    loss, grads = jax.value_and_grad(lambda p: jtr.loss_fn(p, batch, JCFG))(params)
    updates, state = _jax_opt(max_norm).update(grads, state, params)
    clipped, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
    return optax.apply_updates(params, updates), state, loss, clipped, optax.global_norm(grads)


@pytest.fixture(scope="module")
def jax_runs():
    """Per threshold: JAX's losses and params after each of two steps (batches
    of seeds 1 and 2), optax's clip of the first step's gradients and their
    global norm."""
    tree = init_params_numpy(TCFG, 0, 0.02)
    batches = [jtr.TrainBatch(*map(jnp.asarray, _batch(s))) for s in (1, 2)]
    out = {"tree": tree}
    for max_norm in (1.0, 10.0):
        params = jax.tree.map(jnp.asarray, tree)
        state = _jax_opt(max_norm).init(params)
        steps = []
        for i, b in enumerate(batches):
            params, state, loss, clipped, norm = _jax_step(params, state, b,
                                                           jnp.float32(max_norm))
            steps.append((_np_tree(params), float(loss)))
            if i == 0:
                out[max_norm] = {"clipped": _np_tree(clipped)}
                out["norm"] = float(norm)
        out[max_norm]["steps"] = steps
    return out


@pytest.mark.parametrize("max_norm", [1.0, 10.0], ids=["clipped", "unclipped"])
def test_clipped_steps_match_optax(jax_runs, max_norm):
    assert (jax_runs["norm"] > max_norm) == (max_norm == 1.0)  # the regime the id names
    want = jax_runs[max_norm]
    params, opt_state = ttr.init_train_state(
        TCFG, cl.make_optimizer(PEAK_LR, STEPS), device="cpu",
        init_params=params_from_jax(jax_runs["tree"], "cpu"))
    # the clip on the first step's gradients, beside optax's on JAX's
    probe = ttr._as_trainable(params_from_jax(jax_runs["tree"], "cpu"), "cpu")
    ttr.loss_fn(probe, ttr.TrainBatch(*map(torch.from_numpy, _batch(1))), TCFG).backward()
    leaves = ttr._leaves(probe)
    cl.clip_by_global_norm([p.grad for _, p in leaves], max_norm)
    for name, p in leaves:
        w = want["clipped"][name]
        bound = GRAD_REL * np.abs(w).max() + GRAD_ATOL
        assert np.abs(p.grad.numpy() - w).max() <= bound, name
    step = cl.make_train_step(TCFG, max_norm)
    before = _np_tree(params)
    for i, (seed, (want_params, want_loss)) in enumerate(zip((1, 2), want["steps"])):
        batch = ttr.TrainBatch(*map(torch.from_numpy, _batch(seed)))
        params, opt_state, loss = step(params, opt_state, batch)
        assert abs(loss.item() - want_loss) <= LOSS_REL * abs(want_loss), (i, loss.item())
        got = _np_tree(params)
        if i == 0:  # the warmup's lr 0
            assert all(np.array_equal(got[k], before[k]) for k in got)
        for k, w in want_params.items():
            diff = np.abs(got[k] - w)
            assert diff.max() <= 3 * PEAK_LR, (k, diff.max())
            assert float((diff <= STEP_ATOL).mean()) >= STEP_SHARE, (k, diff.max())


# -- the data ------------------------------------------------------------------------


def _jax_stream(n: int, seed: int):
    """JAX's script's ``_sample_text`` + ``_render`` (texts, crops, ids) on
    ``manga_ocr_tpu.train.render_text_crop``."""
    tok = JaxTokenizer.synthetic()
    chars = [t for t in tok.id_to_token[4:150] if len(t) == 1]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        text = "".join(rng.choice(chars) for _ in range(int(rng.integers(1, 19))))
        h, w = int(rng.integers(176, 225)), int(rng.integers(104, 161))
        out.append((text, jtr.render_text_crop(text, rng, 224, hw=(h, w)),
                    tok.encode(text)[:24]))
    return out


def test_heldout_texts_and_crops_equal_jax():
    refs, crops = cl.heldout(CharTokenizer.synthetic(), 64)
    want = _jax_stream(64, 9999)
    assert refs == [t for t, _, _ in want]
    for got, (_, w, _) in zip(crops, want):
        assert got.dtype == w.dtype and got.shape == w.shape and got.tobytes() == w.tobytes()


class _Chunks:
    def __init__(self):
        self.items = []

    def put(self, item):
        self.items.append(item)


def test_render_stream_equals_jax():
    out = _Chunks()
    tok = CharTokenizer.synthetic()
    cl._produce(tok, cl._chars(tok), 1, 40, out, threading.Event())
    assert out.items[-1] is None and [len(c) for c in out.items[:-1]] == [32, 8]
    got = [item for chunk in out.items[:-1] for item in chunk]
    for (crop, ids), (_, w, wids) in zip(got, _jax_stream(40, 1)):
        assert crop.tobytes() == np.ascontiguousarray(w[..., 0]).tobytes()
        assert (w == w[..., :1]).all() and ids == wids


# -- the script end to end at the tiny config ----------------------------------------------


RUN_JCFG = JaxConfig.tiny(vocab_size=150)  # ids 4-149: the script's kana
RUN_TCFG = port_config(RUN_JCFG)


def _run(ckpt: str) -> dict:
    # the tiny config's 32 positions cap the budget
    return cl.run(RUN_TCFG, CharTokenizer.synthetic(), steps=3, batch=2, eval_n=4, tp_batch=4,
                  ckpt_dir=ckpt, device="cpu", max_length=24, iters=1, passes=1, pool_min=8)


def test_tiny_run_end_to_end(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    summary = _run(ckpt)
    assert sorted(summary) == sorted([
        "train", "exact_fused_int8", "cer_fused_int8", "exact_xla_bf16", "cer_xla_bf16",
        "fused_vs_xla_agree", "crops_per_s_budget300_trained", "crops_per_s_budget32",
        "len_median", "eval_n"])
    info = summary["train"]
    assert info["steps"] == 3 and np.isfinite(info["final_loss"]) and 0 <= info["host_share"] < 1
    assert summary["eval_n"] == 4 and 0 < summary["len_median"] <= 24
    assert not [t.name for t in threading.enumerate() if t.name.startswith("render-pool")]
    assert not [p.name for p in multiprocessing.active_children() if p.name == "render-pool"]
    tparams, tcfg = tck.load_checkpoint(ckpt, device="cpu")
    jparams, jcfg = jck.load_checkpoint(ckpt)
    assert tcfg == RUN_TCFG and jcfg == RUN_JCFG
    got, want = _np_tree(tparams), _np_tree(jparams)
    assert sorted(got) == sorted(want) and all(np.array_equal(got[k], want[k]) for k in got)
    assert _run(ckpt)["train"] == {"reused": True}


def test_main_keeps_jax_command_line(monkeypatch):
    seen = {}
    monkeypatch.setattr(cl, "run", lambda *a: seen.setdefault("args", a))
    cl.main(["--steps", "30000", "--batch", "32", "--peak-lr", "2e-4", "--eval-n", "256",
             "--tp-batch", "256", "--ckpt", "ck", "--device", "cpu"])
    cfg, tok, *rest = seen["args"]
    assert cfg == TorchConfig.base() and len(tok.id_to_token) == len(
        CharTokenizer.synthetic().id_to_token)
    assert rest == [30000, 32, 2e-4, 256, 256, "ck", "cpu"]
    with pytest.raises(SystemExit):  # the loop's sizes below base() are ``run``'s
        cl.main(["--max-length", "24"])


def test_script_imports_nothing_of_jax():
    script = textwrap.dedent(
        """
        import sys
        sys.path.insert(0, "scripts")
        import torch_closed_loop_fullsize
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "manga_ocr_tpu", "optax"))
        print("LOADED", bad)
        """
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout, out.stdout
