"""The port's training (``manga_ocr_tpu_torch/train.py`` and the teacher-
forced ``decoder.forward_full``) against the JAX package's, on the tiny
config with the same numpy-made weights and inputs, on the CPU:

- ``forward_full`` with and without a key mask: logits within 1e-5;
- ``loss_fn`` within 1e-5 relative, and every leaf of its gradient within
  1e-4 of the largest |jax.grad| of that leaf (+ 1e-7);
- ``make_lr_schedule`` against optax's warmup-cosine schedule, 1e-7
  relative at two warmups; at the command line's and the function's
  defaults 4e-7 (XLA's f32 cosine is not correctly rounded: over 500 and
  20000 steps a few steps lie one f32 ulp of the cosine off the port's,
  which rounds the double cosine once);
- three AdamW steps against JAX's jitted optax step on one batch: losses
  within 1e-5 relative, params within 1e-5 on >= 99.9% of each leaf and
  within 3 lr everywhere (Adam turns a gradient within summation noise of 0
  into a step of either sign);
- train-state files: JAX's two steps resumed by the port, the port's two
  resumed by JAX, each third step held as above;
- the data pipeline's first batches byte for byte against JAX's;
- the JAX package's convergence tests mirrored: the tiny overfit, the loop's
  checkpoint resume, the command line (``--device cpu``; the default
  ``cuda`` raises here), ``--export-hf`` read back by both packages'
  loaders into equal trees, the fine-tune start bit for bit; and the
  refusal of a config that names an encoder kernel."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from manga_ocr_tpu import train as jtr
from manga_ocr_tpu.models import checkpoint as jck
from manga_ocr_tpu.models import decoder as jdec
from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models.config import MangaOCRConfig as JaxConfig
from manga_ocr_tpu.models.convert import load_hf_checkpoint as jax_load_hf
from manga_ocr_tpu.models.tokenizer import CharTokenizer as JaxTokenizer
from manga_ocr_tpu_torch import train as ttr
from manga_ocr_tpu_torch.models import decoder as tdec
from manga_ocr_tpu_torch.models.config import with_serving_kernels
from manga_ocr_tpu_torch.models.convert import load_hf_checkpoint
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = JaxConfig.tiny()
TCFG = port_config(JCFG)
LOGITS_ATOL = 1e-5
LOSS_REL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
STEP_ATOL, STEP_SHARE = 1e-5, 0.999
SCHED_REL = 1e-7
PEAK_LR, WARMUP, DECAY = 1e-3, 1, 10  # steps 0, 1, 2 run at lr 0, 1e-3, cos


def _inputs(seed: int = 1):
    """Pixels, tokens (BOS first, EOS in row 0), a loss mask with padding and
    a key mask, batch 3, sequence 9."""
    rng = np.random.default_rng(seed)
    img = JCFG.encoder.image_size
    px = rng.normal(size=(3, img, img, 3)).astype(np.float32)
    toks = rng.integers(4, JCFG.decoder.vocab_size, size=(3, 9)).astype(np.int32)
    toks[:, 0] = JCFG.decoder.bos_token_id
    toks[0, -1] = JCFG.decoder.eos_token_id
    loss_mask = np.ones((3, 9), np.float32)
    loss_mask[2, 5:] = 0.0
    key_mask = np.ones((3, 9), np.int32)
    key_mask[1, 6:] = 0
    return px, toks, loss_mask, key_mask


def _jax_batch(px, toks, mask):
    return jtr.TrainBatch(jnp.asarray(px), jnp.asarray(toks), jnp.asarray(mask))


def _port_batch(px, toks, mask):
    return ttr.TrainBatch(torch.from_numpy(px), torch.from_numpy(toks), torch.from_numpy(mask))


def _np_tree(tree) -> dict:
    """A parameter tree of either package as {leaf path: f32 numpy array}."""
    return jck._flatten(jax.tree.map(lambda x: np.asarray(x.detach() if isinstance(
        x, torch.Tensor) else x, np.float32), tree))


def _assert_step_close(got: dict, want: dict, lr: float):
    assert sorted(got) == sorted(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 3 * lr, (k, diff.max())
        share = float((diff <= STEP_ATOL).mean())
        assert share >= STEP_SHARE, (k, share, diff.max())


# -- JAX references, computed once ---------------------------------------------


@jax.jit
def _jax_forward(params, px, toks, key_mask):
    enc = jmdl.encode(params, px, JCFG)
    return (enc, jdec.forward_full(params["decoder"], toks, enc, JCFG.decoder),
            jdec.forward_full(params["decoder"], toks, enc, JCFG.decoder, key_mask))


_jax_loss_grad = jax.jit(jax.value_and_grad(lambda p, batch: jtr.loss_fn(p, batch, JCFG)))


@pytest.fixture(scope="module", params=[0.02, 0.1], ids=["std0.02", "std0.1"])
def grads_ref(request):
    """JAX's forward_full logits (no mask, key mask), loss and gradient on
    numpy weights of the given std."""
    tree = init_params_numpy(TCFG, 0, request.param)
    px, toks, loss_mask, key_mask = _inputs()
    jp = jax.tree.map(jnp.asarray, tree)
    enc, causal, masked = _jax_forward(jp, jnp.asarray(px), jnp.asarray(toks),
                                       jnp.asarray(key_mask))
    logits = {"causal": np.asarray(causal), "key_mask": np.asarray(masked)}
    loss, grads = _jax_loss_grad(jp, _jax_batch(px, toks, loss_mask))
    return {"tree": tree, "enc": np.array(enc), "logits": logits, "loss": float(loss),
            "grads": _np_tree(grads)}


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """JAX's jitted optax step (warmup-cosine schedule) from the std-0.02
    numpy weights: params and loss after each of 3 steps on one batch, the
    train state after 2 saved by JAX's ``save_train_state``, and the step
    function (reused: one compile)."""
    tree = init_params_numpy(TCFG, 0, 0.02)
    px, toks, loss_mask, _ = _inputs(2)
    opt = optax.adamw(jtr.make_lr_schedule(PEAK_LR, WARMUP, DECAY), weight_decay=0.01)
    params = jax.tree.map(jnp.asarray, tree)
    opt_state = opt.init(params)
    step = jtr.make_train_step(JCFG, opt)
    batch = _jax_batch(px, toks, loss_mask)
    saved = str(tmp_path_factory.mktemp("jax_state"))
    out = []
    for i in range(3):
        params, opt_state, loss = step(params, opt_state, batch)
        out.append((_np_tree(params), float(loss)))
        if i == 1:
            jtr.save_train_state(saved, params, opt_state, 2, JCFG)
    return {"tree": tree, "batch": (px, toks, loss_mask), "steps": out, "saved": saved,
            "opt": opt, "step": step}


# -- forward_full, loss and gradient -------------------------------------------


@pytest.mark.parametrize("masked", [False, True], ids=["causal", "key_mask"])
def test_forward_full_matches_jax(grads_ref, masked):
    px, toks, _, key_mask = _inputs()
    p = params_from_jax(grads_ref["tree"], "cpu")
    got = tdec.forward_full(p["decoder"], torch.from_numpy(toks),
                            torch.from_numpy(grads_ref["enc"]), TCFG.decoder,
                            torch.from_numpy(key_mask) if masked else None)
    want = grads_ref["logits"]["key_mask" if masked else "causal"]
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (3, 9, 100)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGITS_ATOL)


def test_loss_and_every_gradient_leaf_match_jax(grads_ref):
    px, toks, loss_mask, _ = _inputs()
    params = ttr._as_trainable(params_from_jax(grads_ref["tree"], "cpu"), "cpu")
    loss = ttr.loss_fn(params, _port_batch(px, toks, loss_mask), TCFG)
    loss.backward()
    assert abs(loss.item() - grads_ref["loss"]) <= LOSS_REL * abs(grads_ref["loss"])
    leaves = dict(ttr._leaves(params))
    assert sorted(leaves) == sorted(grads_ref["grads"])
    for name, want in grads_ref["grads"].items():
        got = leaves[name].grad.numpy()
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(got - want).max() <= bound, (name, np.abs(got - want).max(), bound)


def test_a_config_naming_an_encoder_kernel_is_refused():
    px, toks, loss_mask, _ = _inputs()
    params = params_from_jax(init_params_numpy(TCFG, 0), "cpu")
    mlp_only = dataclasses.replace(TCFG, encoder=dataclasses.replace(TCFG.encoder,
                                                                     mlp_kernel="fused"))
    for cfg, flag in ((with_serving_kernels(TCFG, quantized=True), "attn_kernel"),
                      (mlp_only, "mlp_kernel")):
        with pytest.raises(ValueError, match=flag):
            ttr.loss_fn(params, _port_batch(px, toks, loss_mask), cfg)


# -- the schedule and the optimizer ----------------------------------------------


@pytest.mark.parametrize("peak,warmup,decay,rel", [
    (1e-4, 5, 30, SCHED_REL),  # chip_smoke.py's training run
    (3e-3, 0, 200, SCHED_REL),  # no warmup: the cosine from step 0
    (1e-4, 100, 500, 4e-7),  # the command line's defaults
    (1e-4, 500, 20_000, 4e-7),  # make_lr_schedule's defaults
], ids=["warmup5", "warmup0", "cli", "long"])
def test_lr_schedule_matches_optax(peak, warmup, decay, rel):
    want = np.asarray(jtr.make_lr_schedule(peak, warmup, decay)(jnp.arange(decay + 5)), np.float64)
    sched = ttr.make_lr_schedule(peak, warmup, decay)
    got = np.array([sched(i) for i in range(decay + 5)])
    assert got[0] == want[0] == (0.0 if warmup else np.float32(peak))
    np.testing.assert_allclose(got, want, rtol=rel, atol=0)


def test_three_adamw_steps_match_optax(jax_steps):
    opt = ttr.make_optimizer(ttr.make_lr_schedule(PEAK_LR, WARMUP, DECAY))
    params, opt_state = ttr.init_train_state(TCFG, opt, device="cpu",
                                             init_params=params_from_jax(jax_steps["tree"], "cpu"))
    step = ttr.make_train_step(TCFG)
    batch = _port_batch(*jax_steps["batch"])
    before = _np_tree(params)
    for i, (want_params, want_loss) in enumerate(jax_steps["steps"]):
        params, opt_state, loss = step(params, opt_state, batch)
        assert not loss.requires_grad
        assert abs(loss.item() - want_loss) <= LOSS_REL * abs(want_loss), (i, loss.item(), want_loss)
        got = _np_tree(params)
        if i == 0:  # lr 0: neither the update nor the decay moves a weight
            assert all(np.array_equal(got[k], before[k]) for k in got)
        _assert_step_close(got, want_params, PEAK_LR)
    assert opt_state.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jtr.make_lr_schedule(PEAK_LR, WARMUP, DECAY)(3)), rel=SCHED_REL)


def test_port_resumes_jax_train_state(jax_steps):
    params, opt_state, step, cfg = ttr.load_train_state(
        jax_steps["saved"], ttr.make_optimizer(ttr.make_lr_schedule(PEAK_LR, WARMUP, DECAY)),
        device="cpu")
    assert step == 2 and cfg == TCFG
    assert opt_state.scheduler.last_epoch == 2
    assert all(int(s["step"]) == 2 for s in opt_state.optimizer.state.values())
    params, _, loss = ttr.make_train_step(cfg)(params, opt_state, _port_batch(*jax_steps["batch"]))
    want_params, want_loss = jax_steps["steps"][2]
    assert abs(loss.item() - want_loss) <= LOSS_REL * abs(want_loss)
    _assert_step_close(_np_tree(params), want_params, PEAK_LR)


def test_jax_resumes_port_train_state(jax_steps, tmp_path):
    opt = ttr.make_optimizer(ttr.make_lr_schedule(PEAK_LR, WARMUP, DECAY))
    params, opt_state = ttr.init_train_state(TCFG, opt, device="cpu",
                                             init_params=params_from_jax(jax_steps["tree"], "cpu"))
    step = ttr.make_train_step(TCFG)
    batch = _port_batch(*jax_steps["batch"])
    for _ in range(2):
        params, opt_state, _ = step(params, opt_state, batch)
    ttr.save_train_state(str(tmp_path), params, opt_state, 2, TCFG)
    with np.load(tmp_path / "opt_state.npz") as saved, np.load(
            os.path.join(jax_steps["saved"], "opt_state.npz")) as jax_saved:
        assert sorted(saved.files) == sorted(jax_saved.files)
        assert saved["/0/0"].dtype == jax_saved["/0/0"].dtype and int(saved["/2/0"]) == 2
    jparams, jstate, jstep, jcfg = jtr.load_train_state(str(tmp_path), jax_steps["opt"])
    assert jstep == 2 and jcfg == JCFG
    jparams, _, jloss = jax_steps["step"](jparams, jstate, _jax_batch(*jax_steps["batch"]))
    params, _, loss = step(params, opt_state, batch)
    assert abs(float(jloss) - loss.item()) <= LOSS_REL * abs(loss.item())
    _assert_step_close(_np_tree(jparams), _np_tree(params), PEAK_LR)


# -- the data pipeline -------------------------------------------------------------


def _assert_batches_equal(got, want, n=3):
    for _ in range(n):
        g, w = next(got), next(want)
        for gt, wt in zip(g, w):
            wt = np.asarray(wt)
            assert gt.numpy().dtype == wt.dtype and gt.numpy().tobytes() == wt.tobytes()


def test_synthetic_dataset_batches_equal_jax():
    _assert_batches_equal(ttr.synthetic_dataset(TCFG, CharTokenizer.synthetic(), 4, 8, seed=3),
                          jtr.synthetic_dataset(JCFG, JaxTokenizer.synthetic(), 4, 8, seed=3))


def test_directory_dataset_batches_equal_jax(tmp_path):
    src = os.path.join(REPO, "tests", "fixtures", "eval")
    for name in sorted(os.listdir(src))[:12]:  # six (png, txt) pairs
        (tmp_path / name).write_bytes(open(os.path.join(src, name), "rb").read())
    (tmp_path / "extra.png").write_bytes(b"")  # no txt: skipped by both
    _assert_batches_equal(
        ttr.directory_dataset(str(tmp_path), TCFG, CharTokenizer.synthetic(), 4, 8, seed=1),
        jtr.directory_dataset(str(tmp_path), JCFG, JaxTokenizer.synthetic(), 4, 8, seed=1))
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match="no \\(image, txt\\) pairs"):
        next(ttr.directory_dataset(str(empty), TCFG, CharTokenizer.synthetic(), 1, 8))


def test_prefetcher_hands_on_a_source_error():
    def source():
        yield 1
        raise OSError("disk gone")

    it = ttr.Prefetcher(source())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    it.close()


# -- the JAX convergence tests, mirrored ---------------------------------------------


def test_overfit_tiny_batch():
    opt = ttr.make_optimizer(lr=3e-3)
    params, opt_state = ttr.init_train_state(TCFG, opt, 0, "cpu")
    step = ttr.make_train_step(TCFG)
    rng = np.random.default_rng(0)
    img = TCFG.encoder.image_size
    tokens = rng.integers(4, TCFG.decoder.vocab_size, size=(4, 10)).astype(np.int32)
    tokens[:, 0] = TCFG.decoder.bos_token_id
    tokens[:, -1] = TCFG.decoder.eos_token_id
    batch = _port_batch(rng.normal(size=(4, img, img, 3)).astype(np.float32), tokens,
                        np.ones((4, 10), np.float32))
    losses = []
    for _ in range(25):
        params, opt_state, loss = step(params, opt_state, batch)
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.5, losses


def test_train_loop_with_checkpoint_resume(tmp_path):
    data = ttr.synthetic_dataset(TCFG, CharTokenizer.synthetic(), batch_size=4, seq_len=8, seed=0)
    ckpt = str(tmp_path / "ckpt")
    params, losses = ttr.train(TCFG, data, steps=4, checkpoint_dir=ckpt, checkpoint_every=2,
                               log_every=1, device="cpu")
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert os.path.exists(os.path.join(ckpt, "train_state.json"))
    assert os.path.exists(os.path.join(ckpt, "opt_state.npz"))
    opt = ttr.make_optimizer(ttr.make_lr_schedule(1e-4, 100, 200))
    params2, opt_state2, step, cfg2 = ttr.load_train_state(ckpt, opt, device="cpu")
    assert step == 4 and cfg2 == TCFG
    got, want = _np_tree(params2), _np_tree(params)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    params3, losses3 = ttr.train(TCFG, data, steps=6, checkpoint_dir=ckpt, resume=True,
                                 log_every=1, device="cpu")
    assert len(losses3) == 2  # only steps 5..6 ran
    with open(os.path.join(ckpt, "train_state.json")) as f:
        assert json.load(f)["step"] == 6


def test_train_cli_smoke(tmp_path, capsys):
    rc = ttr.main(["--config", "tiny", "--steps", "4", "--batch-size", "2", "--seq-len", "8",
                   "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "4",
                   "--warmup-steps", "1", "--device", "cpu"])
    assert rc == 0
    assert (tmp_path / "train_state.json").exists()
    assert "log[0] loss=" in capsys.readouterr().out


def test_train_cli_needs_cuda_unless_told_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        ttr.main(["--config", "tiny", "--steps", "1", "--checkpoint-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
    # on a (2 data x 2 model) virtual CPU mesh the command line trains and
    # writes its state, which JAX's loader reads
    mesh_dir = tmp_path / "mesh"
    assert ttr.main(["--config", "tiny", "--steps", "2", "--batch-size", "4", "--seq-len", "8",
                     "--warmup-steps", "1", "--mesh-data", "2", "--mesh-model", "2",
                     "--checkpoint-dir", str(mesh_dir), "--device", "cpu"]) == 0
    _, _, step, jcfg = jtr.load_train_state(str(mesh_dir), jtr.make_optimizer())
    assert step == 2 and port_config(jcfg) == TCFG


def test_train_cli_export_hf_reads_back_in_both_packages(tmp_path, capsys):
    out = tmp_path / "hf"
    rc = ttr.main(["--config", "tiny", "--steps", "2", "--batch-size", "2", "--seq-len", "8",
                   "--warmup-steps", "1", "--export-hf", str(out), "--device", "cpu"])
    assert rc == 0
    assert f"exported HF-format checkpoint to {out}" in capsys.readouterr().out
    for name in ("model.safetensors", "config.json", "vocab.txt"):
        assert (out / name).exists()
    got, cfg = load_hf_checkpoint(str(out))
    want, jcfg = jax_load_hf(str(out))
    assert cfg == port_config(jcfg)
    g, w = _np_tree(got), _np_tree(want)
    assert sorted(g) == sorted(w) and all(np.array_equal(g[k], w[k]) for k in w)
    assert CharTokenizer.from_vocab_file(str(out / "vocab.txt")).id_to_token == \
        CharTokenizer.synthetic().id_to_token


def test_init_params_seed_finetune():
    opt = ttr.make_optimizer(lr=1e-3)
    seed_params = ttr.init_train_state(TCFG, opt, 7, "cpu")[0]
    params, _ = ttr.init_train_state(TCFG, opt, 0, "cpu", init_params=seed_params)
    got, want = _np_tree(params), _np_tree(seed_params)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    leaf = params["decoder"]["tok_embed"]
    assert leaf.requires_grad and leaf.data_ptr() != seed_params["decoder"]["tok_embed"].data_ptr()
