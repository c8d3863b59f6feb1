"""The port's Latin recognizer training (``manga_ocr_tpu_torch/train_latin.py``
and ``crnn_forward(..., grad=True)``) against the JAX package's, on a tiny
CRNN (11 classes: digits + blank, output 32, hidden 16) with the same numpy
weights (``params_from_jax``) and batches, on the CPU:

- ``ctc_loss`` against ``optax.ctc_loss`` per sequence within 1e-5
  relative (and its gradient), including a row that cannot be aligned
  (finite, optax's value, where ``F.ctc_loss`` gives inf), and against
  ``F.ctc_loss`` on the rows that can be aligned;
- the batch loss within 1e-5 relative and every gradient leaf within 1e-4
  of that leaf's max |g| (+ 1e-7) of ``jax.value_and_grad(ctc_loss_fn)``,
  on an aligned batch and on one with a row that cannot be aligned;
- three ``optax.adamw(1e-3)`` steps (decay 1e-4) against JAX's jitted
  ``make_ctc_train_step``: losses within 1e-5 relative, params within 1e-5
  of each leaf's max |p| (+ 1e-5 lr), except where JAX's gradient lies
  within the gradient check's own bound of 0: there Adam's normalised step
  ``m / (sqrt(v) + 1e-8)`` turns summation noise into a step of either
  sign, held to lr/10; the optimizer holds the tree's leaves only and the
  trained tree still reads as the inference forward (whose ``nn.LSTM`` has
  a zero ``bias_hh``); the optimizer alone, fed JAX's gradient, against
  ``optax.adamw`` and ``optax.adam`` within 1e-5 of each leaf's max |p|;
- ``render_line`` and both datasets byte for byte (images transposed),
  the directory dataset's skips, pad value and errors, ``_check_ctc_frames``;
- checkpoint directories both ways, file for file, with the logits of the
  loaded trees within 1e-5;
- ``main --device cpu``: the ``--init`` conflicts, a ``.pth`` init (its
  first loss against JAX's ``main`` on the same file), a native ``--init``
  resume, ``--save-every``; ``cuda`` raises here;
- ``TorchLatinEngine.from_checkpoints`` and the registry's ``"Latin (TPU)"``
  factory on a trained directory;
- (``-m slow``) the JAX package's closed loop (``test_latin_closed_loop.py``)
  in the port, from ``tests/fixtures/latin_closed_loop_init`` -- JAX's
  ``PRNGKey(0)`` init, checked here; from the port's numpy seed 0 the loss
  is still ~4.5 after the 2000 steps.
Twins come from the JAX tests' module (``import test_latin_ocr``), built on
the meta device and filled from a ``torch.Generator``; torch's global RNG
is never drawn."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import test_latin_ocr as jtwin  # noqa: E402  (the JAX tests' CRAFT and CRNN twins)
from manga_ocr_tpu import train_latin as jtl
from manga_ocr_tpu.engine import latin as jlatin
from manga_ocr_tpu.models import crnn as jcrnn
from manga_ocr_tpu_torch import train as ttrain
from manga_ocr_tpu_torch import train_latin as ttl
from manga_ocr_tpu_torch.engine import latin as tlatin
from manga_ocr_tpu_torch.engine.registry import make_default_registry
from manga_ocr_tpu_torch.models import crnn as tcrnn
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

CHARSET = "0123456789"
JCFG = jcrnn.CrnnConfig(num_classes=len(CHARSET) + 1, output_channel=32, hidden_size=16)
TCFG = tcrnn.CrnnConfig(num_classes=len(CHARSET) + 1, output_channel=32, hidden_size=16)
WIDTH, MAX_CHARS, BATCH = 64, 4, 4  # 15 CTC frames
UNALIGNED_N = 10  # ten equal labels need 19 frames: more than WIDTH's 15
LOSS_REL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
PARAM_REL = 1e-5
NOISE_STEP = 0.1  # of lr: an element whose gradient the gradient check cannot tell from 0
LOGITS_ATOL = 1e-5  # f32 on both sides, summation order only (test_torch_latin.py)
LR = 1e-3


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a.detach() if hasattr(a, "detach") else a), tree)


def _batches():
    """Two batches of JAX's synthetic lines (seed 5), labels padded to
    ``UNALIGNED_N``: as drawn, and with the last row's labels ten 1s, which
    no alignment over 15 frames reaches.  (images [B, H, W, 1], labels,
    paddings) as numpy."""
    b = next(jtl.synthetic_line_dataset(JCFG, CHARSET, BATCH, WIDTH, MAX_CHARS, seed=5))
    images = np.asarray(b.images)
    labels = np.zeros((BATCH, UNALIGNED_N), np.int32)
    paddings = np.ones((BATCH, UNALIGNED_N), np.float32)
    labels[:, :MAX_CHARS] = np.asarray(b.labels)
    paddings[:, :MAX_CHARS] = np.asarray(b.label_paddings)
    bad_labels, bad_paddings = labels.copy(), paddings.copy()
    bad_labels[-1], bad_paddings[-1] = 1, 0.0
    return {"aligned": (images, labels, paddings),
            "unaligned": (images, bad_labels, bad_paddings)}


def _jax_batch(images, labels, paddings):
    return jtl.CtcBatch(jnp.asarray(images), jnp.asarray(labels), jnp.asarray(paddings))


def _port_batch(images, labels, paddings):
    return ttl.CtcBatch(torch.from_numpy(images.transpose(0, 3, 1, 2).copy()),
                        torch.from_numpy(labels), torch.from_numpy(paddings))


_jax_loss_grad = jax.jit(jax.value_and_grad(jtl.ctc_loss_fn))


@pytest.fixture(scope="module")
def reference():
    """The numpy seed-0 tree, both batches, and JAX's loss and gradient on
    each (one compile: the batches share their shapes)."""
    tree = tcrnn.init_crnn_params_numpy(TCFG, 0)
    jp = jax.tree.map(jnp.asarray, tree)
    batches = _batches()
    out = {}
    for name, batch in batches.items():
        loss, grads = _jax_loss_grad(jp, _jax_batch(*batch))
        out[name] = (float(loss), _np_tree(grads))
    return {"tree": tree, "batches": batches, "grads": out}


@pytest.fixture(scope="module")
def jax_steps(reference):
    """JAX's jitted ``optax.adamw(1e-3)`` step, three times on the aligned
    batch: (params, loss) after each."""
    opt = optax.adamw(LR)
    params = jax.tree.map(jnp.asarray, reference["tree"])
    opt_state = opt.init(params)
    step = jtl.make_ctc_train_step(opt)
    batch = _jax_batch(*reference["batches"]["aligned"])
    out = []
    for _ in range(3):
        params, opt_state, loss = step(params, opt_state, batch)
        out.append((_np_tree(params), float(loss)))
    return out


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {name: leaf for k, v in tree.items()
                for name, leaf in _leaves(v, f"{prefix}/{k}" if prefix else k).items()}
    return {prefix: tree}


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    return tree.grad


# -- the CTC loss ----------------------------------------------------------------


def test_ctc_loss_matches_optax_and_torch_on_alignable_rows():
    rng = np.random.default_rng(0)
    b, t, k, n = 6, 4, 6, 3
    logits = (rng.normal(size=(b, t, k)) * 2).astype(np.float32)
    labels = rng.integers(1, k, size=(b, n)).astype(np.int32)
    paddings = np.zeros((b, n), np.float32)
    labels[0] = [1, 1, 1]  # needs 5 frames of the 4
    labels[2, 2:], paddings[2, 2:] = 0, 1.0
    labels[3, 1:], paddings[3, 1:] = 0, 1.0
    labels[4] = [2, 2, 3]  # a repeat that fits: 4 frames exactly

    @jax.jit
    def per_seq(lg):
        return optax.ctc_loss(lg, jnp.zeros((b, t)), jnp.asarray(labels), jnp.asarray(paddings))

    want = np.asarray(per_seq(jnp.asarray(logits)))
    want_grad = np.asarray(jax.grad(lambda lg: per_seq(lg).sum())(jnp.asarray(logits)))
    lt = torch.tensor(logits, requires_grad=True)
    got = ttl.ctc_loss(lt, torch.from_numpy(labels), torch.from_numpy(paddings))
    got.sum().backward()
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=LOSS_REL, atol=0)
    assert np.isfinite(got[0].item()) and got[0].item() > 1e5  # optax's floor, log_epsilon
    np.testing.assert_allclose(lt.grad.numpy(), want_grad, rtol=0,
                               atol=GRAD_REL * np.abs(want_grad).max())
    assert np.abs(lt.grad.numpy()[0]).max() > 0.1  # the unaligned row carries a gradient
    # F.ctc_loss: the same values where an alignment exists, inf where none does
    lengths = torch.from_numpy((n - paddings.sum(1)).astype(np.int64))
    ref = F.ctc_loss(torch.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1),
                     torch.from_numpy(labels).long(), torch.full((b,), t), lengths,
                     reduction="none")
    assert torch.isinf(ref[0])
    np.testing.assert_allclose(got.detach().numpy()[1:], ref.numpy()[1:], rtol=LOSS_REL)


@pytest.mark.parametrize("name", ["aligned", "unaligned"])
def test_loss_and_every_gradient_leaf_match_jax(reference, name):
    want_loss, want_grads = reference["grads"][name]
    params = ttrain._as_trainable(tcrnn.params_from_jax(reference["tree"]), "cpu")
    loss = ttl.ctc_loss_fn(params, _port_batch(*reference["batches"][name]))
    loss.backward()
    assert abs(loss.item() - want_loss) <= LOSS_REL * abs(want_loss), (loss.item(), want_loss)
    if name == "unaligned":
        assert want_loss > 1e5 / BATCH
    got = _leaves(tcrnn.params_to_jax(_grad_tree(params)))
    want = _leaves(want_grads)
    assert sorted(got) == sorted(want)
    for leaf, w in want.items():
        bound = GRAD_REL * np.abs(w).max() + GRAD_ATOL
        assert np.abs(got[leaf] - w).max() <= bound, (leaf, np.abs(got[leaf] - w).max(), bound)


def test_train_forward_equals_the_inference_forward(reference):
    x = _port_batch(*reference["batches"]["aligned"]).images
    params = ttrain._as_trainable(tcrnn.params_from_jax(reference["tree"]), "cpu")
    got = tcrnn.crnn_forward(params, x, grad=True)
    assert got.requires_grad
    want = tcrnn.crnn_forward(params, x)
    assert not want.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0, atol=1e-6)


# -- the optimizer step ------------------------------------------------------------


def test_three_adamw_steps_match_optax(reference, jax_steps):
    opt = ttrain.make_optimizer(LR, weight_decay=ttl.ADAMW_DECAY)
    params, opt_state = ttl.init_ctc_train_state(
        TCFG, opt, device="cpu", init_params=tcrnn.params_from_jax(reference["tree"]))
    step = ttl.make_ctc_train_step()
    batch = _port_batch(*reference["batches"]["aligned"])
    grads = _leaves(reference["grads"]["aligned"][1])
    noise = {leaf: np.abs(g) <= GRAD_REL * np.abs(g).max() + GRAD_ATOL
             for leaf, g in grads.items()}
    for i, (want_params, want_loss) in enumerate(jax_steps):
        params, opt_state, loss = step(params, opt_state, batch)
        assert not loss.requires_grad
        assert abs(loss.item() - want_loss) <= LOSS_REL * abs(want_loss), (i, loss.item(), want_loss)
        got, want = _leaves(tcrnn.params_to_jax(params)), _leaves(want_params)
        for leaf, w in want.items():
            gap = np.abs(got[leaf] - w)
            bound = np.where(noise[leaf], NOISE_STEP * LR, PARAM_REL * (np.abs(w).max() + LR))
            assert (gap <= bound).all(), (i, leaf, gap.max(), (gap > bound).sum())
    # bias_hh is no leaf: the optimizer holds exactly the tree's tensors, JAX's
    # leaf count, and the trained tree reads as the inference forward, whose
    # nn.LSTM takes the summed bias as bias_ih and a zero bias_hh
    held = [p for group in opt_state.optimizer.param_groups for p in group["params"]]
    assert sorted(map(id, held)) == sorted(map(id, _leaves(params).values()))
    assert len(held) == len(jax.tree.leaves(jax_steps[-1][0]))
    x = batch.images[:2]
    np.testing.assert_allclose(tcrnn.crnn_forward(params, x, grad=True).detach().numpy(),
                               tcrnn.crnn_forward(params, x).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("decay", [ttl.ADAMW_DECAY, 0.0], ids=["adamw", "adam"])
def test_the_optimizer_alone_matches_optax(reference, decay):
    """``make_optimizer(lr, weight_decay=1e-4)`` is ``optax.adamw(lr)`` and
    ``weight_decay=0.0`` is ``optax.adam(lr)``: three steps fed JAX's
    gradient move every weight as optax's do."""
    grads = reference["grads"]["aligned"][1]
    opt = optax.adamw(LR) if decay else optax.adam(LR)
    jparams = jax.tree.map(jnp.asarray, reference["tree"])
    jgrads = jax.tree.map(jnp.asarray, grads)
    state = opt.init(jparams)
    params = ttrain._as_trainable(tcrnn.params_from_jax(reference["tree"]), "cpu")
    torch_grads = _leaves(tcrnn.params_from_jax(grads))
    opt_state = ttrain.make_optimizer(LR, weight_decay=decay)(params)
    update = jax.jit(opt.update)
    for _ in range(3):
        updates, state = update(jgrads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for leaf, p in _leaves(params).items():
            p.grad = torch_grads[leaf].clone()
        opt_state.optimizer.step()
        got, want = _leaves(tcrnn.params_to_jax(params)), _leaves(_np_tree(jparams))
        for leaf, w in want.items():
            assert np.abs(got[leaf] - w).max() <= PARAM_REL * np.abs(w).max(), leaf


# -- the datasets ------------------------------------------------------------------


def _assert_batches_equal(got, want, n=3):
    for _ in range(n):
        g, w = next(got), next(want)
        images = np.asarray(w.images)
        assert g.images.numpy().tobytes() == np.ascontiguousarray(
            images.transpose(0, 3, 1, 2)).tobytes()
        assert g.images.dtype == torch.float32 and tuple(g.images.shape) == (
            images.shape[0], 1, images.shape[1], images.shape[2])
        for gt, wt in ((g.labels, w.labels), (g.label_paddings, w.label_paddings)):
            wt = np.asarray(wt)
            assert gt.numpy().dtype == wt.dtype and gt.numpy().tobytes() == wt.tobytes()


def test_render_line_equals_jax():
    for text, h, w in (("0123", 32, 64), ("9" * 12, 32, 96), ("", 32, 64), ("70", 16, 200)):
        got = ttl.render_line(text, CHARSET, h, w, None)
        want = jtl.render_line(text, CHARSET, h, w, None)
        assert got[1] == want[1] and got[0].dtype == want[0].dtype == np.uint8
        assert got[0].tobytes() == want[0].tobytes()


@pytest.mark.parametrize("width,max_chars,seed", [(WIDTH, MAX_CHARS, 3), (96, 6, 0)])
def test_synthetic_line_dataset_equals_jax(width, max_chars, seed):
    _assert_batches_equal(ttl.synthetic_line_dataset(TCFG, CHARSET, 3, width, max_chars, seed),
                          jtl.synthetic_line_dataset(JCFG, CHARSET, 3, width, max_chars, seed))


def _line_dir(path):
    from PIL import Image

    path.mkdir()
    rng = np.random.default_rng(0)
    for i, (text, hw) in enumerate([("123", (20, 60)), ("9", (40, 30)), ("0420", (24, 200)),
                                    ("56", (20, 24))]):
        Image.fromarray(rng.integers(0, 255, hw).astype(np.uint8), "L").save(path / f"{i:03d}.png")
        (path / f"{i:03d}.txt").write_text(text)
    Image.fromarray(np.zeros((20, 60), np.uint8), "L").save(path / "bad.png")
    (path / "bad.txt").write_text("xyz")  # out of the charset
    Image.fromarray(np.zeros((20, 60), np.uint8), "L").save(path / "long.jpg")
    (path / "long.txt").write_text("123456789")  # more than max_chars
    (path / "empty.txt").write_text("\n")  # no image: skipped without a line
    Image.fromarray(np.zeros((20, 60), np.uint8), "L").save(path / "blank.bmp")
    (path / "blank.txt").write_text("\n")  # empty text
    return str(path)


def test_directory_line_dataset_equals_jax(tmp_path, capsys):
    data = _line_dir(tmp_path / "lines")
    got = ttl.directory_line_dataset(data, TCFG, CHARSET, 5, 96, 6, seed=2)
    printed = capsys.readouterr().out
    want = jtl.directory_line_dataset(data, JCFG, CHARSET, 5, 96, 6, seed=2)
    assert printed == capsys.readouterr().out
    assert [line.split()[2] for line in printed.splitlines()] == ["bad", "blank", "long"]
    _assert_batches_equal(got, want)
    # the pad value is the serving distribution's -1.0 (black): the one pair
    # in the charset "56" is 24 px wide at height 20, so 38 of the 96 columns
    one = next(ttl.directory_line_dataset(data, TCFG, "56", 1, 96, 6, seed=0))
    assert (one.images[0, 0, :, 38:] == -1.0).all() and not (one.images[0, 0, :, :8] == -1.0).all()


def test_dataset_errors_match_jax(tmp_path):
    with pytest.raises(ValueError, match="no usable") as got:
        ttl.directory_line_dataset(str(tmp_path), TCFG, CHARSET, 2, 64, 4)
    with pytest.raises(ValueError) as want:
        jtl.directory_line_dataset(str(tmp_path), JCFG, CHARSET, 2, 64, 4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="CTC frames") as got:
        next(ttl.synthetic_line_dataset(TCFG, CHARSET, 1, 32, 16))
    with pytest.raises(ValueError) as want:
        jtl._check_ctc_frames(32, 16)
    assert str(got.value) == str(want.value)
    assert ttl._ctc_frames(128) == jtl._ctc_frames(128) == 31
    ttl._check_ctc_frames(68, 16)  # 16 frames for 16 labels passes, as in JAX


# -- checkpoint directories ------------------------------------------------------------


def _logits_jax(tree, x):
    return np.asarray(jcrnn.crnn_forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x)))


def test_checkpoint_directories_cross_load(reference, tmp_path):
    x = reference["batches"]["aligned"][0][:2]
    tree = reference["tree"]
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    ttl.save_crnn_checkpoint(port_dir, ttrain._as_trainable(tcrnn.params_from_jax(tree), "cpu"),
                             TCFG, CHARSET)
    jtl.save_crnn_checkpoint(jax_dir, jax.tree.map(jnp.asarray, tree), JCFG, CHARSET)
    # the same files
    for name in (ttl.MANIFEST, jtl.MANIFEST):
        assert open(os.path.join(port_dir, name), "rb").read() == \
            open(os.path.join(jax_dir, name), "rb").read()
    assert ttl.WEIGHTS == jtl.WEIGHTS
    with np.load(os.path.join(port_dir, ttl.WEIGHTS)) as a, \
            np.load(os.path.join(jax_dir, jtl.WEIGHTS)) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    # the port writes, JAX reads; JAX writes, the port reads
    jparams, jcfg, jcharset = jtl.load_crnn_checkpoint(port_dir)
    tparams, tcfg, tcharset = ttl.load_crnn_checkpoint(jax_dir, "cpu")
    assert (jcfg, jcharset) == (JCFG, CHARSET) and (tcfg, tcharset) == (TCFG, CHARSET)
    for a, b in zip(jax.tree.leaves(_np_tree(jparams)),
                    jax.tree.leaves(tcrnn.params_to_jax(tparams)), strict=True):
        np.testing.assert_array_equal(a, b)
    got = tcrnn.crnn_forward(tparams, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())).numpy()
    np.testing.assert_allclose(got, _logits_jax(jparams, x), rtol=0, atol=LOGITS_ATOL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttl.load_crnn_checkpoint(jax_dir)  # the default device is "cuda"


# -- the command line -------------------------------------------------------------------


def _cli(*args):
    return ["--device", "cpu", "--batch-size", "2", "--width", "64", "--max-chars", "4",
            "--charset", CHARSET, "--hidden-size", "16", "--output-channel", "32", *args]


def test_main_trains_saves_and_resumes(tmp_path, capsys):
    out = str(tmp_path / "trained")
    assert ttl.main(_cli("--steps", "4", "--out", out, "--save-every", "2",
                         "--log-every", "2")) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in lines[:-1]] == ["step 0", "step 2", "step 3"]
    assert all(line.split("=")[1].count(".") == 1 for line in lines[:-1])
    assert lines[-1] == f"saved {out}"
    manifest = json.loads(open(os.path.join(out, "manifest.json")).read())
    assert manifest["charset"] == CHARSET and manifest["hidden_size"] == 16
    params, cfg, charset = jtl.load_crnn_checkpoint(out)  # JAX reads it
    assert cfg == JCFG and charset == CHARSET
    # the native --init resumes (flags matching the manifest, or none)
    assert ttl.main(["--device", "cpu", "--steps", "1", "--batch-size", "1", "--width", "64",
                     "--max-chars", "4", "--init", out, "--out", out, "--log-every", "0"]) == 0
    assert capsys.readouterr().out.splitlines() == [f"saved {out}"]


def test_main_refuses_init_conflicts_and_bad_widths(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    ttl.save_crnn_checkpoint(ckpt, tcrnn.init_crnn_params(TCFG, 0), TCFG, CHARSET)
    for flag, value in (("--charset", "abcdef"), ("--hidden-size", "999"),
                        ("--output-channel", "64")):
        with pytest.raises(SystemExit):
            ttl.main(["--device", "cpu", "--steps", "1", "--init", ckpt, flag, value,
                      "--width", "64", "--max-chars", "4"])
        assert f"{flag}=" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ttl.main(["--device", "cpu", "--steps", "1", "--width", "32", "--max-chars", "16"])
    assert "CTC frames" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttl.main(["--steps", "1"])  # the default device is "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            ttl.init_ctc_train_state(TCFG, ttrain.make_optimizer(LR))


@pytest.fixture(scope="module")
def twin_files(tmp_path_factory):
    """EasyOCR-named CRAFT and CRNN twins (the JAX tests' configs: CRNN 13
    classes, output 32, hidden 16) saved as ``.pth``."""
    from test_torch_latin import _materialize

    state = torch.random.get_rng_state()
    with torch.device("meta"):
        craft, crnn = jtwin.TorchCraft(jtwin.CRAFT_CFG), jtwin.TorchCrnn(jtwin.CRNN_CFG)
    craft, crnn = _materialize(craft, 0), _materialize(crnn, 1)
    assert torch.equal(state, torch.random.get_rng_state())
    d = tmp_path_factory.mktemp("twins")
    torch.save(craft.state_dict(), d / "craft.pth")
    torch.save(crnn.state_dict(), d / "crnn.pth")
    return str(d / "craft.pth"), str(d / "crnn.pth")


def test_main_from_a_pth_matches_jax_main(twin_files, capsys):
    _, crnn_pth = twin_files
    args = ["--steps", "2", "--batch-size", "2", "--width", "64", "--max-chars", "4",
            "--charset", "0123456789ab", "--hidden-size", "16", "--output-channel", "32",
            "--init", crnn_pth, "--log-every", "1"]
    assert ttl.main(["--device", "cpu", *args]) == 0
    got = capsys.readouterr().out.splitlines()
    assert jtl.main(args) == 0
    want = capsys.readouterr().out.splitlines()
    assert [line.split("=")[0] for line in got] == [line.split("=")[0] for line in want] == \
        ["step 0: ctc_loss", "step 1: ctc_loss"]
    for g, w in zip(got, want):
        g, w = float(g.split("=")[1]), float(w.split("=")[1])
        assert abs(g - w) <= max(LOSS_REL * abs(w), 1e-4), (g, w)
    # a charset whose size the checkpoint's classes refuse
    assert ttl.main(["--device", "cpu", *args[:-2], "--charset", "0123"]) == 1
    assert "--init has 13 classes" in capsys.readouterr().out


# -- the engine and the registry on a trained directory ----------------------------------


def test_engine_and_registry_load_a_trained_directory(twin_files, tmp_path):
    craft_pth, _ = twin_files
    out = str(tmp_path / "trained")
    assert ttl.main(_cli("--steps", "2", "--out", out, "--log-every", "0")) == 0
    kw = dict(craft_cfg=jtwin.CRAFT_CFG, det_buckets=(32, 64), rec_width_buckets=(32, 64))
    tkw = dict(kw, craft_cfg=tlatin.craft_mod.CraftConfig(vgg_channels=(4, 8, 16, 32, 32, 64),
                                                          head_channels=8))
    j = jlatin.TpuLatinEngine.from_checkpoints(craft_pth, out, **kw)
    t = tlatin.TorchLatinEngine.from_checkpoints(craft_pth, out, device="cpu", **tkw)
    assert t.charset == j.charset == CHARSET  # the manifest's, not the default
    assert t.crnn_cfg == TCFG
    for a, b in zip(jax.tree.leaves(tcrnn.params_to_jax(t.crnn_params)),
                    jax.tree.leaves(_np_tree(j.crnn_params)), strict=True):
        np.testing.assert_array_equal(a, b)
    img = np.random.default_rng(0).integers(0, 255, (40, 40, 3)).astype(np.uint8)
    assert not t.perform_ocr(img).startswith("[ERROR")
    reg = make_default_registry(settings={"tpu": {"latin_craft_checkpoint": craft_pth,
                                                  "latin_crnn_checkpoint": out}}, device="cpu")
    assert "Latin (TPU)" in reg.available_engines()
    eng = reg.get("Latin (TPU)")
    assert isinstance(eng, tlatin.TorchLatinEngine) and eng.charset == CHARSET
    assert eng.device == torch.device("cpu")


# -- the closed loop -----------------------------------------------------------------------

CLOSED_LOOP_INIT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                                "latin_closed_loop_init")


def test_closed_loop_init_fixture_is_jax_prngkey0_init():
    """The committed directory is ``jtl.save_crnn_checkpoint`` of JAX's
    ``init_crnn_params`` at the closed loop's config and ``PRNGKey(0)``, run
    eagerly as the JAX test runs it (under ``jax.jit`` a few leaves differ
    by an ulp)."""
    import test_latin_closed_loop as jloop

    want = jax.tree.map(np.asarray, jcrnn.init_crnn_params(jloop.CFG, jax.random.PRNGKey(0)))
    got, cfg, charset = ttl.load_crnn_checkpoint(CLOSED_LOOP_INIT, "cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jloop.CFG) and charset == jloop.CHARSET
    got = tcrnn.params_to_jax(got)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_latin_closed_loop_reads_heldout_lines(tmp_path):
    """``tests/test_latin_closed_loop.py`` in the port (~75 s on 4 cores):
    train from JAX's init with ``optax.adam(1e-3)``'s counterpart, save and
    reload the directory, and read 24 held-out lines through
    ``TorchLatinEngine.recognize_lines``."""
    import test_latin_closed_loop as jloop

    params, cfg, charset = ttl.load_crnn_checkpoint(CLOSED_LOOP_INIT, "cpu")
    params, opt_state = ttl.init_ctc_train_state(
        cfg, ttrain.make_optimizer(1e-3, weight_decay=0.0), device="cpu", init_params=params)
    step = ttl.make_ctc_train_step()
    data = ttl.synthetic_line_dataset(cfg, charset, 32, jloop.WIDTH, jloop.MAX_CHARS, seed=0)
    for i in range(2000):
        params, opt_state, loss = step(params, opt_state, next(data))
        if i > 100 and loss.item() < 0.05:
            break
    assert loss.item() < 0.5, f"CTC training failed to converge: {loss.item()}"
    ttl.save_crnn_checkpoint(str(tmp_path), params, cfg, charset)
    eng = tlatin.TorchLatinEngine(crnn_params=ttl.load_crnn_checkpoint(str(tmp_path), "cpu")[0],
                                  crnn_cfg=cfg, charset=charset, device="cpu",
                                  rec_width_buckets=(jloop.WIDTH, 2 * jloop.WIDTH))
    rng = np.random.default_rng(7)
    refs, crops = [], []
    for _ in range(24):
        n = int(rng.integers(1, jloop.MAX_CHARS + 1))
        text = "".join(charset[k] for k in rng.integers(0, len(charset), size=n))
        img, drawn = ttl.render_line(text, charset, cfg.input_height, jloop.WIDTH, rng)
        refs.append(text[:drawn])
        crops.append(img)
    got = eng.recognize_lines(crops)
    exact = sum(g == r for g, r in zip(got, refs))
    assert exact >= 20, f"read {exact}/24 exactly; pairs: {list(zip(refs, got))[:5]}"
