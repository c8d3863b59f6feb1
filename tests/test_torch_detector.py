"""The port's bubble segmenter (``manga_ocr_tpu_torch/models/detector.py``)
against the JAX package's on the same numpy-made weights (carried by
``params_from_jax``) and pages: the U-Net's forward within 1e-5, the whole
``segment_pages`` graph at an odd page size (masks equal except where JAX's
probability lies within ``MASK_EPS`` of the threshold, the count printed),
``.npz`` files loaded across packages both ways, ``init_params``' keys and
shapes, and TF32 held off inside ``segment_pages`` whatever the process set."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manga_ocr_tpu.models import detector as jseg
from manga_ocr_tpu_torch.models import detector as tseg
from manga_ocr_tpu_torch.ops import image as tim
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

FORWARD_ATOL = 1e-5
PROB_ATOL = 1e-5  # the resized probabilities (JAX's resize vs two matmuls)
MASK_EPS = 1e-4  # a pixel this close to the threshold may flip between packages

CONFIGS = [(32, 4, 2), (48, 8, 3), (64, 4, 2)]


def _cfgs(size, base, depth):
    return (jseg.DetectorConfig(input_size=size, base_channels=base, depth=depth),
            tseg.DetectorConfig(input_size=size, base_channels=base, depth=depth))


def _asymmetric_params(tcfg, seed):
    """He-normal weights plus random biases: a transposed kernel or a
    swapped in/out axis changes the output."""
    tree = tseg.init_params_numpy(tcfg, seed)
    rng = np.random.default_rng(seed + 100)
    for leaf in jax.tree.leaves(tree):
        if leaf.ndim == 1:
            leaf += rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
    return tree


@pytest.mark.parametrize("size,base,depth", CONFIGS, ids=str)
def test_forward_matches_jax(size, base, depth):
    jcfg, tcfg = _cfgs(size, base, depth)
    tree = _asymmetric_params(tcfg, size + depth)
    x = np.random.default_rng(size).random((2, size, size, 3), dtype=np.float32)
    want = np.asarray(jseg.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), jcfg))
    params = tseg.params_from_jax(tree)
    got = tseg.forward(params, torch.from_numpy(x).permute(0, 3, 1, 2), tcfg)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, size, size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FORWARD_ATOL)
    # the module and the functional forward are one computation
    net = tseg.UNet(params, tcfg)
    with torch.no_grad():
        np.testing.assert_array_equal(
            net(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(), got.numpy())
    # a transposed 3x3 kernel still runs: only non-symmetric weights catch it
    bad = tseg.params_from_jax(tree)
    bad["down"][0]["c1"]["kernel"] = bad["down"][0]["c1"]["kernel"].transpose(2, 3).contiguous()
    wrong = tseg.forward(bad, torch.from_numpy(x).permute(0, 3, 1, 2), tcfg).numpy()
    assert np.abs(wrong - want).max() > 100 * FORWARD_ATOL


def _jax_probs(tree, pages, jcfg, out_h, out_w):
    """JAX's ``segment_pages`` before its threshold."""
    s = jcfg.input_size
    x = jax.image.resize(jnp.asarray(pages, jnp.float32), (pages.shape[0], s, s, 3), "linear")
    prob = jseg.forward(jax.tree.map(jnp.asarray, tree), x / 255.0, jcfg)
    return np.asarray(jax.image.resize(prob, (prob.shape[0], out_h, out_w), "linear"))


@pytest.mark.parametrize("size,base,depth", CONFIGS[:2], ids=str)
def test_segment_pages_odd_size_matches_jax(size, base, depth):
    jcfg, tcfg = _cfgs(size, base, depth)
    tree = _asymmetric_params(tcfg, 7)
    h, w = 97, 131
    pages = np.random.default_rng(3).integers(0, 256, (3, h, w, 3), dtype=np.uint8)
    want_mask = np.asarray(jseg.segment_pages(jax.tree.map(jnp.asarray, tree),
                                              jnp.asarray(pages), jcfg, h, w))
    want_prob = _jax_probs(tree, pages, jcfg, h, w)
    params = tseg.params_from_jax(tree)
    prob = tseg.segment_probs(params, pages, tcfg, h, w).numpy()
    mask = tseg.segment_pages(params, pages, tcfg, h, w)
    assert mask.dtype == torch.uint8 and tuple(mask.shape) == (3, h, w)
    mask = mask.numpy()
    np.testing.assert_allclose(prob, want_prob, rtol=0, atol=PROB_ATOL)
    assert set(np.unique(mask)) == {0, 255}, "a one-valued mask tests nothing"
    near = np.abs(want_prob - tcfg.threshold) <= MASK_EPS
    print(f"{int(near.sum())} of {near.size} pixels within {MASK_EPS} of the threshold")
    np.testing.assert_array_equal(mask[~near], want_mask[~near])
    # the same call from a UNet, and with a torch page batch
    np.testing.assert_array_equal(
        tseg.segment_pages(tseg.UNet(params, tcfg), torch.from_numpy(pages), tcfg, h, w).numpy(),
        mask)


def test_segment_pages_holds_tf32_off(monkeypatch):
    _, tcfg = _cfgs(32, 4, 2)
    params = tseg.init_params(tcfg, 0)
    seen = []
    forward = tseg.forward

    def spy(p, x, cfg):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return forward(p, x, cfg)

    monkeypatch.setattr(tseg, "forward", spy)
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        pages = np.zeros((1, 40, 30, 3), np.uint8)
        tseg.segment_pages(params, pages, tcfg, 40, 30)
        with tseg.fp32_products():  # nested blocks restore only at the outermost end
            tseg.segment_pages(params, pages, tcfg, 40, 30)
            assert not torch.backends.cudnn.allow_tf32
        assert seen == [(False, False), (False, False)]
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_fp32_products_under_concurrent_threads():
    """The page pipeline detects on two threads at once: every block sees
    TF32 off, and the process's flags come back only after the last block
    ends (a lost update of the shared depth would restore them early or
    never)."""
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    switch = sys.getswitchinterval()
    bad, errors = [], []
    start = threading.Barrier(16)

    def worker():
        try:
            start.wait(timeout=10)
            for _ in range(200):
                with tseg.fp32_products():
                    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                        bad.append(1)
        except Exception as e:  # reported below
            errors.append(e)

    try:
        sys.setswitchinterval(1e-6)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert not bad, f"{len(bad)} blocks ran with TF32 on"
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
        assert tseg._tf32_depth == 0
    finally:
        sys.setswitchinterval(switch)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def test_segment_pages_refuses_non_rgb_u8_pages():
    _, tcfg = _cfgs(32, 4, 2)
    params = tseg.init_params(tcfg, 0)
    for bad in (np.zeros((1, 20, 20), np.uint8), np.zeros((1, 20, 20, 3), np.float32),
                np.zeros((1, 20, 20, 4), np.uint8)):
        with pytest.raises(ValueError, match="uint8"):
            tseg.segment_pages(params, bad, tcfg, 20, 20)


def test_resize_bilinear_layout_is_explicit():
    """A [B, H, W] probability map of width <= 4 is not a channels dim."""
    x = torch.from_numpy(np.random.default_rng(0).random((2, 9, 3), dtype=np.float32))
    got = tim.resize_bilinear(x, 5, 7, channels_last=False)
    assert tuple(got.shape) == (2, 5, 7)
    want = np.asarray(jax.image.resize(jnp.asarray(x.numpy()), (2, 5, 7), "linear"))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    # the shape guess reads the same map as one [9, 3]-pixel image of 3 channels
    assert tuple(tim.resize_bilinear(x, 5, 7).shape) == (5, 7, 3)


@pytest.mark.parametrize("size,base,depth", [(32, 4, 2), (512, 32, 4)], ids=str)
def test_init_params_has_jax_keys_and_shapes(size, base, depth):
    jcfg, tcfg = _cfgs(size, base, depth)
    want = jax.eval_shape(lambda: jseg.init_params(jcfg, jax.random.PRNGKey(0)))
    got = tseg.init_params_numpy(tcfg, 0)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(want)]
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(got))
    # the port's tree holds the same leaves in OIHW
    port = tseg.init_params(tcfg, 0)
    k = port["down"][0]["c1"]["kernel"]
    assert tuple(k.shape) == (base, 3, 3, 3)
    np.testing.assert_array_equal(k.permute(2, 3, 1, 0).numpy(), got["down"][0]["c1"]["kernel"])
    back = tseg.params_to_jax(port)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)
    if size == 512:  # the full-width config: ~7.85M parameters
        assert sum(a.size for a in jax.tree.leaves(got)) == 7_846_657
    # the He-normal scale: std sqrt(2 / fan_in) for each 3x3 kernel
    w = got["mid"]["c1"]["kernel"]
    assert abs(w.std() / np.sqrt(2.0 / (9 * w.shape[2])) - 1) < 0.1
    assert not np.any(got["mid"]["c1"]["bias"])


def test_npz_loads_across_packages(tmp_path):
    jcfg, tcfg = _cfgs(32, 8, 2)
    # JAX writes, the port reads
    jparams = jax.tree.map(jnp.asarray, _asymmetric_params(tcfg, 3))
    jseg.save_params(jparams, str(tmp_path / "jax.npz"))
    got = tseg.load_params(str(tmp_path / "jax.npz"), tcfg)
    want = tseg.params_from_jax(jax.tree.map(np.asarray, jparams))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # the port writes, JAX reads
    tparams = tseg.params_from_jax(_asymmetric_params(tcfg, 5))
    tseg.save_params(tparams, str(tmp_path / "port.npz"))
    # (JAX's load_params is fill_template over its init_params tree; the
    # template's shapes come from tracing that init, not running it)
    template = jax.eval_shape(lambda: jseg.init_params(jcfg, jax.random.PRNGKey(0)))
    with np.load(str(tmp_path / "port.npz")) as data:
        jback = jseg.fill_template(data, template)
    for a, b in zip(jax.tree.leaves(jback), jax.tree.leaves(tseg.params_to_jax(tparams))):
        np.testing.assert_array_equal(np.asarray(a), b)
    with np.load(str(tmp_path / "port.npz")) as a, np.load(str(tmp_path / "jax.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "down/0/c1/kernel" in a.files
        assert a["down/0/c1/kernel"].shape == (3, 3, 3, 8)  # HWIO on disk
    # a file of another config is refused, not silently reshaped
    with pytest.raises(ValueError, match="shape"):
        tseg.load_params(str(tmp_path / "port.npz"), tseg.DetectorConfig(32, 4, 2))
