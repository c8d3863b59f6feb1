"""The port's LaMa inpainter (``models/inpaint.py``, ``models/convert_lama.py``)
against the JAX package's at the JAX converter test's tiny config (base 8,
2 blocks, 2 downsamples, ratio 0.5, max 64), on the same numpy weights
(``params_from_jax``) and numpy seed-0 inputs, at 32x32 and at 40x44 (a deep
map of 10x11: an odd deep width through the rFFT): the [0, 1] composite
within ``COMPOSITE_ATOL``, the head's logits within ``LOGIT_REL`` of the
largest, the uint8 output with known pixels exact and hole pixels within one
level on at most ``HOLE_SHARE`` of them (also through the wrapper at 37x43,
padded to 40x44); the wrapper's padding and cropping, ``inpaint_many``'s
order and its dispatch cap, the refusals; the reflect padding against
numpy's; the converter bit for bit against JAX's on one state dict of a
saicinpainting twin (also through a checkpoint file and the ``generator.``
prefix) and the converted weights against the twin's own forward.  The twin
is built on the meta device and filled from an explicit ``torch.Generator``:
torch's global RNG is never drawn."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_convert_lama as jtwin  # noqa: E402  (the JAX tests' saicinpainting twin)
from manga_ocr_tpu.models import convert_lama as jconv
from manga_ocr_tpu.models import inpaint as jip
from manga_ocr_tpu_torch.models import convert_lama as tconv
from manga_ocr_tpu_torch.models import inpaint as tip
from manga_ocr_tpu_torch.parallel.mesh import make_mesh
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JCFG = jtwin.CFG
TCFG = tip.InpaintConfig(base_channels=8, num_blocks=2, downsamples=2, global_ratio=0.5,
                         max_features=64)
# f32 on both sides through ~25 convolutions and 4 FFT pairs: summation order only
COMPOSITE_ATOL = 2e-5
LOGIT_REL = 1e-4
HOLE_SHARE = 0.005  # hole pixels one uint8 level apart (a rounding-edge flip)
# the JAX converter test's bounds for the twin's forward
TWIN_ATOL, TWIN_RTOL = 2e-4, 1e-3
SIZES = [(32, 32), (40, 44)]


def _tree(seed=0):
    """He-normal weights plus random biases (a swapped axis shows)."""
    tree = tip.init_params_numpy(TCFG, seed)
    rng = np.random.default_rng(seed + 100)
    for leaf in jax.tree.leaves(tree):
        if leaf.ndim == 1:
            leaf += rng.normal(0.0, 0.1, leaf.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def tree():
    return _tree()


@pytest.fixture(scope="module")
def jbatch():
    return jax.jit(lambda p, x, m: jip.inpaint_batch(p, x, m, JCFG))


def _inputs(h, w, n=2, seed=0):
    """Images in [0, 1] and a text-block hole per image (numpy seed)."""
    rng = np.random.default_rng(seed)
    img = rng.random((n, h, w, 3), dtype=np.float32)
    mask = np.zeros((n, h, w), np.float32)
    for i in range(n):
        y, x = int(rng.integers(0, h // 2)), int(rng.integers(0, w // 2))
        mask[i, y : y + h // 3, x : x + w // 3] = 1.0
    return img, mask


def _jax_logits(tree, img, mask):
    """JAX's forward up to the head's pre-sigmoid output."""
    p = jax.tree.map(jnp.asarray, tree)
    m = jnp.asarray(mask)[..., None]
    x = jnp.concatenate([jnp.asarray(img) * (1.0 - m), m], axis=-1)
    x = jax.nn.relu(jip._conv(x, p["stem"], pad="reflect"))
    for dp in p["down"]:
        if "l2g" in dp:
            xl = jax.nn.relu(jip._conv(x, dp["l2l"], stride=2))
            xg = jax.nn.relu(jip._conv(x, dp["l2g"], stride=2))
        else:
            x = jax.nn.relu(jip._conv(x, dp["l2l"], stride=2))
    for bp in p["blocks"]:
        xl, xg = jip.ffc_block(xl, xg, bp)
    x = jnp.concatenate([xl, xg], axis=-1)
    for up in p["up"]:
        x = jax.nn.relu(jip._deconv2x(x, up))
    return np.asarray(jip._conv(x, p["head"], pad="reflect"))


def _nchw(a):
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _assert_u8_close(got, want, hole):
    """Known pixels exact; hole pixels within one level on <= HOLE_SHARE."""
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got[~hole], want[~hole])
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))[hole]
    assert diff.max(initial=0) <= 1
    assert (diff > 0).mean() <= HOLE_SHARE, (diff > 0).mean()


def test_config_matches_jax():
    import dataclasses

    assert dataclasses.asdict(tip.InpaintConfig()) == dataclasses.asdict(jip.InpaintConfig())
    assert dataclasses.asdict(TCFG) == dataclasses.asdict(JCFG)
    for c in (tip.InpaintConfig(), tip.InpaintConfig(num_blocks=18), TCFG):
        j = jip.InpaintConfig(**dataclasses.asdict(c))
        assert (c.cl, c.cg, c.deep_channels) == (j.cl, j.cg, j.deep_channels)


def test_init_params_match_jax_layout():
    """Keys and shapes of JAX's ``init_params`` (read by ``eval_shape``), zero
    biases, He-normal spread; the port's tree in OIHW / [I, O, 3, 3]."""
    want = jax.eval_shape(lambda k: jip.init_params(JCFG, k), jax.random.PRNGKey(0))
    got = tip.init_params_numpy(TCFG, 0)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.shape == b.shape and a.dtype == np.float32
    stem = got["stem"]["kernel"]
    assert abs(float(stem.std()) / np.sqrt(2.0 / (7 * 7 * 4)) - 1) < 0.1
    assert not any(leaf.any() for leaf in jax.tree.leaves(got) if leaf.ndim == 1)
    port = tip.init_params(TCFG, 0)
    assert tuple(port["stem"]["kernel"].shape) == (8, 4, 7, 7)
    assert tuple(port["up"][0]["kernel"].shape) == (32, 16, 3, 3)  # [I, O, 3, 3]


def test_params_round_trip_bit_for_bit(tree):
    back = tip.params_to_jax(tip.params_from_jax(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    net = tip.FFCResNetGenerator(tip.params_from_jax(tree), TCFG)
    for a, b in zip(jax.tree.leaves(tip.params_to_jax(net)), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", SIZES, ids=str)
def test_forward_matches_jax(tree, hw):
    img, mask = _inputs(*hw)
    want = np.asarray(jip.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(img),
                                  jnp.asarray(mask), JCFG))
    params = tip.params_from_jax(tree)
    got = tip.forward(params, _nchw(img), torch.from_numpy(mask), TCFG)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 3, *hw)
    got = got.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=COMPOSITE_ATOL)
    known = mask == 0
    np.testing.assert_array_equal(got[known], img[known])  # passes through exactly
    jl = _jax_logits(tree, img, mask)
    tl = tip.head_logits(params, _nchw(img), torch.from_numpy(mask), TCFG)
    tl = tl.permute(0, 2, 3, 1).numpy()
    assert np.abs(tl - jl).max() <= LOGIT_REL * np.abs(jl).max()
    # the module and the functional forward are one computation
    net = tip.FFCResNetGenerator(params, TCFG)
    with torch.no_grad():
        np.testing.assert_array_equal(
            net(_nchw(img), torch.from_numpy(mask)).permute(0, 2, 3, 1).numpy(), got)


def test_unflipped_upsample_kernel_shows(tree):
    """The upsamples' spatial flip is not a no-op: without it the image moves."""
    img, mask = _inputs(32, 32)
    params = tip.params_from_jax(tree)
    good = tip.head_logits(params, _nchw(img), torch.from_numpy(mask), TCFG)
    for up in params["up"]:
        up["kernel"] = up["kernel"].flip(-1, -2).contiguous()
    bad = tip.head_logits(params, _nchw(img), torch.from_numpy(mask), TCFG)
    assert (bad - good).abs().max() > 100 * LOGIT_REL * good.abs().max()


@pytest.mark.parametrize("hw", SIZES, ids=str)
def test_inpaint_batch_matches_jax(tree, jbatch, hw):
    rng = np.random.default_rng(hw[1])
    imgs = rng.integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    _, mask = _inputs(*hw, n=3, seed=hw[0])
    masks = (mask * 255).astype(np.uint8)
    want = np.asarray(jbatch(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs),
                             jnp.asarray(masks)))
    got = tip.inpaint_batch(tip.params_from_jax(tree), imgs, masks, TCFG)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    hole = np.repeat((masks > 0)[..., None], 3, axis=-1)
    _assert_u8_close(got.numpy(), want, hole)
    np.testing.assert_array_equal(got.numpy()[~hole], imgs[~hole])


def test_wrapper_matches_jax_at_an_odd_size(tree):
    """37x43 pads to 40x44 (edge / zeros) and crops back, in both packages."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (37, 43, 3), dtype=np.uint8)
    mask = np.zeros((37, 43), np.uint8)
    mask[5:20, 9:30] = 255
    want = jip.LamaInpainter(jax.tree.map(jnp.asarray, tree), JCFG)(img, mask)
    inp = tip.LamaInpainter(tip.params_from_jax(tree), TCFG, device="cpu")
    got = inp(img, mask)
    assert got.shape == img.shape
    hole = np.repeat((mask > 0)[..., None], 3, axis=-1)
    _assert_u8_close(got, np.asarray(want), hole)
    # the pad is by edge for the image, by zeros for the mask; the crop is [:h, :w]
    pimg = np.pad(img, ((0, 3), (0, 1), (0, 0)), mode="edge")
    pmask = np.pad(mask, ((0, 3), (0, 1)))
    full = tip.inpaint_batch(inp._net, pimg[None], pmask[None], TCFG)[0].numpy()
    np.testing.assert_array_equal(got, full[:37, :43])


def _regions(seed=9):
    rng = np.random.default_rng(seed)
    shapes = [(30, 20), (16, 16), (29, 18), (13, 16), (32, 17), (10, 10)]
    imgs, masks = [], []
    for h, w in shapes:
        imgs.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        m = np.zeros((h, w), np.uint8)
        m[h // 4 : h // 2 + 2, w // 4 : w // 2 + 2] = 255
        masks.append(m)
    return imgs, masks


def test_inpaint_many_order_and_dispatch_cap(tree, monkeypatch):
    """Results in input order, equal to one call a region; one dispatch per
    padded shape uncapped; a cap of one region's pixels splits every group
    and changes no pixel."""
    imgs, masks = _regions()
    params = tip.params_from_jax(tree)
    single = [tip.LamaInpainter(params, TCFG, device="cpu")(i, m) for i, m in zip(imgs, masks)]
    seen = []
    dispatch = tip.LamaInpainter._dispatch

    def counting(self, a, b):
        seen.append(a.shape)
        return dispatch(self, a, b)

    monkeypatch.setattr(tip.LamaInpainter, "_dispatch", counting)
    uncapped = tip.LamaInpainter(params, TCFG, device="cpu").inpaint_many(imgs, masks)
    assert seen == [(1, 12, 12, 3), (2, 16, 16, 3), (3, 32, 20, 3)]
    seen.clear()
    monkeypatch.setattr(tip, "DISPATCH_PIXELS", 2 * 16 * 16)
    capped = tip.LamaInpainter(params, TCFG, device="cpu").inpaint_many(imgs, masks)
    assert seen == [(1, 12, 12, 3), (2, 16, 16, 3)] + [(1, 32, 20, 3)] * 3
    for a, b, c, img in zip(single, uncapped, capped, imgs):
        assert a.shape == img.shape
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)


def test_refusals(tree):
    with pytest.raises(RuntimeError, match="no weights"):
        tip.LamaInpainter(device="cpu")(np.zeros((8, 8, 3), np.uint8), np.zeros((8, 8), np.uint8))
    with pytest.raises(RuntimeError, match="no weights"):
        tip.LamaInpainter(device="cpu").inpaint_many([np.zeros((8, 8, 3), np.uint8)],
                                                      [np.zeros((8, 8), np.uint8)])
    with pytest.raises(ValueError, match="mesh"):  # a CUDA mesh under device="cpu"
        tip.LamaInpainter(tip.params_from_jax(tree), TCFG, device="cpu",
                          mesh=make_mesh(2, devices=[torch.device("cuda", 0)] * 2))
    params = tip.params_from_jax(tree)
    with pytest.raises(ValueError, match="uint8"):
        tip.inpaint_batch(params, np.zeros((1, 8, 8, 3), np.float32),
                          np.zeros((1, 8, 8), np.uint8), TCFG)
    with pytest.raises(ValueError, match="masks"):
        tip.inpaint_batch(params, np.zeros((1, 8, 8, 3), np.uint8),
                          np.zeros((1, 8, 9), np.uint8), TCFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tip.LamaInpainter(params, TCFG)  # the default is "cuda"


@pytest.mark.parametrize("n,r", [(1, 1), (2, 1), (2, 3), (3, 3), (5, 2), (4, 7)], ids=str)
def test_reflect_pad_matches_numpy(n, r):
    x = np.arange(2 * 3 * n * (n + 1), dtype=np.float32).reshape(2, 3, n, n + 1)
    want = np.pad(x, ((0, 0), (0, 0), (r, r), (r, r)), mode="reflect")
    np.testing.assert_array_equal(tip._reflect_pad(torch.from_numpy(x), r).numpy(), want)


def test_tiny_regions_match_jax(tree):
    """A region of 4x4 pixels leaves a 1x1 deep map (reflect padding by
    numpy's rule where torch's would refuse)."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (4, 7, 3), dtype=np.uint8)
    mask = np.zeros((4, 7), np.uint8)
    mask[1:3, 2:5] = 255
    want = jip.LamaInpainter(jax.tree.map(jnp.asarray, tree), JCFG)(img, mask)
    got = tip.LamaInpainter(tip.params_from_jax(tree), TCFG, device="cpu")(img, mask)
    _assert_u8_close(got, np.asarray(want), np.repeat((mask > 0)[..., None], 3, axis=-1))


# -- the converter ------------------------------------------------------------------


def _materialize(module, seed):
    """A twin built on the meta device, its weights and BN statistics drawn
    from an explicit generator (never torch's global RNG)."""
    g = torch.Generator().manual_seed(seed)
    module = module.to_empty(device="cpu")
    with torch.no_grad():
        for name, t in module.state_dict(keep_vars=True).items():
            if name.endswith("num_batches_tracked"):
                t.zero_()
            elif name.endswith("running_var"):
                t.uniform_(0.5, 1.0, generator=g)
            else:
                t.normal_(0.0, 0.1, generator=g)
    return module.eval()


@pytest.fixture(scope="module")
def twin():
    state = torch.random.get_rng_state()
    with torch.device("meta"):
        twin = jtwin.TwinLama(JCFG)
    twin = _materialize(twin, 0)
    assert torch.equal(state, torch.random.get_rng_state())  # the global RNG untouched
    return twin


def _same_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_converter_bit_for_bit(twin, tmp_path):
    want = jconv.convert_lama_torch(twin, JCFG)
    _same_tree(tconv.convert_lama_torch(twin, TCFG), want)
    sd = {f"generator.{k}": v.numpy() for k, v in twin.state_dict().items()}
    _same_tree(tconv.convert_lama_state_dict(sd, TCFG), want)
    _same_tree(jconv.convert_lama_state_dict(sd, JCFG), want)
    # a training checkpoint file: {"state_dict": {"generator.model...": ...}}
    path = str(tmp_path / "lama.ckpt")
    torch.save({"state_dict": {f"generator.{k}": v for k, v in twin.state_dict().items()}},
               path)
    _same_tree(tconv.convert_lama_file(path, TCFG), want)
    _same_tree(jconv.convert_lama_file(path, JCFG), want)
    # mapped into the port's layout and back, still the same arrays
    _same_tree(tip.params_to_jax(tip.params_from_jax(tconv.convert_lama_torch(twin, TCFG))),
               want)


def test_converted_forward_matches_the_twin(twin):
    params = tip.params_from_jax(tconv.convert_lama_torch(twin, TCFG))
    img = np.random.default_rng(0).random((1, 32, 32, 3), dtype=np.float32)
    mask = np.zeros((1, 32, 32), np.float32)
    mask[:, 8:20, 10:22] = 1.0
    with torch.no_grad():
        want = twin(_nchw(img), torch.from_numpy(mask[:, None])).numpy()
    got = tip.forward(params, _nchw(img), torch.from_numpy(mask), TCFG).numpy()
    np.testing.assert_allclose(got, want, atol=TWIN_ATOL, rtol=TWIN_RTOL)
