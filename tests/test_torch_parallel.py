"""Tensor parallelism and mesh training in the port (``parallel/mesh.py``'s
``param_specs``/``shard_params``, the plain routes on a data row's model
columns (``parallel/tensor.py``), ``train.py``'s ``mesh=``, ``dryrun.py``) against the port on one device and the JAX
package on its 8-device virtual CPU mesh, at the tiny config in f32 with
the same numpy-made weights and inputs:

- ``param_specs`` equals JAX's leaf for leaf (which dimension, which axis);
  ``shard_params`` then ``unshard_params`` gives the tree back bit for bit,
  every leaf a tensor of its own; a split that does not divide raises;
- the tensor-parallel encoder output and ``forward_full`` logits on (1, 2),
  (1, 4) and (4, 2) meshes within 1e-5 of the largest single-device value,
  greedy tokens equal to one device's and to JAX's ``make_jitted_ocr`` on
  its (4, 2) mesh; one column is the plain route bit for bit; the data
  rows decode in one loop, one "every row done" read a chunk;
- the train step on (8, 1) and (4, 2) meshes: losses within 1e-5 relative
  of one device's and of JAX's step on the same mesh, the params after it
  as ``tests/test_torch_train.py`` holds steps (within 3 lr everywhere,
  within 1e-5 on >= 99.9% of the elements of each leaf whose gradient is
  above 1e-7: Adam turns a gradient that is 0 but for summation noise, as
  the cross-attention key bias's is, into a step of either sign), every
  replica bit-equal on distinct leaves; loss masks that differ across
  data shards keep the global batch's loss and gradient (1e-4 of each
  leaf's largest |g|);
- train states across packages and layouts both ways;
- ``dryrun_multichip(8, "cpu")``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from manga_ocr_tpu import train as jtr
from manga_ocr_tpu.models import checkpoint as jck
from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models.config import MangaOCRConfig as JaxConfig
from manga_ocr_tpu.parallel import mesh as jmesh
from manga_ocr_tpu_torch import train as ttr
from manga_ocr_tpu_torch.dryrun import dryrun_multichip
from manga_ocr_tpu_torch.models import decoder as tdec
from manga_ocr_tpu_torch.models import model as tmdl
from manga_ocr_tpu_torch.models import vit as tvit
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.parallel import mesh as meshlib
from manga_ocr_tpu_torch.parallel import tensor
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

JCFG = JaxConfig.tiny()
TCFG = port_config(JCFG)
TP_MESHES = [(1, 2), (1, 4), (4, 2)]
REL = 1e-5  # relative to the largest single-device value
MAX_LEN = 12
LOSS_REL = 1e-5
GRAD_REL, GRAD_ATOL = 1e-4, 1e-7
STEP_ATOL, STEP_SHARE = 1e-5, 0.999
LR = 1e-4  # jtr.make_optimizer()'s and ttr.make_optimizer()'s default


def _cpu_mesh(n_data, n_model):
    return meshlib.make_mesh(n_data, n_model, devices=[torch.device("cpu")] * (n_data * n_model))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, t in tree.items()
                for p, v in _paths(t, f"{prefix}/{k}" if prefix else k).items()}
    return {prefix: tree}


def _np_tree(tree) -> dict:
    """A parameter tree of either package as {leaf path: f32 numpy array}."""
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v, np.float32)
            for k, v in _paths(tree).items()}


def _assert_step_close(got: dict, want: dict, grads: dict):
    """Params after one step: within 3 lr everywhere; within STEP_ATOL on
    STEP_SHARE of each leaf's elements whose gradient (``grads``, one
    device's) is above GRAD_ATOL."""
    assert sorted(got) == sorted(want)
    for k in want:
        diff = np.abs(got[k] - want[k])
        assert diff.max() <= 3 * LR, (k, diff.max())
        live = np.abs(grads[k]) > GRAD_ATOL
        if live.any():
            assert float((diff[live] <= STEP_ATOL).mean()) >= STEP_SHARE, (k, diff.max())


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max())


def _pixels(n, seed=0):
    img = JCFG.encoder.image_size
    return np.random.default_rng(seed).normal(size=(n, img, img, 3)).astype(np.float32)


def _batch(shard_masks: bool, b: int = 8, t: int = 8):
    """Pixels, tokens (BOS first), and a loss mask: all ones, or (with
    ``shard_masks``) one whose count differs on every 2-row shard."""
    rng = np.random.default_rng(1)
    toks = rng.integers(4, JCFG.decoder.vocab_size, size=(b, t)).astype(np.int32)
    toks[:, 0] = JCFG.decoder.bos_token_id
    mask = np.ones((b, t), np.float32)
    if shard_masks:
        for r in range(b):
            mask[r, 2 + (r * 5) % (t - 2):] = 0.0
    return _pixels(b, 2), toks, mask


def _port_batch(px, toks, mask):
    return ttr.TrainBatch(torch.from_numpy(px), torch.from_numpy(toks), torch.from_numpy(mask))


def _jax_batch(px, toks, mask):
    return jtr.TrainBatch(jnp.asarray(px), jnp.asarray(toks), jnp.asarray(mask))


@pytest.fixture(scope="module")
def tree():
    return init_params_numpy(TCFG, 0, std=0.1)


# -- param_specs and shard_params ---------------------------------------------------


def test_param_specs_match_jax_leaf_for_leaf(tree):
    want = _paths(jmesh.param_specs())
    got = _paths(meshlib.param_specs())
    assert sorted(got) == sorted(want) == sorted(_paths(tree))
    for k, spec in want.items():
        assert isinstance(got[k], meshlib.PartitionSpec)
        assert tuple(got[k]) == tuple(spec), k
    assert got["decoder/tok_embed"] == meshlib.P("model", None)
    assert got["encoder/layers/attn/o/kernel"] == meshlib.P(None, "model", None)


def test_param_shardings_put_each_spec_on_the_mesh():
    mesh = _cpu_mesh(4, 2)
    shardings = _paths(meshlib.param_shardings(mesh))
    specs = _paths(meshlib.param_specs())
    assert sorted(shardings) == sorted(specs)
    assert all(s == meshlib.NamedSharding(mesh, specs[k]) for k, s in shardings.items())


@pytest.mark.parametrize("shape", TP_MESHES + [(8, 1)], ids=str)
def test_shard_then_unshard_gives_the_tree_back(tree, shape):
    n_data, n_model = shape
    params = params_from_jax(tree, "cpu")
    grid = meshlib.shard_params(params, _cpu_mesh(n_data, n_model))
    assert len(grid) == n_data and all(len(cols) == n_model for cols in grid)
    want = _paths(params)
    specs = _paths(meshlib.param_specs())
    ptrs = set()
    for cols in grid:
        got = _paths(meshlib.unshard_params(cols))
        assert all(torch.equal(got[k], want[k]) for k in want)
        for c, col in enumerate(cols):
            for k, leaf in _paths(col).items():
                dim = meshlib.model_dim(specs[k])
                shape_want = list(want[k].shape)
                if dim is not None:
                    shape_want[dim] //= n_model
                    lo = c * shape_want[dim]
                    assert torch.equal(leaf, want[k].narrow(dim, lo, shape_want[dim]))
                assert list(leaf.shape) == shape_want and leaf.is_contiguous()
                ptrs.add(leaf.data_ptr())
    # every leaf of every tree is a tensor of its own
    assert len(ptrs) == n_data * n_model * len(want)


@pytest.mark.parametrize("vocab, n_model, leaf", [
    (100, 3, "encoder/patch_embed/kernel"), (101, 2, "decoder/tok_embed")], ids=str)
def test_a_split_that_does_not_divide_raises(vocab, n_model, leaf):
    cfg = port_config(JaxConfig.tiny(vocab_size=vocab))
    params = params_from_jax(init_params_numpy(cfg, 0), "cpu")
    with pytest.raises(ValueError, match=leaf):
        meshlib.shard_params(params, _cpu_mesh(1, n_model))


def test_a_model_axis_of_one_is_the_dp_replicate_layout(tree):
    params = params_from_jax(tree, "cpu")
    mesh = _cpu_mesh(8, 1)
    grid = meshlib.shard_params(params, mesh)
    repl = meshlib.dp_replicate(params, mesh)
    for cols, shared in zip(grid, repl):
        got, want = _paths(cols[0]), _paths(shared)
        assert all(torch.equal(got[k], want[k]) and got[k] is not want[k] for k in want)


# -- the tensor-parallel forward ---------------------------------------------------------


@pytest.fixture(scope="module")
def single(tree):
    """The port on one device: encoder output, forward_full logits (with a
    key mask) and greedy tokens of 8 crops."""
    params = params_from_jax(tree, "cpu")
    px = torch.from_numpy(_pixels(8))
    toks = torch.from_numpy(_batch(False)[1])
    key_mask = torch.ones_like(toks)
    key_mask[1, 5:] = 0
    with torch.inference_mode():
        enc = tvit.encode(params["encoder"], px, TCFG.encoder)
        logits = tdec.forward_full(params["decoder"], toks, enc, TCFG.decoder, key_mask)
        out = tmdl.ocr_forward(params, px, TCFG, max_length=MAX_LEN)
    return {"params": params, "px": px, "toks": toks, "key_mask": key_mask, "enc": enc,
            "logits": logits, "tokens": out.tokens, "lengths": out.lengths}


def _tp_rows(single, shape):
    """Each data row's tensor-parallel encoder output and logits on its
    slice of the 8 crops, and the rows' greedy results from one
    ``ocr_forward_rows``, joined in row order."""
    n_data, n_model = shape
    grid = meshlib.shard_params(single["params"], _cpu_mesh(n_data, n_model))
    per = 8 // n_data
    parts = [slice(i * per, (i + 1) * per) for i in range(n_data)]
    enc, logits = [], []
    with torch.inference_mode():
        for cols, sl in zip(grid, parts):
            e = tvit.encode([c["encoder"] for c in cols], single["px"][sl], TCFG.encoder)
            enc.append(e)
            logits.append(tdec.forward_full([c["decoder"] for c in cols], single["toks"][sl],
                                            e, TCFG.decoder, single["key_mask"][sl]))
        outs = tmdl.ocr_forward_rows(grid, [single["px"][sl] for sl in parts], TCFG,
                                     max_length=MAX_LEN)
    return (torch.cat(enc), torch.cat(logits), torch.cat([o.tokens for o in outs]),
            torch.cat([o.lengths for o in outs]))


@pytest.mark.parametrize("shape", TP_MESHES, ids=str)
def test_tensor_parallel_forward_matches_one_device(single, shape):
    enc, logits, tokens, lengths = _tp_rows(single, shape)
    assert _rel(enc, single["enc"]) <= REL
    assert _rel(logits, single["logits"]) <= REL
    assert torch.equal(tokens, single["tokens"]) and torch.equal(lengths, single["lengths"])
    assert len({tuple(t) for t in tokens.tolist()}) > 1  # tokens depend on the crop


def test_one_column_is_the_plain_route_bit_for_bit(single):
    enc, logits, tokens, lengths = _tp_rows(single, (1, 1))
    assert torch.equal(enc, single["enc"]) and torch.equal(logits, single["logits"])
    assert torch.equal(tokens, single["tokens"]) and torch.equal(lengths, single["lengths"])


def test_tokens_equal_jax_on_its_4x2_mesh(tree, single):
    mesh = jmesh.make_mesh(4, 2)
    params = jmesh.shard_params(jax.tree.map(jnp.asarray, tree), mesh)
    px = jax.device_put(jnp.asarray(single["px"].numpy()), jmesh.batch_sharding(mesh))
    out = jmdl.make_jitted_ocr(JCFG, max_length=MAX_LEN)(params, px)
    _, _, tokens, lengths = _tp_rows(single, (4, 2))
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(out.tokens))
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(out.lengths))


def test_rows_decode_in_one_loop_with_one_done_read_a_chunk(single, monkeypatch):
    grid = meshlib.shard_params(single["params"], _cpu_mesh(4, 2))
    reads = []
    all_done = tmdl._all_done
    monkeypatch.setattr(tmdl, "_all_done", lambda dones: reads.append(len(dones)) or
                        all_done(dones))
    with torch.inference_mode():
        outs = tmdl.ocr_forward_rows(grid, list(single["px"].split(2)), TCFG,
                                     max_length=MAX_LEN)
        together = list(reads)
        alone = [tmdl.ocr_forward(cols, px, TCFG, max_length=MAX_LEN)
                 for cols, px in zip(grid, single["px"].split(2))]
    # one read of the four rows' flags before each chunk: 11 steps are at most
    # 2 chunks of 8, so at most 2 reads (alone, each row reads its own)
    assert together and set(together) == {4} and len(together) <= 2
    assert set(reads[len(together):]) == {1}
    for o, a in zip(outs, alone):
        assert torch.equal(o.tokens, a.tokens) and torch.equal(o.lengths, a.lengths)


def test_the_forward_refuses_kernels_and_uneven_heads(single):
    from manga_ocr_tpu_torch.models.config import with_serving_kernels

    kernels = with_serving_kernels(TCFG, quantized=True)
    with pytest.raises(ValueError, match="plain routes only"):
        tensor.check_plain(kernels, 2)
    with pytest.raises(ValueError, match="4 heads do not divide over a model axis of 3"):
        tensor.check_plain(TCFG, 3)
    cols = meshlib.shard_params(single["params"], _cpu_mesh(1, 2))[0]
    with pytest.raises(ValueError, match="model columns run the plain route only"):
        tvit.encode([c["encoder"] for c in cols], single["px"][:1], kernels.encoder)
    enc = tvit.encode([c["encoder"] for c in cols], single["px"][:1], TCFG.encoder)
    with pytest.raises(ValueError, match="model columns run the plain step route only"):
        tmdl.greedy_decode(cols, enc, kernels, max_length=4)


# -- the train step on a mesh --------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_mesh_steps(tree):
    """JAX's jitted step on its (8, 1) and (4, 2) meshes from the same
    weights: for each mesh and each mask case, the loss and the params
    after one step."""
    out = {}
    opt = jtr.make_optimizer()
    for shape in ((8, 1), (4, 2)):
        mesh = jmesh.make_mesh(*shape)
        step = jtr.make_train_step(JCFG, opt, mesh)
        for shard_masks in (False, True):
            params, opt_state = jtr.init_train_state(
                JCFG, opt, jax.random.PRNGKey(0), mesh,
                init_params=jax.tree.map(jnp.asarray, tree))
            params, _, loss = step(params, opt_state, _jax_batch(*_batch(shard_masks)))
            out[shape, shard_masks] = (float(loss), _np_tree(params))
    return out


def _port_step(tree, shape, shard_masks):
    """The port's step from ``tree`` on a ``shape`` mesh (None: one device):
    (loss, params after, the params object, the optimizer state)."""
    opt = ttr.make_optimizer()
    mesh = None if shape is None else _cpu_mesh(*shape)
    params, opt_state = ttr.init_train_state(TCFG, opt, device="cpu",
                                             init_params=params_from_jax(tree, "cpu"), mesh=mesh)
    params, opt_state, loss = ttr.make_train_step(TCFG, mesh)(
        params, opt_state, _port_batch(*_batch(shard_masks)))
    full = params if mesh is None else meshlib.unshard_params(params[0])
    return float(loss), _np_tree(full), params, opt_state


@pytest.fixture(scope="module")
def port_steps(tree):
    return {(shape, m): _port_step(tree, shape, m)
            for shape in (None, (8, 1), (4, 2)) for m in (False, True)}


@pytest.fixture(scope="module")
def grads(tree):
    """One device's gradient at ``tree`` for each mask case."""
    out = {}
    for shard_masks in (False, True):
        params = ttr._as_trainable(params_from_jax(tree, "cpu"), "cpu")
        ttr.loss_fn(params, _port_batch(*_batch(shard_masks)), TCFG).backward()
        out[shard_masks] = {k: p.grad.numpy() for k, p in ttr._leaves(params)}
    return out


def test_train_step_dp8(port_steps, jax_mesh_steps, grads):
    loss, params, grid, _ = port_steps[(8, 1), False]
    assert np.isfinite(loss) and len(grid) == 8
    np.testing.assert_allclose(loss, port_steps[None, False][0], rtol=LOSS_REL)
    np.testing.assert_allclose(loss, jax_mesh_steps[(8, 1), False][0], rtol=LOSS_REL)
    _assert_step_close(params, jax_mesh_steps[(8, 1), False][1], grads[False])


@pytest.mark.parametrize("shard_masks", [False, True], ids=["ones", "masks_differ_by_shard"])
def test_train_step_dp4_tp2_matches_dp(port_steps, jax_mesh_steps, grads, shard_masks):
    loss, params, _, _ = port_steps[(4, 2), shard_masks]
    for other in (port_steps[(8, 1), shard_masks][0], port_steps[None, shard_masks][0],
                  jax_mesh_steps[(4, 2), shard_masks][0]):
        np.testing.assert_allclose(loss, other, rtol=LOSS_REL)
    _assert_step_close(params, port_steps[None, shard_masks][1], grads[shard_masks])
    _assert_step_close(params, jax_mesh_steps[(4, 2), shard_masks][1], grads[shard_masks])


def test_masks_that_differ_across_shards_keep_the_global_loss_and_gradient(tree):
    """Each shard's masked nll over the GLOBAL mask sum, the gradients
    summed: the global batch's loss and gradient; a mean of per-shard means
    would be another loss here."""
    px, toks, mask = _batch(True)
    params = ttr._as_trainable(params_from_jax(tree, "cpu"), "cpu")
    loss = ttr.loss_fn(params, _port_batch(px, toks, mask), TCFG)
    loss.backward()
    want = {k: p.grad for k, p in ttr._leaves(params)}
    with torch.no_grad():
        per_shard = [float(ttr.loss_fn(params, _port_batch(px[i:i + 2], toks[i:i + 2],
                                                           mask[i:i + 2]), TCFG))
                     for i in (0, 2, 4, 6)]
    assert abs(np.mean(per_shard) - float(loss)) > 1e-3 * float(loss)

    mesh = _cpu_mesh(4, 2)
    opt = ttr.make_optimizer(lr=0.0, weight_decay=0.0)  # the step leaves the grads in place
    grid, opt_state = ttr.init_train_state(TCFG, opt, device="cpu",
                                           init_params=params_from_jax(tree, "cpu"), mesh=mesh)
    _, _, got_loss = ttr.make_train_step(TCFG, mesh)(grid, opt_state, _port_batch(px, toks, mask))
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=LOSS_REL)
    for cols in grid:
        got = dict(ttr._leaves(meshlib.unshard_params(cols, get=lambda p: p.grad)))
        for k, g in want.items():
            bound = GRAD_REL * float(g.abs().max()) + GRAD_ATOL
            assert float((got[k] - g).abs().max()) <= bound, k


def test_replicas_are_bit_equal_on_distinct_leaves_after_a_step(port_steps):
    _, _, grid, opt_state = port_steps[(4, 2), True]
    specs = _paths(meshlib.param_specs())
    rows = [[_paths(col) for col in cols] for cols in grid]
    ptrs = [t.data_ptr() for r in rows for col in r for t in col.values()]
    assert len(set(ptrs)) == len(ptrs)
    state = opt_state.optimizer.state
    for r in rows:
        for c in range(2):
            for k, leaf in r[c].items():
                same_as = rows[0][c][k] if meshlib.model_dim(specs[k]) is not None else rows[0][0][k]
                assert torch.equal(leaf, same_as), k
                assert torch.equal(state[leaf]["exp_avg"], state[same_as]["exp_avg"]), k


# -- train states across packages and layouts -----------------------------------------------


def test_resume_jax_single_device_state_on_a_port_mesh(tree, tmp_path):
    """JAX's state after one single-device step, resumed by the port on a
    (4, 2) mesh (the moments take the params' shardings) and by JAX: the
    next step's losses and params agree."""
    opt = jtr.make_optimizer()
    batch = _batch(True)
    params, opt_state = jtr.init_train_state(JCFG, opt, jax.random.PRNGKey(0),
                                             init_params=jax.tree.map(jnp.asarray, tree))
    step = jtr.make_train_step(JCFG, opt)
    params, opt_state, _ = step(params, opt_state, _jax_batch(*batch))
    jtr.save_train_state(str(tmp_path), params, opt_state, 1, JCFG)
    mu = jck._flatten(jax.tree.map(np.array, opt_state[0].mu))
    _, jloss = step(params, opt_state, _jax_batch(*batch))[1:]

    mesh = _cpu_mesh(4, 2)
    grid, state, at, _ = ttr.load_train_state(str(tmp_path), ttr.make_optimizer(), "cpu", mesh)
    assert at == 1
    leaf = grid[3][1]["encoder"]["patch_embed"]["kernel"]
    want = torch.from_numpy(mu["encoder/patch_embed/kernel"]).narrow(3, 32, 32)
    assert torch.equal(state.optimizer.state[leaf]["exp_avg"], want)
    assert state.optimizer.state[leaf]["exp_avg"].data_ptr() != \
        state.optimizer.state[grid[2][1]["encoder"]["patch_embed"]["kernel"]]["exp_avg"].data_ptr()
    _, _, loss = ttr.make_train_step(TCFG, mesh)(grid, state, _port_batch(*batch))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_REL)


def test_resume_a_port_mesh_state_in_jax_and_on_one_device(tree, grads, tmp_path):
    """The port's state after one step on a (4, 2) mesh, read by JAX's
    loader (placed on its own (4, 2) mesh) and by the port on one device:
    the next step agrees with the port's own next step on the mesh."""
    batch = _batch(True)
    opt = ttr.make_optimizer()
    mesh = _cpu_mesh(4, 2)
    grid, state = ttr.init_train_state(TCFG, opt, device="cpu",
                                       init_params=params_from_jax(tree, "cpu"), mesh=mesh)
    step = ttr.make_train_step(TCFG, mesh)
    grid, state, _ = step(grid, state, _port_batch(*batch))
    ttr.save_train_state(str(tmp_path), grid, state, 1, TCFG)
    grid, state, loss = step(grid, state, _port_batch(*batch))
    want = _np_tree(meshlib.unshard_params(grid[0]))

    jopt = jtr.make_optimizer()
    jmesh42 = jmesh.make_mesh(4, 2)
    p2, s2, at, _ = jtr.load_train_state(str(tmp_path), jopt)
    assert at == 1
    p2, s2 = jmesh.shard_params(p2, jmesh42), jtr._shard_opt_state(s2, jmesh42)
    p3, _, jloss = jtr.make_train_step(JCFG, jopt, jmesh42)(p2, s2, _jax_batch(*batch))
    np.testing.assert_allclose(float(jloss), float(loss), rtol=LOSS_REL)
    _assert_step_close(_np_tree(p3), want, grads[True])

    one, one_state, _, _ = ttr.load_train_state(str(tmp_path), opt, "cpu")
    _, _, one_loss = ttr.make_train_step(TCFG)(one, one_state, _port_batch(*batch))
    np.testing.assert_allclose(float(one_loss), float(loss), rtol=LOSS_REL)
    _assert_step_close(_np_tree(one), want, grads[True])


def test_train_loop_on_a_mesh_checkpoints_and_resumes(tmp_path):
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    data = ttr.synthetic_dataset(TCFG, CharTokenizer.synthetic(), batch_size=4, seq_len=8)
    mesh = _cpu_mesh(2, 2)
    ckpt = str(tmp_path / "ckpt")
    grid, losses = ttr.train(TCFG, data, steps=2, checkpoint_dir=ckpt, log_every=1,
                             device="cpu", mesh=mesh)
    assert len(losses) == 2 and np.isfinite(losses).all() and len(grid) == 2
    _, losses2 = ttr.train(TCFG, data, steps=3, checkpoint_dir=ckpt, resume=True, log_every=1,
                           device="cpu", mesh=mesh)
    assert len(losses2) == 1
    with pytest.raises(ValueError, match="do not match device"):
        ttr.train(TCFG, data, steps=1, device="cpu",
                  mesh=meshlib.make_mesh(1, 2, devices=[torch.device("meta")] * 2))


def test_dryrun_multichip_on_8_cpu_devices(capsys):
    summary = dryrun_multichip(8, "cpu")
    assert summary["mesh"] == (4, 2) and summary["tokens"] == (16, 8)
    assert summary["tp_texts"] == summary["dp_texts"] == 8
    assert summary["det_pages"] == summary["craft_pages"] == summary["inpaint_regions"] == 9
    assert "dryrun_multichip ok" in capsys.readouterr().out
