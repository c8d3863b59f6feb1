"""The fused whole-layer step decode (``step_kernel="fused_layer"``) against
the JAX package, in float32 on the same numpy-made tiny weights:

- ``quantize_decoder`` and the int8 ``precompute_cross_kv_packed``: int8
  values exact, scales to 1e-6 relative;
- the plain versions of kernels J (``fused_self_attn_step``, over several
  steps, outputs and caches), K (``fused_cross_attn_step``, int8 and float
  weights x int8 and float cross-K/V, with and without the ``s_valid``
  mask) and B's int8 decoder form (``pre_ln=False``, ``post_ln=True``, erf
  GELU) against the JAX kernels run in interpret mode, to atol 2e-4 / rtol
  1e-3 (the bound tests/test_decode_layer.py holds the JAX kernel to);
- ``greedy_decode`` token for token and length for length: int8 decoder
  with int8 cross-K/V, float decoder with float slabs, ``stop_lengths`` with
  a ``max_length`` that is not a multiple of the chunk;
- the engine with ``serving_kernels=False`` on a ``fused_layer`` config:
  the JAX engine's strings.

Each package gets its own config (``port_config``)."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.engine import TpuMangaOcrEngine
from manga_ocr_tpu.models import decoder as jdec
from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models import quantize as jquant
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.tokenizer import CharTokenizer
from manga_ocr_tpu.ops import decode_layer as jdl
from manga_ocr_tpu.ops.fused_mlp import fused_mlp_block as jax_mlp
from manga_ocr_tpu_torch.engine import TorchMangaOcrEngine
from manga_ocr_tpu_torch.models import decoder as tdec
from manga_ocr_tpu_torch.models import model as tmdl
from manga_ocr_tpu_torch.models import quantize as tquant
from manga_ocr_tpu_torch.models.params import init_params_numpy, layer_params, params_from_jax
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer as PortTokenizer
from manga_ocr_tpu_torch.ops import decode_layer as tdl
from manga_ocr_tpu_torch.ops import fused_mlp as tm
from port_config import port_config

BATCH = 3
ATOL, RTOL = 2e-4, 1e-3


def _cfg(int8_cross=True, head="fused", vocab=512):
    cfg = MangaOCRConfig.tiny(vocab_size=vocab)
    return dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, step_kernel="fused_layer", head_kernel=head, cross_kv_int8=int8_cross,
    ))


def _setup(cfg, seed=0, std=0.1, quantized=True):
    """numpy params (decoder quantized by the JAX ``quantize_decoder`` when
    ``quantized``) and an encoder output."""
    np_params = init_params_numpy(port_config(cfg), seed, std=std)
    if quantized:
        np_params["decoder"] = jax.tree.map(np.asarray, jquant.quantize_decoder(np_params["decoder"]))
    rng = np.random.default_rng(seed + 11)
    enc = rng.normal(size=(BATCH, cfg.encoder.seq_len, cfg.encoder.hidden_size))
    return np_params, enc.astype(np.float32)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_quantize_decoder_matches_jax():
    cfg = _cfg()
    np_dec = init_params_numpy(port_config(cfg), 0, std=0.1)["decoder"]
    want = jax.tree.map(np.asarray, jquant.quantize_decoder(np_dec))
    got = tquant.quantize_decoder(params_from_jax(np_dec, "cpu"))
    paths = [p for p, _ in _leaves(want)]
    assert sorted(paths) == sorted(p for p, _ in _leaves(got))
    n_int8 = 0
    for path, w in _leaves(want):
        g = _at(got, path).numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        if w.dtype == np.int8:
            n_int8 += 1
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
    # self q/k/v/o, cross q/o, fc1, fc2; cross k/v stay float
    assert n_int8 == 8 and "kernel" in got["layers"]["cross_attn"]["k"]


@pytest.mark.parametrize("int8", [True, False], ids=["int8", "float"])
def test_precompute_cross_kv_packed_matches_jax(int8):
    cfg = _cfg(int8_cross=int8)
    np_params, enc = _setup(cfg, seed=1)
    want = jdec.precompute_cross_kv_packed(np_params["decoder"], jnp.asarray(enc), cfg.decoder)
    got = tdec.precompute_cross_kv_packed(params_from_jax(np_params["decoder"], "cpu"),
                                          torch.from_numpy(enc), port_config(cfg).decoder)
    assert (got.k_scale is None) == (not int8)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if w.dtype == np.int8:
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(g.numpy(), w)
        elif int8:  # the f32 scales
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)


def _layer0(np_dec):
    return jax.tree.map(lambda a: a[0], np_dec["layers"])


@pytest.mark.parametrize("quantized", [True, False], ids=["int8_w", "float_w"])
def test_self_attn_step_plain_matches_jax_kernel(quantized):
    """Kernel J over steps 0..3 of an 8-row cache: outputs and caches."""
    cfg = _cfg()
    np_params, _ = _setup(cfg, seed=2, quantized=quantized)
    jlp = _layer0(np_params["decoder"])
    tlp = layer_params(params_from_jax(np_params["decoder"], "cpu")["layers"], 0)
    w = tdl.prepare_self_attn(tlp["self_attn"], torch.float32)
    d, heads, eps = cfg.decoder.hidden_size, cfg.decoder.num_heads, cfg.decoder.layer_norm_eps
    rng = np.random.default_rng(3)
    jck = jcv = jnp.zeros((8, BATCH, d), jnp.float32)
    tck, tcv = torch.zeros((8, BATCH, d)), torch.zeros((8, BATCH, d))
    for step in range(4):
        x = rng.normal(size=(BATCH, d)).astype(np.float32)
        jx, jck, jcv = jdl.fused_self_attn_step(jnp.asarray(x), jlp["self_attn"], jlp["self_ln"],
                                                jck, jcv, jnp.int32(step), num_heads=heads,
                                                eps=eps)
        tx, tck, tcv = tdl.fused_self_attn_step(torch.from_numpy(x), w, tlp["self_ln"], tck, tcv,
                                                step, heads, eps)
        np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tck.numpy(), np.asarray(jck), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tcv.numpy(), np.asarray(jcv), atol=ATOL, rtol=RTOL)
    assert float(tck[3].abs().sum()) > 0 and float(tck[4:].abs().sum()) == 0


@pytest.mark.parametrize("s_cut", [0, 2], ids=["all_keys", "s_valid"])
@pytest.mark.parametrize("int8_kv", [True, False], ids=["int8_kv", "float_kv"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8_w", "float_w"])
def test_cross_attn_step_plain_matches_jax_kernel(quantized, int8_kv, s_cut):
    cfg = _cfg(int8_cross=int8_kv)
    np_params, enc = _setup(cfg, seed=4, quantized=quantized)
    cross = jdec.precompute_cross_kv_packed(np_params["decoder"], jnp.asarray(enc), cfg.decoder)
    s_len = enc.shape[1]
    jlp = _layer0(np_params["decoder"])
    tlp = layer_params(params_from_jax(np_params["decoder"], "cpu")["layers"], 0)
    w = tdl.prepare_cross_attn(tlp["cross_attn"], torch.float32)
    d, heads, eps = cfg.decoder.hidden_size, cfg.decoder.num_heads, cfg.decoder.layer_norm_eps
    x = np.random.default_rng(5).normal(size=(BATCH, d)).astype(np.float32)
    ks = None if cross.k_scale is None else cross.k_scale[0]
    vs = None if cross.v_scale is None else cross.v_scale[0]
    want = jdl.fused_cross_attn_step(jnp.asarray(x), jlp["cross_attn"], jlp["cross_ln"],
                                     cross.k[0], cross.v[0], ks, vs, num_heads=heads, eps=eps,
                                     s_valid=s_len - s_cut)

    def t(a):
        return None if a is None else torch.from_numpy(np.array(a))

    got = tdl.fused_cross_attn_step(torch.from_numpy(x), w, tlp["cross_ln"], t(cross.k[0]),
                                    t(cross.v[0]), t(ks), t(vs), heads, eps, s_len - s_cut)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)


def test_mlp_step_form_plain_matches_jax_kernel():
    """Kernel B's int8 decoder form: LN(x + MLP(x)), erf GELU, on [B, D]
    rows, through the wrapper (prepared ``Int8Weight``) and the plain
    version."""
    cfg = _cfg()
    np_params, _ = _setup(cfg, seed=6)
    jlp = _layer0(np_params["decoder"])
    tlp = layer_params(params_from_jax(np_params["decoder"], "cpu")["layers"], 0)
    x = np.random.default_rng(7).normal(size=(BATCH, cfg.decoder.hidden_size)).astype(np.float32)
    fc1, fc2 = jlp["mlp"]["fc1"], jlp["mlp"]["fc2"]
    want = jax_mlp(jnp.asarray(x), jlp["mlp_ln"]["scale"], jlp["mlp_ln"]["bias"],
                   (fc1["w_q"], fc1["scale"]), fc1["bias"], (fc2["w_q"], fc2["scale"]), fc2["bias"],
                   eps=cfg.decoder.layer_norm_eps, pre_ln=False, post_ln=True)
    t1, t2 = tlp["mlp"]["fc1"], tlp["mlp"]["fc2"]
    args = (torch.from_numpy(x), tlp["mlp_ln"]["scale"], tlp["mlp_ln"]["bias"],
            tm.int8_weight(t1["w_q"], t1["scale"]), t1["bias"],
            tm.int8_weight(t2["w_q"], t2["scale"]), t2["bias"])
    kw = dict(eps=cfg.decoder.layer_norm_eps, pre_ln=False, post_ln=True)
    before = tm.fused_mlp_block.launches
    got = tm.fused_mlp_block(*args, **kw)
    assert tm.fused_mlp_block.launches == before  # the CPU takes the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(got, tm.fused_mlp_block_reference(*args, **kw), atol=0, rtol=0)


def _both(cfg, np_params, enc, max_length=None, chunk_size=8, stops=None):
    fn = jax.jit(functools.partial(jmdl.greedy_decode, cfg=cfg, max_length=max_length,
                                   chunk_size=chunk_size))
    want = fn(np_params, jnp.asarray(enc),
              stop_lengths=None if stops is None else jnp.asarray(stops, jnp.int32))
    got = tmdl.greedy_decode(
        params_from_jax(np_params, "cpu"), torch.from_numpy(enc), port_config(cfg), max_length,
        chunk_size, stop_lengths=None if stops is None else torch.tensor(stops, dtype=torch.int32),
    )
    return (np.asarray(want.tokens), np.asarray(want.lengths)), (got.tokens.numpy(),
                                                                 got.lengths.numpy())


@pytest.mark.parametrize("form", ["int8_decoder_int8_cross", "float_decoder_float_cross"])
def test_greedy_decode_matches_jax_exactly(form):
    quantized = form.startswith("int8")
    cfg = _cfg(int8_cross=quantized)
    np_params, enc = _setup(cfg, seed=8, quantized=quantized)
    (jt, jl), (tt, tln) = _both(cfg, np_params, enc)
    assert tt.shape == (BATCH, cfg.max_length) and tt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
    assert len({tuple(r) for r in tt}) > 1  # rows differ: the input matters


def test_stop_lengths_and_ragged_max_length_match_jax():
    """max_length 13 in chunks of 5: the last chunk runs to step 15."""
    cfg = _cfg()
    np_params, enc = _setup(cfg, seed=9)
    stops = [2, 6, 30]
    (jt, jl), (tt, tln) = _both(cfg, np_params, enc, max_length=13, chunk_size=5, stops=stops)
    assert tt.shape == (BATCH, 13)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
    assert tln[0] == 2 and tln[1] == 6 and (tt[0, 2:] == cfg.decoder.pad_token_id).all()


def test_fused_layer_counts_no_cpu_launches():
    cfg = _cfg()
    np_params, enc = _setup(cfg, seed=10)
    wrappers = (tdl.fused_self_attn_step, tdl.fused_cross_attn_step, tm.fused_mlp_block)
    before = [w.launches for w in wrappers]
    tmdl.greedy_decode(params_from_jax(np_params, "cpu"), torch.from_numpy(enc),
                       port_config(cfg), 6)
    assert [w.launches for w in wrappers] == before


def test_reference_engine_on_fused_layer_config_matches_jax_engine():
    cfg = _cfg(int8_cross=False, head="xla", vocab=100)
    np_params = init_params_numpy(port_config(cfg), 0, std=0.1)
    crops = [np.random.default_rng(i).integers(0, 256, size=(40 + 20 * i, 60, 3), dtype=np.uint8)
             for i in range(4)]
    jax_engine = TpuMangaOcrEngine(np_params, cfg, CharTokenizer.synthetic(), max_length=10,
                                   dtype=jnp.float32, serving_kernels=False)
    torch_engine = TorchMangaOcrEngine(
        params_from_jax(np_params, "cpu"), port_config(cfg), PortTokenizer.synthetic(),
        max_length=10, dtype=torch.float32, device="cpu", serving_kernels=False,
    )
    assert torch_engine.cfg.decoder.step_kernel == "fused_layer"
    got = torch_engine.ocr_page(crops)
    assert got == jax_engine.ocr_page(crops)
    assert len(set(got)) > 1
