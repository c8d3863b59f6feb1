"""Kernel C's plain version against the JAX ``greedy_decode_loop`` (interpret
mode on the CPU) in float32 on the same tiny weights and encoder output:
tokens and lengths must be EXACT, as in tests/test_decode_loop.py.  Every
form of the JAX kernel: bf16 and int8 (``quantize_decoder``) decoder
weights; precomputed slabs (float, or int8 ones, which both dequantize) and
``fuse_kv`` (the raw encoder output, its final LN and the cross-K/V
projections in the loop, also on JAX's own seq-padded encoder output);
``ablate`` of each stage; the sigmoid GELU; the TPU scheduling knobs, which
change no token and must be positive.  Also the ``stop_lengths`` instrument,
the EOS done-masking, the cross-K/V precompute, and the teacher-forced
scorer used on the card; and, for the CUDA path, which kernel takes which
form and shape (the cluster kernel or the present one), its refusals, its
split plan, the decoder weights each kernel reads, prepared once per set of
params, and ``fuse_kv``'s prologue before the cluster kernel (its launchers
swapped for plain versions of their contracts): its slabs against the plain
version's bit for bit and against the JAX package's cross-K/V precompute."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from manga_ocr_tpu.models import decoder as jdec
from manga_ocr_tpu.models import model as jmdl
from manga_ocr_tpu.models import vit as jvit
from manga_ocr_tpu.models.config import MangaOCRConfig
from manga_ocr_tpu.models.quantize import quantize_decoder as jax_quantize_decoder
from manga_ocr_tpu.ops.decode_loop import greedy_decode_loop as jax_loop
from manga_ocr_tpu_torch.models import decoder as tdec
from manga_ocr_tpu_torch.models import model as tmdl
from manga_ocr_tpu_torch.models.params import init_params_numpy, params_from_jax
from manga_ocr_tpu_torch.ops import decode_loop as tl
from manga_ocr_tpu_torch.ops import encoder_weights as ew
from manga_ocr_tpu_torch.ops.common import layer_norm
from port_config import port_config
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

STEPS = 11
S_PAD, S_VALID = 8, 5  # fuse_kv: raw encoder rows, of which the first S_VALID are real


def _setup(std, seed=0, batch=4, int8_w=False):
    """The JAX config (``_both`` hands the port its own), the decoder's
    numpy weights (JAX-quantized for ``int8_w``) and an encoder output."""
    cfg = MangaOCRConfig.tiny()
    np_dec = init_params_numpy(cfg, seed, std=std)["decoder"]
    if int8_w:
        np_dec = jax.tree.map(np.asarray, jax_quantize_decoder(np_dec))
    enc = np.random.default_rng(seed + 7).normal(size=(batch, cfg.encoder.seq_len, 64))
    return cfg, np_dec, enc.astype(np.float32)


def _raw_encoder(seed, batch=4, d=64):
    """A raw (pre-final-LN) encoder output of S_PAD rows and a final LN."""
    rng = np.random.default_rng(seed + 13)
    raw = (2.0 * rng.normal(size=(batch, S_PAD, d)) + 0.5).astype(np.float32)
    ln = {"scale": (1 + 0.2 * rng.normal(size=(d,))).astype(np.float32),
          "bias": (0.2 * rng.normal(size=(d,))).astype(np.float32)}
    return raw, ln


def _run_both(cfg, np_dec, cross_j, cross_t, stops=None, **kw):
    """The JAX kernel and the port's wrapper on the same inputs; ``kw`` go
    to both (numpy values become each package's arrays)."""
    def conv(v, mod):
        if isinstance(v, np.ndarray):
            return jnp.asarray(v) if mod == "jax" else torch.from_numpy(v)
        if isinstance(v, dict):
            return {k: conv(a, mod) for k, a in v.items()}
        return v

    jt, jl = jax_loop(np_dec, cross_j, cfg.decoder, steps=STEPS, dtype=jnp.float32,
                      stop_lengths=None if stops is None else jnp.asarray(stops, jnp.int32),
                      **{k: conv(v, "jax") for k, v in kw.items()})
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    tt, tln = tl.greedy_decode_loop(
        tdp, cross_t(tdp, tcfg) if callable(cross_t) else cross_t, tcfg, STEPS,
        dtype=torch.float32,
        stop_lengths=None if stops is None else torch.tensor(stops, dtype=torch.int32),
        **{k: conv(v, "torch") for k, v in kw.items()},
    )
    return (np.asarray(jt), np.asarray(jl)), (tt.numpy(), tln.numpy())


def _both(cfg, np_dec, enc, stops=None, **kw):
    """Precomputed float slabs from ``enc``."""
    jcross = jdec.precompute_cross_kv_packed(np_dec, jnp.asarray(enc), cfg.decoder, int8=False)
    return _run_both(cfg, np_dec, jcross,
                     lambda tdp, tcfg: tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc),
                                                                       tcfg),
                     stops, **kw)


def _assert_same(pair):
    (jt, jl), (tt, tln) = pair
    assert tt.shape == jt.shape and tt.dtype == np.int32
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tln, jl)
    return tt, tln


@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
@pytest.mark.parametrize("std", [0.02, 0.1], ids=["hf_init", "wide"])
def test_plain_version_matches_jax_kernel_exactly(std, int8_w):
    cfg, np_dec, enc = _setup(std, int8_w=int8_w)
    tt, _ = _assert_same(_both(cfg, np_dec, enc, head_phased=True))
    assert tt.shape == (4, STEPS + 1)


@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_stop_lengths_match_jax_kernel(int8_w):
    cfg, np_dec, enc = _setup(0.1, seed=1, int8_w=int8_w)
    stops = [2, 5, 9, 12]
    _, tln = _assert_same(_both(cfg, np_dec, enc, stops, head_phased=True))
    assert (tln <= np.asarray(stops)).all()


def test_int8_w_with_phased_head_and_chains_matches_jax():
    """JAX schedules the int8 form with two chains and the phased head
    (tests/test_decode_loop.py); the port runs the same tokens."""
    cfg, np_dec, enc = _setup(0.1, seed=2, int8_w=True)
    _assert_same(_both(cfg, np_dec, enc, head_phased=True, chains=2))


def test_int8_cross_slabs_are_dequantized_as_in_jax():
    """Int8 slabs with scales: both dequantize them before the loop."""
    cfg, np_dec, enc = _setup(0.1, seed=3)
    jcross = jdec.precompute_cross_kv_packed(np_dec, jnp.asarray(enc), cfg.decoder, int8=True)
    tcross = tdec.CrossKVPacked(*(torch.from_numpy(np.array(a)) for a in jcross))
    assert tcross.k.dtype == torch.int8
    tt, _ = _assert_same(_run_both(cfg, np_dec, jcross, tcross))
    assert len({tuple(r) for r in tt}) > 1


@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_fuse_kv_matches_jax_kernel(int8_w):
    """fuse_kv on a raw encoder output of S_PAD rows, S_VALID real: the
    final LN (the decoder's eps) and the cross projections in the loop; the
    pad rows are never attended."""
    cfg, np_dec, _ = _setup(0.1, seed=4, int8_w=int8_w)
    raw, ln = _raw_encoder(4)
    tt, _ = _assert_same(_run_both(cfg, np_dec, None, None, enc_raw=raw, s_valid=S_VALID,
                                   enc_final_ln=ln))
    assert len({tuple(r) for r in tt}) > 1
    # the pad rows' values reach no token
    raw2 = raw.copy()
    raw2[:, S_VALID:] = 1e3
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    t2, _ = tl.greedy_decode_loop(tdp, None, tcfg, STEPS, dtype=torch.float32,
                                  enc_raw=torch.from_numpy(raw2), s_valid=S_VALID,
                                  enc_final_ln={k: torch.from_numpy(v) for k, v in ln.items()})
    np.testing.assert_array_equal(t2.numpy(), tt)


def test_fuse_kv_equals_precomputed_slabs_of_the_final_ln():
    """fuse_kv's slabs are the precompute's on the LN'd encoder rows."""
    cfg, np_dec, _ = _setup(0.1, seed=5)
    raw, ln = _raw_encoder(5)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    tln = {k: torch.from_numpy(v) for k, v in ln.items()}
    enc = layer_norm(torch.from_numpy(raw[:, :S_VALID]), tln["scale"], tln["bias"],
                     tcfg.layer_norm_eps)
    want = tl.greedy_decode_loop(tdp, tdec.precompute_cross_kv_packed(tdp, enc, tcfg), tcfg,
                                 STEPS, dtype=torch.float32)
    got = tl.greedy_decode_loop(tdp, None, tcfg, STEPS, dtype=torch.float32,
                                enc_raw=torch.from_numpy(raw), s_valid=S_VALID, enc_final_ln=tln)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("int8_w", [False, True], ids=["bf16_w", "int8_w"])
def test_fuse_kv_on_jax_seq_padded_encoder_output(int8_w):
    """JAX's own raw encoder output, seq-padded 5 -> 8 (``seq_pad_to=8``,
    the pads row-local garbage), fed straight to both decodes with
    ``s_valid``, as tests/test_decode_loop.py does through ocr_forward."""
    cfg = MangaOCRConfig.tiny()
    params = init_params_numpy(cfg, 6, std=0.1)
    ecfg = dataclasses.replace(cfg.encoder, attn_kernel="fused_layer", mlp_kernel="fused",
                               seq_pad_to=S_PAD)
    px = np.random.default_rng(6).normal(size=(4, 32, 32, 3)).astype(np.float32)
    jenc = jax.tree.map(jnp.asarray, params["encoder"])
    raw = np.asarray(jvit.encode(jenc, jnp.asarray(px), ecfg, raw_padded=True))
    assert raw.shape == (4, S_PAD, 64)
    np_dec = params["decoder"]
    if int8_w:
        np_dec = jax.tree.map(np.asarray, jax_quantize_decoder(np_dec))
    tt, _ = _assert_same(_run_both(cfg, np_dec, None, None, enc_raw=raw,
                                   s_valid=cfg.encoder.seq_len,
                                   enc_final_ln=params["encoder"]["final_ln"]))
    assert len({tuple(r) for r in tt}) > 1


@pytest.mark.parametrize("stage", ["self", "cross", "mlp", "head"])
def test_ablate_matches_jax_kernel(stage):
    """Each stage skipped; under "head" the next token is prev + 1 (BOS + 1
    is EOS with the default ids, so every row stops at step 1)."""
    cfg, np_dec, enc = _setup(0.1, seed=7)
    tt, tln = _assert_same(_both(cfg, np_dec, enc, ablate=stage))
    if stage == "head":
        np.testing.assert_array_equal(tt[:, 1], cfg.decoder.bos_token_id + 1)
        np.testing.assert_array_equal(tln, 2)


def test_ablate_head_embeds_ids_past_the_vocab_as_zero_rows():
    """prev + 1 walks past the vocab when EOS is out of reach: JAX's one-hot
    embeds such an id as a zero row; the port's gather must not index past
    its table."""
    cfg, np_dec, enc = _setup(0.1, seed=8)
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(
        cfg.decoder, vocab_size=8, eos_token_id=100))
    np_dec = dict(np_dec, tok_embed=np_dec["tok_embed"][:8],
                  head=dict(np_dec["head"], proj={k: v[..., :8] for k, v in
                                                  np_dec["head"]["proj"].items()}))
    tt, tln = _assert_same(_both(cfg, np_dec, enc, ablate="head"))
    np.testing.assert_array_equal(tt, [list(range(2, STEPS + 3))] * 4)
    np.testing.assert_array_equal(tln, STEPS + 1)


def test_sigmoid_gelu_matches_jax_kernel():
    cfg, np_dec, enc = _setup(0.1, seed=9)
    _assert_same(_both(cfg, np_dec, enc, gelu_mode="sigmoid"))


@pytest.mark.parametrize("knobs", [dict(chains=2), dict(group=8, vocab_tile=64),
                                   dict(vmem_budget_mb=16, interpret=True, head_phased=False)],
                         ids=["chains", "group_vocab_tile", "vmem_interpret"])
def test_scheduling_knobs_change_no_token(knobs):
    cfg, np_dec, enc = _setup(0.1, seed=10)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg)
    base = tl.greedy_decode_loop(tdp, cross, tcfg, STEPS)
    for g, w in zip(tl.greedy_decode_loop(tdp, cross, tcfg, STEPS, **knobs), base):
        torch.testing.assert_close(g, w, atol=0, rtol=0)


@pytest.mark.parametrize("bad", [dict(chains=0), dict(group=-8), dict(vocab_tile=0),
                                 dict(vmem_budget_mb=1.5), dict(gelu_mode="tanh"),
                                 dict(ablate=["head"])],
                         ids=["chains", "group", "vocab_tile", "vmem_budget_mb", "gelu_mode",
                              "ablate"])
def test_bad_options_raise(bad):
    cfg, np_dec, enc = _setup(0.02)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg)
    for fn in (tl.greedy_decode_loop, tl.greedy_decode_loop_reference):
        with pytest.raises(ValueError):
            fn(tdp, cross, tcfg, STEPS, **bad)


def test_cross_source_must_be_one_of_two():
    cfg, np_dec, enc = _setup(0.02)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), tcfg)
    for c, raw in ((None, None), (cross, torch.from_numpy(enc))):
        with pytest.raises(ValueError, match="not both"):
            tl.greedy_decode_loop(tdp, c, tcfg, STEPS, enc_raw=raw)


def test_model_greedy_decode_on_int8_decoder_matches_jax():
    """``model.greedy_decode`` under ``fused_loop`` on quantize_decoder
    params (kernel C's int8_w form over precomputed slabs)."""
    cfg = MangaOCRConfig.tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder,
                                                               step_kernel="fused_loop"))
    params = init_params_numpy(cfg, 11, std=0.1)
    params["decoder"] = jax.tree.map(np.asarray, jax_quantize_decoder(params["decoder"]))
    enc = np.random.default_rng(11).normal(size=(4, cfg.encoder.seq_len, 64)).astype(np.float32)
    want = jmdl.greedy_decode(jax.tree.map(jnp.asarray, params), jnp.asarray(enc), cfg,
                              max_length=12)
    got = tmdl.greedy_decode(params_from_jax(params, "cpu"), torch.from_numpy(enc),
                             port_config(cfg), max_length=12)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert len({tuple(r) for r in got.tokens.numpy()}) > 1


def test_eos_done_masking_matches_jax_kernel():
    """A head biased toward EOS: every row emits EOS at the first step, then
    PAD, and stops counting."""
    cfg, np_dec, enc = _setup(0.02, seed=2)
    d = cfg.decoder
    np_dec["head"]["proj"]["bias"] = np_dec["head"]["proj"]["bias"].copy()
    np_dec["head"]["proj"]["bias"][d.eos_token_id] = 1e4
    tt, tln = _assert_same(_both(cfg, np_dec, enc, head_phased=True))
    np.testing.assert_array_equal(tt[:, 1], d.eos_token_id)
    assert (tt[:, 2:] == d.pad_token_id).all()
    np.testing.assert_array_equal(tln, 2)


def test_cross_kv_precompute_matches_jax():
    cfg, np_dec, enc = _setup(0.1, seed=3)
    want = jdec.precompute_cross_kv_packed(np_dec, jnp.asarray(enc), cfg.decoder, int8=False)
    got = tdec.precompute_cross_kv_packed(params_from_jax(np_dec, "cpu"), torch.from_numpy(enc),
                                          port_config(cfg).decoder)
    np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.v.numpy(), np.asarray(want.v), atol=1e-5, rtol=1e-5)


def test_embed_matches_jax():
    cfg, np_dec, _ = _setup(0.1, seed=4)
    toks = np.array([[2, 5, 7], [3, 0, 9]], np.int32)
    want = jdec.embed(np_dec, jnp.asarray(toks), 4, cfg.decoder)
    got = tdec.embed(params_from_jax(np_dec, "cpu"), torch.from_numpy(toks), 4,
                     port_config(cfg).decoder)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_teacher_forced_gaps_are_zero_on_own_tokens_in_bf16():
    cfg, np_dec, enc = _setup(0.1, seed=5)
    tdp, tcfg = params_from_jax(np_dec, "cpu"), port_config(cfg).decoder
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc).bfloat16(), tcfg)
    tokens, lengths = tl.greedy_decode_loop(tdp, cross, tcfg, STEPS)
    gaps, top = tl.teacher_forced_gaps(tdp, cross, tcfg, tokens)
    assert gaps.shape == top.shape == (4, STEPS)
    live = torch.arange(STEPS)[None, :] + 1 < lengths[:, None]
    assert float(gaps[live].abs().max()) == 0.0
    # a token that is not the argmax shows a positive gap
    forced = tokens.clone()
    forced[:, 1] = (forced[:, 1] + 1) % cfg.decoder.vocab_size
    gaps2, _ = tl.teacher_forced_gaps(tdp, cross, tcfg, forced)
    assert bool((gaps2[:, 0] > 0).all())


def test_wrapper_counts_no_cpu_launches():
    cfg, np_dec, enc = _setup(0.02)
    tdp = params_from_jax(np_dec, "cpu")
    cross = tdec.precompute_cross_kv_packed(tdp, torch.from_numpy(enc), port_config(cfg).decoder)
    before = (tl.greedy_decode_loop.launches, dict(tl.greedy_decode_loop.launches_by_form),
              tdec.precompute_cross_kv_packed.calls)
    tl.greedy_decode_loop(tdp, cross, port_config(cfg).decoder, 3)
    tl.greedy_decode_loop(tdp, None, port_config(cfg).decoder, 3, enc_raw=torch.from_numpy(enc))
    assert (tl.greedy_decode_loop.launches, tl.greedy_decode_loop.launches_by_form,
            tdec.precompute_cross_kv_packed.calls) == before


# -- the serving form's cluster kernel: choice, refusals, prepared weights ----


def _tiny_port(std=0.02, seed=12, **decoder):
    """The port's tiny config (decoder fields replaced) and its decoder
    params from the JAX package's numpy weights."""
    cfg = MangaOCRConfig.tiny()
    cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(cfg.decoder, **decoder))
    np_dec = init_params_numpy(cfg, seed, std=std)["decoder"]
    return port_config(cfg).decoder, params_from_jax(np_dec, "cpu")


@pytest.mark.parametrize("case,want", [
    (dict(), "cluster"),
    (dict(int8_w=True), "cluster"),  # the int8 instance
    (dict(fuse_kv=True), "cluster"),  # after cross_kv_prologue
    (dict(int8_w=True, fuse_kv=True), "cluster"),  # the prologue, then the int8 instance
    (dict(fuse_kv=True, hidden_size=96, num_heads=2), "loop"),  # K = 96: not a multiple of 64
    (dict(stages=tl._SELF), "loop"),
    (dict(gelu_mode="sigmoid"), "loop"),
    (dict(num_heads=8), "loop"),  # dh = 8: not a multiple of 16
    (dict(num_heads=2), "cluster"),  # dh = 32
    (dict(intermediate_size=80), "loop"),  # I % 32 != 0, 20 columns a CTA
    (dict(steps=4000), "loop"),  # the scores of 4000 steps overflow shared memory
    (dict(intermediate_size=96), "cluster"),  # bf16: 24 columns a CTA
    (dict(int8_w=True, intermediate_size=96), "loop"),  # int8: I % 64 != 0
    (dict(int8_w=True, stages=tl._MLP), "loop"),
], ids=["serving", "int8_w", "fuse_kv", "int8_w+fuse_kv", "fuse_kv_d96", "ablate", "sigmoid",
        "dh8", "dh32", "inter80", "steps", "inter96", "int8_w_inter96", "int8_w+ablate"])
def test_decode_form_chooses_cluster_for_all_but_the_diagnosis_forms(case, want):
    case = dict(case)
    int8_w, fuse_kv = case.pop("int8_w", False), case.pop("fuse_kv", False)
    stages, gelu = case.pop("stages", 0), case.pop("gelu_mode", "erf")
    steps = case.pop("steps", STEPS)
    cfg, tdp = _tiny_port(**case)
    if int8_w:
        from manga_ocr_tpu_torch.models.quantize import quantize_decoder
        tdp = quantize_decoder(tdp)
    assert tl.decode_form(tdp, cfg, steps, 5, fuse_kv, stages, gelu) == want


@pytest.mark.parametrize("bad", [
    dict(kernel="cluster", ablate="mlp"), dict(kernel="cluster", gelu_mode="sigmoid"),
    dict(kernel="cluster", int8_w=True, ablate="cross"),
    dict(kernel="cluster", int8_w=True, gelu_mode="sigmoid"),
    dict(kernel="cluster", num_heads=8), dict(kernel="tiled"),
], ids=["ablate", "sigmoid", "int8_w+ablate", "int8_w+sigmoid", "dh8", "kernel"])
def test_cluster_refusals_raise_before_any_build(bad):
    """What the cluster kernel does not take raises ValueError in the
    wrapper, before any build (here, with no nvcc, a build would raise
    something else), whatever the device."""
    bad = dict(bad)
    int8_w, fuse_kv = bad.pop("int8_w", False), bad.pop("fuse_kv", False)
    heads = bad.pop("num_heads", None)
    cfg, tdp = _tiny_port(**({} if heads is None else {"num_heads": heads}))
    if int8_w:
        from manga_ocr_tpu_torch.models.quantize import quantize_decoder
        tdp = quantize_decoder(tdp)
    enc = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32))
    cross = tdec.precompute_cross_kv_packed(tdp, enc, cfg)
    src = dict(cross=None, enc_raw=enc) if fuse_kv else dict(cross=cross)
    with pytest.raises(ValueError):
        tl.greedy_decode_loop(tdp, cfg=cfg, steps=STEPS, **src, **bad)


def test_cluster_choice_runs_the_plain_version_on_the_cpu():
    cfg, tdp = _tiny_port(std=0.1)
    enc = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 5, 64)).astype(np.float32))
    cross = tdec.precompute_cross_kv_packed(tdp, enc, cfg)
    want = tl.greedy_decode_loop_reference(tdp, cross, cfg, STEPS)
    for kernel in ("cluster", "loop", "auto"):
        got = tl.greedy_decode_loop(tdp, cross, cfg, STEPS, kernel=kernel)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=0, rtol=0)


def _unpack_fragments(packed: torch.Tensor) -> torch.Tensor:
    """The [K, N] matrix the cluster kernel multiplies by, read from a
    ``pack_fragments`` layout by the kernel's own index formulas: the
    m16n8k16 bf16 B fragment (two values a register), or the m16n8k32 s8
    one (four; int8 weights)."""
    heads, nt, n_pairs, _, _ = packed.shape
    h, j, p, lane, x = torch.meshgrid(*(torch.arange(s) for s in packed.shape), indexing="ij")
    if packed.dtype == torch.int8:  # k = 64p + 32 (r/2) + 16 (r%2) + 4 (lane%4) + e
        r, e = x // 4, x % 4
        kk = 64 * p + 32 * (r // 2) + 16 * (r % 2) + 4 * (lane % 4) + e
    else:
        r, e = x // 2, x % 2
        kk = 32 * p + 16 * (r // 2) + 8 * (r % 2) + 2 * (lane % 4) + e
    nn = h * nt * 8 + 8 * j + lane // 4
    w = torch.zeros((int(kk.max()) + 1, heads * nt * 8), dtype=packed.dtype)
    w[kk.reshape(-1), nn.reshape(-1)] = packed.reshape(-1).cpu()
    return w


def test_cluster_layout_reproduces_the_plain_projections():
    """Each weight the cluster kernel reads, unpacked by the kernel's own
    fragment formulas, is CTA h's column slice of the plain projection:
    self q|k|v as [q_h | k_h | v_h], the others in column order, the vocab
    padded with zero columns; x times it is the plain product's slice."""
    cfg, tdp = _tiny_port(std=0.1)
    heads, d = cfg.num_heads, cfg.hidden_size
    dh = d // heads
    common, layers = tl.cluster_weights(tdp, heads)
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(16, 3 * d)).astype(np.float32))
    x = x.bfloat16().float()

    def check(packed, bias, w_plain, b_plain):
        w = _unpack_fragments(packed)
        assert w.shape == w_plain.shape
        assert torch.equal(w, w_plain.to(torch.bfloat16))
        k = w.shape[0]
        torch.testing.assert_close(x[:, :k] @ w.float() + bias, x[:, :k] @ w_plain.bfloat16().float()
                                   + b_plain, atol=0, rtol=0)

    lp = tdp["layers"]
    for l, w in enumerate(layers):
        sa = lp["self_attn"]
        cols = [sa[n]["kernel"][l][:, h * dh:(h + 1) * dh] for h in range(heads)
                for n in ("q", "k", "v")]
        bias = [sa[n]["bias"][l][h * dh:(h + 1) * dh] for h in range(heads) for n in ("q", "k", "v")]
        check(w[0], w[1], torch.cat(cols, 1), torch.cat(bias))
        for i, (a, n) in ((2, ("self_attn", "o")), (6, ("cross_attn", "q")),
                          (8, ("cross_attn", "o")), (12, ("mlp", "fc1")), (14, ("mlp", "fc2"))):
            dense = lp[a][n]
            check(w[i], w[i + 1], dense["kernel"][l], dense["bias"][l].float())
    head = tdp["head"]
    check(common[5], common[6], head["transform"]["dense"]["kernel"],
          head["transform"]["dense"]["bias"].float())
    vocab = cfg.vocab_size
    vs = tl.vocab_slice(vocab, heads)
    assert vs % 8 == 0 and heads * vs >= vocab
    wp = torch.zeros((d, heads * vs))
    wp[:, :vocab] = head["proj"]["kernel"]
    bp = torch.zeros(heads * vs)
    bp[:vocab] = head["proj"]["bias"]
    check(common[9], common[10], wp, bp)


def test_int8_cluster_layout_reproduces_the_int8_products_per_head_slice():
    """The int8 instance's weights (quantize_decoder), unpacked by the
    kernel's s8 fragment formulas, are each projection's int8 weight with
    its scales and bias in CTA h's column order; per head slice, the exact
    int32 product of quant_rows(x) with the unpacked slice equals
    ``int8_matmul(hq, w)``'s columns, and the epilogue (acc * sx) * s + b
    gives the plain ``_proj`` bit for bit.  Prepared once, under a key of
    its own beside the bf16 weights."""
    from manga_ocr_tpu_torch.models.quantize import quantize_decoder
    from manga_ocr_tpu_torch.ops.kernel_utils import int8_matmul, quant_rows

    cfg, tdp = _tiny_port(std=0.1)
    qdp = quantize_decoder(tdp)
    heads, d = cfg.num_heads, cfg.hidden_size
    dh = d // heads
    common, layers = tl.cluster_weights(qdp, heads)
    assert tl.cluster_weights(qdp, heads)[1] is layers
    assert tl.cluster_weights(tdp, heads)[1] is not layers  # the bf16 form's own key
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(16, 2 * d)).astype(np.float32))
    lp = qdp["layers"]
    for l, w in enumerate(layers):
        assert len(w) == 24  # 18 as the bf16 form's, then the six scales
        sa = lp["self_attn"]
        qkv = {k: torch.cat([sa[n][k][l][..., h * dh:(h + 1) * dh] for h in range(heads)
                             for n in ("q", "k", "v")], -1) for k in ("w_q", "scale", "bias")}
        denses = [qkv] + [{k: lp[a][n][k][l] for k in ("w_q", "scale", "bias")}
                          for a, n in (("self_attn", "o"), ("cross_attn", "q"),
                                       ("cross_attn", "o"), ("mlp", "fc1"), ("mlp", "fc2"))]
        for i, (wi, dense) in enumerate(zip((0, 2, 6, 8, 12, 14), denses)):
            packed, bias, scale = w[wi], w[wi + 1], w[18 + i]
            assert packed.dtype == torch.int8
            assert torch.equal(_unpack_fragments(packed), dense["w_q"])
            assert torch.equal(scale, dense["scale"].float())
            assert torch.equal(bias, dense["bias"].float())
            k, n = dense["w_q"].shape
            hq, sx = quant_rows(x[:, :k])
            ws = n // heads
            for h in range(heads):  # CTA h's slice, as the kernel reads it
                cols = slice(h * ws, (h + 1) * ws)
                acc = int8_matmul(hq, _unpack_fragments(packed[h:h + 1]))
                assert torch.equal(acc, int8_matmul(hq, dense["w_q"])[:, cols])
                got = acc.float() * sx * scale[cols] + bias[cols]
                want = tl._proj(x[:, :k], {"w": dense["w_q"], "s": dense["scale"].float(),
                                           "b": dense["bias"].float()}, torch.bfloat16)
                torch.testing.assert_close(got, want[:, cols], atol=0, rtol=0)


@pytest.mark.parametrize("layout", ["int8_w_gelu", "self_attn_ctx", "cross_attn_ctx"])
def test_cluster_wide_row_quantization_equals_quant_rows_bit_for_bit(layout):
    """Rows that live in slices, one per CTA of a cluster: the int8
    instance's GELU(fc1) rows (3072 wide, H slices), and the int8 context
    rows of kernels J and K (768 wide, one slice of H / c heads per CTA of
    the core's cluster, ``launch.attn_step_plan``).  Each CTA's slice max,
    the max of the maxima (exact and order-free), then each slice
    quantized with that amax (numpy f32, the kernels' order of operations)
    equal ``quant_rows`` of the whole row bit for bit, in the port and in
    the JAX package; zero rows included."""
    from manga_ocr_tpu.ops.kernel_utils import quant_rows as jax_quant_rows
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops.kernel_utils import quant_rows

    rng = np.random.default_rng(8)
    if layout == "int8_w_gelu":
        width, splits = 3072, (1, 2, 4, 8)
    else:
        width, cross = 768, layout.startswith("cross")
        splits = sorted({launch.attn_step_plan(1, h, width // h, 197 if cross else 305,
                                               1 if cross else 2, not cross)["cluster"]
                         for h in (1, 2, 3, 4, 6, 8, 12, 16)})
        assert splits == [1, 2, 4, 8]
    rows = (rng.normal(size=(64, width)) * rng.lognormal(size=(64, 1))).astype(np.float32)
    rows[3] = 0.0
    rows[5, 100] = 1e4  # one outlier sets its row's scale
    for heads in splits:
        slices = np.split(rows, heads, axis=1)
        amax = np.max([np.abs(sl).max(axis=1) for sl in slices], axis=0)
        amax = np.maximum(amax, np.float32(1e-8))
        inv = np.float32(127.0) / amax
        q = np.concatenate([np.rint(sl * inv[:, None]).astype(np.int8) for sl in slices], 1)
        sx = amax * np.float32(1.0 / 127.0)
        assert inv.dtype == sx.dtype == np.float32
        want_q, want_sx = quant_rows(torch.from_numpy(rows))
        np.testing.assert_array_equal(q, want_q.numpy())
        np.testing.assert_array_equal(sx, want_sx.numpy()[:, 0])
        jq, jsx = jax_quant_rows(jnp.asarray(rows))
        np.testing.assert_array_equal(q, np.asarray(jq))
        np.testing.assert_array_equal(sx, np.asarray(jsx)[:, 0])


def test_prepared_decoder_weights_are_made_once_and_anew_after_an_inplace_write():
    cfg, tdp = _tiny_port()
    loop, cluster = tl.loop_weights(tdp, False), tl.cluster_weights(tdp, cfg.num_heads)
    assert tl.loop_weights(tdp, False) is loop
    assert tl.cluster_weights(tdp, cfg.num_heads) is cluster
    assert tl.loop_weights(tdp, True) is not loop  # fuse_kv adds the cross k/v weights
    # no prepared tensor is a leaf of the params (the cache holds none)
    leaves = {t.data_ptr() for t in ew._leaves(tdp)}
    assert not leaves & {t.data_ptr() for t in cluster[0] + [u for w in cluster[1] for u in w]}
    fc1 = tdp["layers"]["mlp"]["fc1"]["kernel"]
    with torch.no_grad():
        fc1.add_(1.0)
    loop2, cluster2 = tl.loop_weights(tdp, False), tl.cluster_weights(tdp, cfg.num_heads)
    assert loop2 is not loop and cluster2 is not cluster
    assert not torch.equal(loop2[1][0][16], loop[1][0][16])  # layer 0's fc1 weight
    assert not torch.equal(cluster2[1][0][12], cluster[1][0][12])


@pytest.mark.parametrize("d,heads,inter,vocab,steps,s_len,int8", [
    (768, 8, 3072, 6144, 299, 197, False), (64, 4, 128, 100, 20, 5, False),
    (64, 2, 128, 100, 11, 5, False), (768, 8, 3072, 6144, 299, 197, True),
    (64, 4, 128, 100, 20, 5, True), (64, 2, 128, 100, 11, 5, True)],
    ids=["base", "tiny", "tiny_h2", "base_int8", "tiny_int8", "tiny_h2_int8"])
def test_cluster_plan_covers_every_projection(d, heads, inter, vocab, steps, s_len, int8):
    """Every projection's split walks whole k pairs (64 int8 values for the
    int8_w kernel's six layer projections, 32 bf16 otherwise); the int8_w
    kernel's shared memory adds two floats a row (its int8 rows live in
    the gathered-rows buffer, after its D-wide bf16 rows), and keeps the
    tile rule: 16 rows, up to 19 at full width."""
    plan = tl.cluster_plan(d, heads, inter, vocab, steps, s_len, int8)
    for i, (name, (k, n, kp, t)) in enumerate(plan["plans"].items()):
        pair = 64 if int8 and i < 6 else 32
        n_pairs, nt = k // pair, n // 8
        assert n % 8 == 0 and k % pair == 0 and n_pairs % kp == 0
        assert tl.CLUSTER_WARPS % kp == 0 and 1 <= t <= tl._MAX_TILES
        assert name != "vocab" or kp == 1
        assert nt >= 1
    assert plan["smem"] == tl.cluster_smem(16, d, heads, inter, steps, s_len, int8) \
        <= tl._SMEM_LIMIT
    extra = tl.cluster_smem(16, d, heads, inter, steps, s_len, True) - \
        tl.cluster_smem(16, d, heads, inter, steps, s_len)
    assert extra == 2 * 16 * 4  # the row scales and slice maxima
    if int8:  # bf16 rows (D + 8 apart) and int8 rows within the head's f32 rows
        assert (inter // heads) % 16 == 0 and inter % 64 == 0
        assert (d + 8) * 2 + d + 16 <= 4 * d
    if d == 768:  # B=256 on 15 seated clusters takes tiles of 18 rows
        assert tl.cluster_smem(19, d, heads, inter, steps, s_len, int8) <= 227 * 1024 - 1024
        assert tl.cluster_smem(20, d, heads, inter, steps, s_len, int8) > 227 * 1024


# -- fuse_kv on the cluster kernel: the prologue that writes its slabs ---------


def _plain_launchers(monkeypatch) -> dict:
    """``launch.ln_rows_bf16`` and ``launch.bf16_gemm`` swapped for plain
    torch versions of their contracts (the GEMM writing its ``out``);
    returns the calls made, by launcher."""
    from manga_ocr_tpu_torch.kernels import launch
    from manga_ocr_tpu_torch.ops.fused_mlp import bf16_gemm_reference
    from manga_ocr_tpu_torch.ops.kernel_utils import ln32

    calls = {"ln_rows_bf16": 0, "bf16_gemm": 0}

    def ln_rows(x, ln, eps):
        assert x.dtype == torch.bfloat16 and x.is_contiguous() and x.dim() == 2
        calls["ln_rows_bf16"] += 1
        return ln32(x, *ln, eps).to(torch.bfloat16)

    def gemm(a, b, bias, mode, residual=None, out=None):
        assert mode == launch.BF16_BIAS and residual is None
        assert a.is_contiguous() and out.is_contiguous() and out.shape == (a.shape[0], b.shape[1])
        calls["bf16_gemm"] += 1
        return out.copy_(bf16_gemm_reference(a, b, bias, mode))

    monkeypatch.setattr(launch, "ln_rows_bf16", ln_rows)
    monkeypatch.setattr(launch, "bf16_gemm", gemm)
    return calls


@pytest.mark.parametrize("final_ln", [True, False], ids=["final_ln", "no_final_ln"])
def test_cross_kv_prologue_slabs_equal_the_plain_version_bit_for_bit(final_ln, monkeypatch):
    """The prologue (rows S_VALID of S_PAD, the final LN's row pass with
    the decoder's eps, one GEMM per layer and k/v into the slabs), with
    its launchers swapped for plain versions of their contracts, gives
    ``_fused_cross_slabs``' slabs bit for bit: one row pass (none without
    a final LN), 2L GEMMs."""
    calls = _plain_launchers(monkeypatch)
    cfg, tdp = _tiny_port(std=0.1)
    raw, ln = _raw_encoder(20)
    raw = torch.from_numpy(raw).bfloat16()
    ln = {k: torch.from_numpy(a) for k, a in ln.items()} if final_ln else None
    k, v = tl.cross_kv_prologue(tdp, raw, S_VALID, ln, cfg.layer_norm_eps)
    want_k, want_v = tl._fused_cross_slabs(tdp, raw, S_VALID, ln, cfg.layer_norm_eps,
                                           torch.bfloat16)
    assert k.shape == v.shape == (cfg.num_layers, 4, S_VALID, cfg.hidden_size)
    assert k.dtype == v.dtype == torch.bfloat16
    torch.testing.assert_close(k, want_k, atol=0, rtol=0)
    torch.testing.assert_close(v, want_v, atol=0, rtol=0)
    assert calls == {"ln_rows_bf16": int(final_ln), "bf16_gemm": 2 * cfg.num_layers}
    assert tl.cross_kv_weights(tdp) is tl.cross_kv_weights(tdp)  # prepared once


@pytest.mark.parametrize("final_ln", [True, False], ids=["final_ln", "no_final_ln"])
def test_cross_kv_prologue_slabs_match_jax_precompute(final_ln, monkeypatch):
    """The prologue's slabs (plain launchers) against the JAX package's
    own: ``precompute_cross_kv_packed(..., int8=False)`` on the real rows
    after the final LN with the decoder's eps, in bf16, on the same numpy
    inputs; within one bf16 ulp (the f32 sums differ in order only)."""
    from manga_ocr_tpu.ops.common import layer_norm as jax_layer_norm

    _plain_launchers(monkeypatch)
    cfg, np_dec, _ = _setup(0.1, seed=21)
    raw, ln = _raw_encoder(21)
    e = jnp.asarray(raw[:, :S_VALID]).astype(jnp.bfloat16)
    if final_ln:
        e = jax_layer_norm(e, jnp.asarray(ln["scale"]), jnp.asarray(ln["bias"]),
                           cfg.decoder.layer_norm_eps)
    want = jdec.precompute_cross_kv_packed(np_dec, e, cfg.decoder, int8=False)
    tcfg = port_config(cfg).decoder
    got = tl.cross_kv_prologue(
        params_from_jax(np_dec, "cpu"), torch.from_numpy(raw).bfloat16(), S_VALID,
        {k: torch.from_numpy(a) for k, a in ln.items()} if final_ln else None,
        tcfg.layer_norm_eps)
    for g, w in zip(got, (want.k, want.v)):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   rtol=2**-7, atol=0)
