"""The port's HF checkpoint converter (``manga_ocr_tpu_torch/models/convert.py``)
and its safetensors codec (``models/safetensors_io.py``) against the JAX
package's converter and the ``safetensors`` package: the conversion, the
export and the config dict equal JAX's bit for bit on the tiny seed-0
fixture params; checkpoint directories cross-load between the packages in
both weight formats; the codec and ``safetensors.numpy`` read each other's
files; and a random-init ``transformers`` model saved by ``save_pretrained``
loads to the same tree in both packages, with the port's plain logits under
teacher forcing within 1e-5 of the HF forward's (f32 throughout)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import safetensors.numpy as stnp
import torch
from safetensors import safe_open

from manga_ocr_tpu.models import config as jcfg
from manga_ocr_tpu.models import convert as jconv
from manga_ocr_tpu.models.tokenizer import CharTokenizer as JaxTokenizer
from manga_ocr_tpu_torch.models import convert as tconv
from manga_ocr_tpu_torch.models import safetensors_io
from manga_ocr_tpu_torch.models.checkpoint import load_checkpoint
from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer
from port_threads import one_torch_thread  # noqa: F401  (autouse: one torch thread)

SEED0 = os.path.join(os.path.dirname(__file__), "fixtures", "tiny_random_seed0")
LOGITS_TOL = 1e-5  # f32 logits of the tiny model (|logit| up to ~3), port against HF


def _jax_config(cfg) -> jcfg.MangaOCRConfig:
    return jcfg.MangaOCRConfig(
        encoder=jcfg.EncoderConfig(**dataclasses.asdict(cfg.encoder)),
        decoder=jcfg.DecoderConfig(**dataclasses.asdict(cfg.decoder)),
        max_length=cfg.max_length,
    )


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _as_f32(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.float().numpy()
    return np.asarray(leaf, np.float32)


def _assert_trees_equal(got, want):
    """Same leaf paths, same values bit for bit (compared as f32)."""
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        np.testing.assert_array_equal(_as_f32(g[k]), _as_f32(w[k]), err_msg=k)


@pytest.fixture(scope="module")
def seed0():
    """The tiny seed-0 fixture params as the port's tree (f32), its port
    config, the same tree as numpy and the JAX config."""
    params, cfg = load_checkpoint(SEED0, torch.float32, "cpu")
    return params, cfg, _numpy_tree(params), _jax_config(cfg)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_state_dict_bit_equal_to_jax(seed0, dtype):
    params, cfg, np_params, jc = seed0
    sd = jconv.export_hf_state_dict(np_params, jc)
    got = tconv.convert_state_dict(sd, cfg, getattr(torch, dtype))
    want = jconv.convert_state_dict(sd, jc, getattr(jnp, dtype))
    for leaf in _flat(got).values():
        assert leaf.dtype == getattr(torch, dtype) and leaf.device.type == "cpu"
    _assert_trees_equal(got, want)
    if dtype == "float32":
        _assert_trees_equal(got, params)


@pytest.mark.parametrize("leaves", ["torch", "numpy", "torch_bf16"])
def test_export_and_config_dict_equal_to_jax(seed0, leaves):
    """The port exports torch leaves (bf16 ones too) and numpy leaves as JAX
    exports its own tree of the same values."""
    params, cfg, np_params, jc = seed0
    if leaves == "torch_bf16":
        sd = jconv.export_hf_state_dict(np_params, jc)
        src = tconv.convert_state_dict(sd, cfg, torch.bfloat16)
        want = jconv.export_hf_state_dict(jconv.convert_state_dict(sd, jc, jnp.bfloat16), jc)
    else:
        src = params if leaves == "torch" else np_params
        want = jconv.export_hf_state_dict(np_params, jc)
    got = tconv.export_hf_state_dict(src, cfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert tconv.hf_config_dict(cfg) == jconv.hf_config_dict(jc)


def test_head_bias_falls_back_to_the_decoder_key(seed0):
    """A state dict that carries the MLM-head bias only under
    ``cls.predictions.decoder.bias`` converts as JAX converts it."""
    params, cfg, np_params, jc = seed0
    sd = jconv.export_hf_state_dict(np_params, jc)
    del sd["decoder.cls.predictions.bias"]
    got = tconv.convert_state_dict(sd, cfg)
    _assert_trees_equal(got, jconv.convert_state_dict(sd, jc))
    _assert_trees_equal(got, params)
    del sd["decoder.cls.predictions.decoder.bias"]
    with pytest.raises(KeyError, match="decoder.bias"):
        tconv.convert_state_dict(sd, cfg)


def _to_bin(path):
    """Replace the directory's ``model.safetensors`` by ``pytorch_model.bin``."""
    st = os.path.join(path, "model.safetensors")
    sd = safetensors_io.load_file(st)
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()},
               os.path.join(path, "pytorch_model.bin"))
    os.remove(st)


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_directories_cross_load_between_packages(seed0, tmp_path, writer, fmt):
    params, cfg, np_params, jc = seed0
    path = str(tmp_path / "ckpt")
    if writer == "port":
        tconv.save_hf_checkpoint(path, params, cfg, tokenizer=CharTokenizer.synthetic())
    else:
        jconv.save_hf_checkpoint(path, np_params, jc, tokenizer=JaxTokenizer.synthetic())
    if fmt == "bin":
        _to_bin(path)
    assert sorted(os.listdir(path)) == sorted(
        ["config.json", "vocab.txt", "model.safetensors" if fmt == "safetensors"
         else "pytorch_model.bin"])
    t_params, t_cfg = tconv.load_hf_checkpoint(path)
    j_params, j_cfg = jconv.load_hf_checkpoint(path)
    assert t_cfg == cfg
    assert dataclasses.asdict(j_cfg) == dataclasses.asdict(cfg)
    _assert_trees_equal(t_params, params)
    _assert_trees_equal(j_params, params)
    tok = CharTokenizer.from_vocab_file(os.path.join(path, "vocab.txt"))
    assert tok.id_to_token == CharTokenizer.synthetic().id_to_token


def test_port_checkpoint_files_equal_jax(seed0, tmp_path):
    """The port's directory holds the JAX package's config.json and vocab.txt
    byte for byte, and safetensors reads the same tensors from both."""
    params, cfg, np_params, jc = seed0
    tconv.save_hf_checkpoint(str(tmp_path / "t"), params, cfg, CharTokenizer.synthetic())
    jconv.save_hf_checkpoint(str(tmp_path / "j"), np_params, jc, JaxTokenizer.synthetic())
    for name in ("config.json", "vocab.txt"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    got = stnp.load_file(str(tmp_path / "t" / "model.safetensors"))
    want = stnp.load_file(str(tmp_path / "j" / "model.safetensors"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _codec_tensors():
    rng = np.random.default_rng(0)
    return {
        "w.f32": rng.standard_normal((3, 5)).astype(np.float32),
        "w.f16": rng.standard_normal((7,)).astype(np.float16),
        "w.f64": rng.standard_normal((2, 2, 2)),
        "ids.i64": rng.integers(-9, 9, (4,)).astype(np.int64),
        "ids.i32": rng.integers(-9, 9, (2, 3)).astype(np.int32),
        "q.i8": rng.integers(-127, 128, (3, 3)).astype(np.int8),
        "px.u8": rng.integers(0, 256, (2, 4)).astype(np.uint8),
        "mask": np.array([True, False, True]),
        "empty": np.zeros((0, 4), np.float32),
        "scalar": np.array(1.5, np.float32),
    }


@pytest.mark.parametrize("writer", ["port", "safetensors"])
def test_codec_and_safetensors_read_each_other(tmp_path, writer):
    tensors = _codec_tensors()
    meta = {"format": "pt", "note": "漫画"}
    path = str(tmp_path / "x.safetensors")
    if writer == "port":
        safetensors_io.save_file(tensors, path, metadata=meta)
        got = stnp.load_file(path)
        with safe_open(path, "np") as f:
            assert f.metadata() == meta
    else:
        stnp.save_file(tensors, path, metadata=meta)
        got = safetensors_io.load_file(path)
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    safetensors_io.save_file({"a": tensors["w.f32"]}, path)
    with safe_open(path, "np") as f:
        assert f.metadata() is None


def test_codec_refuses_bf16_naming_tensor_and_dtype(tmp_path):
    import safetensors.torch

    path = str(tmp_path / "bf16.safetensors")
    safetensors.torch.save_file(
        {"ok": torch.zeros(2), "w.bf16": torch.zeros(3, dtype=torch.bfloat16)}, path)
    with pytest.raises(ValueError, match=r"'w\.bf16'.*BF16"):
        safetensors_io.load_file(path)


def test_codec_refuses_offsets_that_leave_the_file(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    safetensors_io.save_file({"w": np.zeros(4, np.float32)}, path)
    raw = bytearray(open(path, "rb").read())
    i = raw.index(b"[0,16]")
    raw[i : i + 6] = b"[0,32]"
    open(path, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="offsets"):
        safetensors_io.load_file(path)


def test_missing_weights_raise_file_not_found(seed0, tmp_path):
    _, cfg, _, _ = seed0
    with open(tmp_path / "config.json", "w") as f:
        json.dump(tconv.hf_config_dict(cfg), f)
    with pytest.raises(FileNotFoundError, match="no model weights"):
        tconv.load_hf_checkpoint(str(tmp_path))


@pytest.fixture(scope="module")
def hf_model_dir(tmp_path_factory):
    """A random-init ``transformers`` ``VisionEncoderDecoderModel`` at the
    tiny size, saved by ``save_pretrained``."""
    transformers = pytest.importorskip("transformers")
    from manga_ocr_tpu_torch.models.config import MangaOCRConfig

    cfg = MangaOCRConfig.tiny()
    e, d = cfg.encoder, cfg.decoder
    enc_cfg = transformers.ViTConfig(
        image_size=e.image_size, patch_size=e.patch_size, num_channels=e.num_channels,
        hidden_size=e.hidden_size, num_hidden_layers=e.num_layers,
        num_attention_heads=e.num_heads, intermediate_size=e.intermediate_size,
        layer_norm_eps=e.layer_norm_eps,
    )
    dec_cfg = transformers.BertConfig(
        vocab_size=d.vocab_size, hidden_size=d.hidden_size, num_hidden_layers=d.num_layers,
        num_attention_heads=d.num_heads, intermediate_size=d.intermediate_size,
        max_position_embeddings=d.max_position_embeddings, layer_norm_eps=d.layer_norm_eps,
        is_decoder=True, add_cross_attention=True, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    model = transformers.VisionEncoderDecoderModel(
        config=transformers.VisionEncoderDecoderConfig.from_encoder_decoder_configs(
            enc_cfg, dec_cfg)
    )
    model.config.decoder_start_token_id = d.bos_token_id
    model.config.pad_token_id = d.pad_token_id
    # the default init (std 0.02, zero biases, unit LN) gives near-constant
    # logits; spread every parameter so the comparison sees the weights
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
    model.eval()
    path = tmp_path_factory.mktemp("hf_model")
    model.save_pretrained(str(path))
    return str(path), model, cfg


def test_save_pretrained_loads_to_the_same_tree_in_both_packages(hf_model_dir):
    path, _, cfg = hf_model_dir
    assert os.path.exists(os.path.join(path, "model.safetensors"))
    t_params, t_cfg = tconv.load_hf_checkpoint(path)
    j_params, j_cfg = jconv.load_hf_checkpoint(path)
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert (t_cfg.encoder, t_cfg.decoder) == (cfg.encoder, cfg.decoder)
    _assert_trees_equal(t_params, j_params)


def test_plain_logits_match_hf_forward_under_teacher_forcing(hf_model_dir):
    from manga_ocr_tpu_torch.models import decoder as dec
    from manga_ocr_tpu_torch.models import model as mdl

    path, model, _ = hf_model_dir
    params, cfg = tconv.load_hf_checkpoint(path)
    rng = np.random.default_rng(1)
    img = cfg.encoder.image_size
    pixels = rng.standard_normal((2, img, img, 3)).astype(np.float32)
    steps = 10
    tokens = np.concatenate(
        [np.full((2, 1), cfg.decoder.bos_token_id),
         rng.integers(4, cfg.decoder.vocab_size, (2, steps - 1))], axis=1)
    with torch.no_grad():
        want = model(pixel_values=torch.from_numpy(pixels.transpose(0, 3, 1, 2)),
                     decoder_input_ids=torch.from_numpy(tokens)).logits.numpy()
        enc = mdl.encode(params, torch.from_numpy(pixels), cfg, use_kernels=False)
        cross = dec.precompute_cross_kv(params["decoder"], enc, cfg.decoder, int8=False)
        cache = dec.init_cache(cfg.decoder, 2, steps, torch.float32, "cpu")
        got = []
        for t in range(steps):
            lg, cache = dec.decode_step(params["decoder"], torch.from_numpy(tokens[:, t]), t,
                                        cache, cross, cfg.decoder, use_kernels=False)
            got.append(lg.numpy())
    got = np.stack(got, axis=1)
    assert got.shape == want.shape == (2, steps, cfg.decoder.vocab_size)
    assert np.abs(want).max() > 0.5  # logits that depend on the weights
    np.testing.assert_allclose(got, want, rtol=LOGITS_TOL, atol=LOGITS_TOL)
