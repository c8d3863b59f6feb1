"""HF ``VisionEncoderDecoderModel`` checkpoint <-> the port's parameter tree
(counterpart of ``manga_ocr_tpu/models/convert.py``, with the same functions
and names, so a checkpoint directory written by either package loads in the
other).

The real manga-ocr model ships as a HuggingFace checkpoint (ViT encoder +
``BertLMHeadModel`` decoder).  Conversion to the stacked-layer tree of
``models/vit.py`` and ``models/decoder.py`` (the JAX package's layout, torch
tensors as leaves, as ``models/params.params_from_jax`` gives it):

- torch ``Linear`` weights are ``[out, in]`` -> transposed to ``[in, out]``,
- the patch-embedding conv ``[D, C, P, P]`` -> ``[P, P, C, D]``,
- per-layer tensors are stacked on a leading layer axis,
- the LM head vocab projection ``[V, D]`` -> ``[D, V]``.

Works from a numpy state dict, a checkpoint directory (``model.safetensors``,
read by the port's own codec in ``models/safetensors_io.py``, or
``pytorch_model.bin``, plus ``config.json``), or a torch module.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Mapping

import numpy as np
import torch

from manga_ocr_tpu_torch.models import safetensors_io
from manga_ocr_tpu_torch.models.config import DecoderConfig, EncoderConfig, MangaOCRConfig


def _ln(get: Callable[[str], np.ndarray], prefix: str) -> dict:
    return {"scale": get(f"{prefix}.weight"), "bias": get(f"{prefix}.bias")}


def _linear(get: Callable[[str], np.ndarray], prefix: str) -> dict:
    return {
        "kernel": np.ascontiguousarray(get(f"{prefix}.weight").T),
        "bias": get(f"{prefix}.bias"),
    }


def _stack(dicts: list[dict]) -> dict:
    """Stack a list of identically-structured nested dicts on axis 0."""
    out: dict = {}
    for key, val in dicts[0].items():
        if isinstance(val, dict):
            out[key] = _stack([d[key] for d in dicts])
        else:
            out[key] = np.stack([d[key] for d in dicts], axis=0)
    return out


def convert_encoder(get, cfg: EncoderConfig, prefix: str = "encoder.") -> dict:
    p = prefix
    conv_w = get(f"{p}embeddings.patch_embeddings.projection.weight")  # [D,C,P,P]
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{p}encoder.layer.{i}."
        layers.append(
            {
                "ln1": _ln(get, f"{lp}layernorm_before"),
                "attn": {
                    "q": _linear(get, f"{lp}attention.attention.query"),
                    "k": _linear(get, f"{lp}attention.attention.key"),
                    "v": _linear(get, f"{lp}attention.attention.value"),
                    "o": _linear(get, f"{lp}attention.output.dense"),
                },
                "ln2": _ln(get, f"{lp}layernorm_after"),
                "mlp": {
                    "fc1": _linear(get, f"{lp}intermediate.dense"),
                    "fc2": _linear(get, f"{lp}output.dense"),
                },
            }
        )
    return {
        "patch_embed": {
            "kernel": np.ascontiguousarray(conv_w.transpose(2, 3, 1, 0)),  # -> [P,P,C,D]
            "bias": get(f"{p}embeddings.patch_embeddings.projection.bias"),
        },
        "cls_token": get(f"{p}embeddings.cls_token"),
        "pos_embed": get(f"{p}embeddings.position_embeddings"),
        "layers": _stack(layers),
        "final_ln": _ln(get, f"{p}layernorm"),
    }


def convert_decoder(get, cfg: DecoderConfig, prefix: str = "decoder.") -> dict:
    p = prefix
    layers = []
    for i in range(cfg.num_layers):
        lp = f"{p}bert.encoder.layer.{i}."
        layers.append(
            {
                "self_attn": {
                    "q": _linear(get, f"{lp}attention.self.query"),
                    "k": _linear(get, f"{lp}attention.self.key"),
                    "v": _linear(get, f"{lp}attention.self.value"),
                    "o": _linear(get, f"{lp}attention.output.dense"),
                },
                "self_ln": _ln(get, f"{lp}attention.output.LayerNorm"),
                "cross_attn": {
                    "q": _linear(get, f"{lp}crossattention.self.query"),
                    "k": _linear(get, f"{lp}crossattention.self.key"),
                    "v": _linear(get, f"{lp}crossattention.self.value"),
                    "o": _linear(get, f"{lp}crossattention.output.dense"),
                },
                "cross_ln": _ln(get, f"{lp}crossattention.output.LayerNorm"),
                "mlp": {
                    "fc1": _linear(get, f"{lp}intermediate.dense"),
                    "fc2": _linear(get, f"{lp}output.dense"),
                },
                "mlp_ln": _ln(get, f"{lp}output.LayerNorm"),
            }
        )
    # The MLM-head bias key shifted across transformers versions.
    try:
        head_bias = get(f"{p}cls.predictions.bias")
    except KeyError:
        head_bias = get(f"{p}cls.predictions.decoder.bias")
    return {
        "tok_embed": get(f"{p}bert.embeddings.word_embeddings.weight"),
        "pos_embed": get(f"{p}bert.embeddings.position_embeddings.weight"),
        # HF BERT carries [type_vocab_size, D]; the decoder only uses row 0
        "tok_type": get(f"{p}bert.embeddings.token_type_embeddings.weight")[0],
        "emb_ln": _ln(get, f"{p}bert.embeddings.LayerNorm"),
        "layers": _stack(layers),
        "head": {
            "transform": {
                "dense": _linear(get, f"{p}cls.predictions.transform.dense"),
                "ln": _ln(get, f"{p}cls.predictions.transform.LayerNorm"),
            },
            "proj": {
                "kernel": np.ascontiguousarray(
                    get(f"{p}cls.predictions.decoder.weight").T
                ),
                "bias": head_bias,
            },
        },
    }


def _to_torch(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _to_torch(v, dtype, device) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32)).to(device=device, dtype=dtype)


def convert_state_dict(
    sd: Mapping[str, np.ndarray], cfg: MangaOCRConfig, dtype=torch.float32, device="cpu"
) -> dict:
    """Full conversion from a numpy state dict to the parameter tree as torch
    tensors in ``dtype`` on ``device`` (every leaf through f32 first, as the
    JAX package converts)."""

    def get(name: str) -> np.ndarray:
        if name not in sd:
            raise KeyError(f"missing checkpoint tensor: {name}")
        return np.asarray(sd[name], np.float32)

    params = {
        "encoder": convert_encoder(get, cfg.encoder),
        "decoder": convert_decoder(get, cfg.decoder),
    }
    return _to_torch(params, dtype, torch.device(device))


def torch_state_dict_to_numpy(module_or_sd) -> dict[str, np.ndarray]:
    """Accept a torch module or state dict; return plain numpy arrays."""
    if hasattr(module_or_sd, "state_dict"):
        sd = module_or_sd.state_dict()
    else:
        sd = module_or_sd
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _f32(leaf) -> np.ndarray:
    """A leaf (torch tensor, bf16 included, or array) as a numpy f32 array."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().float().numpy()
    return np.asarray(leaf, np.float32)


def _unstack(stacked: dict, i: int) -> dict:
    """Inverse of ``_stack``: pull layer ``i`` out of a stacked tree."""
    out: dict = {}
    for key, val in stacked.items():
        if isinstance(val, dict):
            out[key] = _unstack(val, i)
        else:
            out[key] = _f32(val[i])
    return out


def export_hf_state_dict(params: dict, cfg: MangaOCRConfig) -> dict:
    """Parameter tree (torch tensors or arrays as leaves) -> HF
    ``VisionEncoderDecoderModel`` state dict (numpy float32): the exact
    inverse of ``convert_state_dict``, so a converted-then-exported
    checkpoint round-trips bit-exactly."""
    sd: dict[str, np.ndarray] = {}

    def put_linear(prefix: str, p: dict) -> None:
        sd[f"{prefix}.weight"] = np.ascontiguousarray(_f32(p["kernel"]).T)
        sd[f"{prefix}.bias"] = _f32(p["bias"])

    def put_ln(prefix: str, p: dict) -> None:
        sd[f"{prefix}.weight"] = _f32(p["scale"])
        sd[f"{prefix}.bias"] = _f32(p["bias"])

    enc = params["encoder"]
    sd["encoder.embeddings.patch_embeddings.projection.weight"] = np.ascontiguousarray(
        _f32(enc["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)
    )
    sd["encoder.embeddings.patch_embeddings.projection.bias"] = _f32(enc["patch_embed"]["bias"])
    sd["encoder.embeddings.cls_token"] = _f32(enc["cls_token"])
    sd["encoder.embeddings.position_embeddings"] = _f32(enc["pos_embed"])
    for i in range(cfg.encoder.num_layers):
        lay = _unstack(enc["layers"], i)
        lp = f"encoder.encoder.layer.{i}."
        put_ln(f"{lp}layernorm_before", lay["ln1"])
        put_linear(f"{lp}attention.attention.query", lay["attn"]["q"])
        put_linear(f"{lp}attention.attention.key", lay["attn"]["k"])
        put_linear(f"{lp}attention.attention.value", lay["attn"]["v"])
        put_linear(f"{lp}attention.output.dense", lay["attn"]["o"])
        put_ln(f"{lp}layernorm_after", lay["ln2"])
        put_linear(f"{lp}intermediate.dense", lay["mlp"]["fc1"])
        put_linear(f"{lp}output.dense", lay["mlp"]["fc2"])
    put_ln("encoder.layernorm", enc["final_ln"])

    dec_p = params["decoder"]
    sd["decoder.bert.embeddings.word_embeddings.weight"] = _f32(dec_p["tok_embed"])
    sd["decoder.bert.embeddings.position_embeddings.weight"] = _f32(dec_p["pos_embed"])
    # HF BERT carries [type_vocab_size, D]; only row 0 is ever used by the
    # decoder (convert_decoder takes [0]) — emit the standard 2 rows.
    tok_type = _f32(dec_p["tok_type"])
    sd["decoder.bert.embeddings.token_type_embeddings.weight"] = np.stack(
        [tok_type, np.zeros_like(tok_type)], axis=0
    )
    put_ln("decoder.bert.embeddings.LayerNorm", dec_p["emb_ln"])
    for i in range(cfg.decoder.num_layers):
        lay = _unstack(dec_p["layers"], i)
        lp = f"decoder.bert.encoder.layer.{i}."
        put_linear(f"{lp}attention.self.query", lay["self_attn"]["q"])
        put_linear(f"{lp}attention.self.key", lay["self_attn"]["k"])
        put_linear(f"{lp}attention.self.value", lay["self_attn"]["v"])
        put_linear(f"{lp}attention.output.dense", lay["self_attn"]["o"])
        put_ln(f"{lp}attention.output.LayerNorm", lay["self_ln"])
        put_linear(f"{lp}crossattention.self.query", lay["cross_attn"]["q"])
        put_linear(f"{lp}crossattention.self.key", lay["cross_attn"]["k"])
        put_linear(f"{lp}crossattention.self.value", lay["cross_attn"]["v"])
        put_linear(f"{lp}crossattention.output.dense", lay["cross_attn"]["o"])
        put_ln(f"{lp}crossattention.output.LayerNorm", lay["cross_ln"])
        put_linear(f"{lp}intermediate.dense", lay["mlp"]["fc1"])
        put_linear(f"{lp}output.dense", lay["mlp"]["fc2"])
        put_ln(f"{lp}output.LayerNorm", lay["mlp_ln"])
    head = dec_p["head"]
    put_linear("decoder.cls.predictions.transform.dense", head["transform"]["dense"])
    put_ln("decoder.cls.predictions.transform.LayerNorm", head["transform"]["ln"])
    sd["decoder.cls.predictions.decoder.weight"] = np.ascontiguousarray(
        _f32(head["proj"]["kernel"]).T
    )
    # HF ties these two; emit both so every loader vintage finds its key.
    sd["decoder.cls.predictions.decoder.bias"] = _f32(head["proj"]["bias"])
    sd["decoder.cls.predictions.bias"] = sd["decoder.cls.predictions.decoder.bias"]
    return sd


def hf_config_dict(cfg: MangaOCRConfig) -> dict:
    """``MangaOCRConfig`` -> HF ``VisionEncoderDecoderConfig``-shaped JSON
    dict (inverse of ``MangaOCRConfig.from_hf_config``)."""
    e, d = cfg.encoder, cfg.decoder
    return {
        "model_type": "vision-encoder-decoder",
        "decoder_start_token_id": d.bos_token_id,
        "encoder": {
            "model_type": "vit",
            "image_size": e.image_size,
            "patch_size": e.patch_size,
            "num_channels": e.num_channels,
            "hidden_size": e.hidden_size,
            "num_hidden_layers": e.num_layers,
            "num_attention_heads": e.num_heads,
            "intermediate_size": e.intermediate_size,
            "layer_norm_eps": e.layer_norm_eps,
        },
        "decoder": {
            "model_type": "bert",
            # Upstream manga-ocr-base's config.json carries both flags;
            # without them transformers builds a non-causal BERT with no
            # cross-attention and drops the crossattention.* weights on
            # from_pretrained (a warning only).
            "is_decoder": True,
            "add_cross_attention": True,
            # The tree keeps tok_embed and the LM-head projection as
            # independent tensors; HF's default tying would alias them on
            # load and overwrite one with the other.
            "tie_word_embeddings": False,
            "vocab_size": d.vocab_size,
            "hidden_size": d.hidden_size,
            "num_hidden_layers": d.num_layers,
            "num_attention_heads": d.num_heads,
            "intermediate_size": d.intermediate_size,
            "max_position_embeddings": d.max_position_embeddings,
            "layer_norm_eps": d.layer_norm_eps,
            "pad_token_id": d.pad_token_id,
            "eos_token_id": d.eos_token_id,
            "max_length": cfg.max_length,
        },
    }


def save_hf_checkpoint(path: str, params: dict, cfg: MangaOCRConfig, tokenizer=None) -> None:
    """Write an HF-format checkpoint directory (``model.safetensors`` +
    ``config.json`` [+ ``vocab.txt``]) that ``load_hf_checkpoint``, the JAX
    package's loader and upstream HF loaders read back.  ``tokenizer``: an
    optional ``CharTokenizer`` whose vocab is written as ``vocab.txt``."""
    os.makedirs(path, exist_ok=True)
    safetensors_io.save_file(export_hf_state_dict(params, cfg),
                             os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config_dict(cfg), f, indent=2)
    if tokenizer is not None:
        with open(os.path.join(path, "vocab.txt"), "w", encoding="utf-8") as f:
            f.write("\n".join(tokenizer.id_to_token) + "\n")


def load_hf_checkpoint(
    path: str, dtype=torch.float32, device="cpu"
) -> tuple[dict, MangaOCRConfig]:
    """Load an HF checkpoint directory (``config.json`` and
    ``model.safetensors``, else ``pytorch_model.bin``) as the parameter tree
    in ``dtype`` on ``device``, and its config."""
    cfg = MangaOCRConfig.from_json_file(os.path.join(path, "config.json"))
    st_path = os.path.join(path, "model.safetensors")
    bin_path = os.path.join(path, "pytorch_model.bin")
    if os.path.exists(st_path):
        sd = safetensors_io.load_file(st_path)
    elif os.path.exists(bin_path):
        sd = torch_state_dict_to_numpy(
            torch.load(bin_path, map_location="cpu", weights_only=True)
        )
    else:
        raise FileNotFoundError(f"no model weights found under {path}")
    return convert_state_dict(sd, cfg, dtype, device), cfg
