"""The sizes of a configuration file, read once into plain numbers.

A configuration file (``perfbench/configs/<name>.json``) keeps the keys of
the published ``config.json`` of a ``VisionEncoderDecoderModel``: an
``encoder`` group (``ViTConfig``), a ``decoder`` group (``BertConfig``) and
the top-level ``max_length`` and ``decoder_start_token_id``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Encoder:
    image_size: int
    patch_size: int
    channels: int
    hidden: int
    layers: int
    heads: int
    intermediate: int
    eps: float

    @property
    def seq_len(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1


@dataclasses.dataclass(frozen=True)
class Decoder:
    vocab: int
    hidden: int
    layers: int
    heads: int
    intermediate: int
    positions: int
    eps: float
    pad_id: int
    bos_id: int
    eos_id: int


@dataclasses.dataclass(frozen=True)
class Dims:
    encoder: Encoder
    decoder: Decoder
    max_length: int


def read(cfg: dict) -> Dims:
    e, d = cfg["encoder"], cfg["decoder"]
    return Dims(
        Encoder(e["image_size"], e["patch_size"], e["num_channels"], e["hidden_size"],
                e["num_hidden_layers"], e["num_attention_heads"], e["intermediate_size"],
                float(e["layer_norm_eps"])),
        Decoder(d["vocab_size"], d["hidden_size"], d["num_hidden_layers"],
                d["num_attention_heads"], d["intermediate_size"], d["max_position_embeddings"],
                float(d["layer_norm_eps"]), d["pad_token_id"], cfg["decoder_start_token_id"],
                d["eos_token_id"]),
        cfg["max_length"],
    )
