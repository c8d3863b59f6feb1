"""Model configurations (the port's own copy of ``manga_ocr_tpu/models/config.py``).

A ViT-base image encoder and a shallow BERT-style character-level decoder,
as in the manga-ocr model.  The fields and their defaults are those of the
JAX package's dataclasses, so a configuration means the same thing in both
packages; the kernel-selection flags name the JAX package's kernels, and the
port implements the ones its modules list (the others raise).
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """ViT encoder (HF ``ViTModel``-compatible math, pre-LN blocks)."""

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-12
    # MLP half: "xla" (reference math) | "fused" (kernel B for int8 params,
    # kernel D for float ones).
    mlp_kernel: str = "xla"
    # Attention half: "xla" (reference math) | "packed" (SDPA alone, kernel
    # E) | "fused_layer" (LN + projections + SDPA + residual, kernel A) |
    # "merged_layer" (the whole block, kernel H) | "stacked" (``stack_lpc``
    # blocks per call, kernel I).
    attn_kernel: str = "xla"
    stack_lpc: int = 12
    # GELU of the fused MLP: "erf" (exact) | "sigmoid" (x / (1 + exp(-1.702 x))).
    gelu_mode: str = "erf"
    # Scheduling flags of the JAX package's kernels (no effect on the math).
    parallel_grid: bool = False
    batched_sdpa: bool | str = False
    # Token padding of the JAX package's fused stack (0 = off); padded keys
    # are masked and padded rows sliced off, so real rows do not change.
    seq_pad_to: int = 0
    mlp_subtiles: int = 1
    mlp_tile_m: int = 512
    attn_fuse_qkv: bool = False
    attn_group: int = 4
    # Variants of the JAX package's fused attention layer.
    attn_sdpa_int8: bool = False
    attn_sdpa_headpack: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        # +1 for the CLS token prepended by the embedding layer.
        return self.num_patches + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """BERT-style decoder (HF ``BertLMHeadModel``-compatible math, post-LN
    blocks with cross-attention)."""

    vocab_size: int = 6144
    hidden_size: int = 768
    num_layers: int = 2
    num_heads: int = 8
    intermediate_size: int = 3072
    max_position_embeddings: int = 300
    layer_norm_eps: float = 1e-12
    # Special token ids (BERT conventions, as used by the manga-ocr vocab).
    pad_token_id: int = 0
    unk_token_id: int = 1
    bos_token_id: int = 2  # [CLS] — decoder_start_token_id
    eos_token_id: int = 3  # [SEP]
    # Store the precomputed cross-attention K/V as int8 with scales (the
    # step-by-step decodes; kernel C reads bf16 slabs whatever this says).
    cross_kv_int8: bool = False
    # Step MLP of the "xla" step: "xla" | "fused" (kernel D, pre_ln=False).
    step_mlp_kernel: str = "xla"
    # Decode: "xla" (step by step, reference math) | "fused_layer" (step by
    # step, kernels J, K and B's post-LN form per layer; int8 weights from
    # ``models.quantize.quantize_decoder`` or float ones) | "fused_loop"
    # (the whole greedy loop in one kernel, C).
    step_kernel: str = "xla"
    # Greedy head of the step-by-step decodes: "xla" (logits + argmax) |
    # "fused" (kernel F).
    head_kernel: str = "xla"
    # fused_loop options of the JAX package's kernel C.
    loop_chains: int = 1
    head_phased: bool = False
    fuse_cross_kv: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclasses.dataclass(frozen=True)
class MangaOCRConfig:
    encoder: EncoderConfig = dataclasses.field(default_factory=EncoderConfig)
    decoder: DecoderConfig = dataclasses.field(default_factory=DecoderConfig)
    # Maximum generated sequence length (reference model: 300).
    max_length: int = 300

    @staticmethod
    def base() -> "MangaOCRConfig":
        """The full-size manga-ocr architecture (ViT-base encoder + 2-layer
        char-level decoder)."""
        return MangaOCRConfig()

    @staticmethod
    def serving(quantized: bool = True) -> "MangaOCRConfig":
        """``base()`` with the serving kernels on (``with_serving_kernels``);
        ``quantized`` declares int8 encoder params, which also selects the
        sigmoid GELU."""
        return with_serving_kernels(MangaOCRConfig.base(), quantized)

    @staticmethod
    def tiny(vocab_size: int = 100) -> "MangaOCRConfig":
        """A miniature config for fast unit tests."""
        return MangaOCRConfig(
            encoder=EncoderConfig(
                image_size=32,
                patch_size=16,
                hidden_size=64,
                num_layers=2,
                num_heads=4,
                intermediate_size=128,
            ),
            decoder=DecoderConfig(
                vocab_size=vocab_size,
                hidden_size=64,
                num_layers=2,
                num_heads=4,
                intermediate_size=128,
                max_position_embeddings=32,
            ),
            max_length=16,
        )

    @staticmethod
    def from_hf_config(cfg: dict) -> "MangaOCRConfig":
        """Build from a HuggingFace ``VisionEncoderDecoderConfig`` JSON dict
        (the ``config.json`` sitting next to a checkpoint)."""
        enc = cfg["encoder"]
        dec = cfg["decoder"]
        encoder = EncoderConfig(
            image_size=enc.get("image_size", 224),
            patch_size=enc.get("patch_size", 16),
            num_channels=enc.get("num_channels", 3),
            hidden_size=enc.get("hidden_size", 768),
            num_layers=enc.get("num_hidden_layers", 12),
            num_heads=enc.get("num_attention_heads", 12),
            intermediate_size=enc.get("intermediate_size", 3072),
            layer_norm_eps=enc.get("layer_norm_eps", 1e-12),
        )
        decoder = DecoderConfig(
            vocab_size=dec["vocab_size"],
            hidden_size=dec.get("hidden_size", 768),
            num_layers=dec.get("num_hidden_layers", 2),
            num_heads=dec.get("num_attention_heads", 12),
            intermediate_size=dec.get("intermediate_size", 3072),
            max_position_embeddings=dec.get("max_position_embeddings", 512),
            layer_norm_eps=dec.get("layer_norm_eps", 1e-12),
            pad_token_id=dec.get("pad_token_id", 0) or 0,
            bos_token_id=cfg.get("decoder_start_token_id", 2) or 2,
            eos_token_id=dec.get("eos_token_id", 3) or 3,
        )
        max_length = dec.get("max_length", 300) or 300
        return MangaOCRConfig(encoder=encoder, decoder=decoder, max_length=max_length)

    @staticmethod
    def from_json_file(path: str) -> "MangaOCRConfig":
        with open(path) as f:
            return MangaOCRConfig.from_hf_config(json.load(f))


def with_serving_kernels(cfg: MangaOCRConfig, quantized: bool = True) -> MangaOCRConfig:
    """The serving kernel flags, applied to any config: the fused MLP, the
    fused attention layer (int8) or the packed attention (float), the
    sigmoid GELU and the 8-aligned token pad for int8 params, int8 cross-K/V
    for the step decodes, and the whole-loop decode (kernel C)."""
    return dataclasses.replace(
        cfg,
        encoder=dataclasses.replace(
            cfg.encoder,
            mlp_kernel="fused",
            attn_kernel="fused_layer" if quantized else "packed",
            gelu_mode="sigmoid" if quantized else "erf",
            seq_pad_to=_pad_seq(cfg.encoder.seq_len) if quantized else 0,
        ),
        decoder=dataclasses.replace(
            cfg.decoder,
            cross_kv_int8=quantized,
            step_kernel="fused_loop",
            head_phased=True,
        ),
    )


def _pad_seq(seq_len: int) -> int:
    """Next multiple of 8 >= seq_len (ViT-base: 197 -> 200)."""
    return ((seq_len + 7) // 8) * 8
