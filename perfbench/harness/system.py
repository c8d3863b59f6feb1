"""The system under test: ``manga_ocr_tpu_torch``, the PyTorch and CUDA port.

The only module of the benchmark that imports the program.  It builds the
engine a configuration file names, the microbatching service in front of
it, and reads the program's own bucketing rules and counters.
"""

from __future__ import annotations

import torch

from perfbench.harness import vocab
from perfbench.reference.dims import Dims

ORIENTATIONS = {"auto": 0, "vertical": 1, "horizontal": 2, "none": 3}


def model_config(cfg: dict, dims: Dims):
    """The program's ``MangaOCRConfig`` of a configuration file."""
    from manga_ocr_tpu_torch.models.config import DecoderConfig, EncoderConfig, MangaOCRConfig

    e, d = dims.encoder, dims.decoder
    return MangaOCRConfig(
        encoder=EncoderConfig(image_size=e.image_size, patch_size=e.patch_size,
                              num_channels=e.channels, hidden_size=e.hidden,
                              num_layers=e.layers, num_heads=e.heads,
                              intermediate_size=e.intermediate, layer_norm_eps=e.eps),
        decoder=DecoderConfig(vocab_size=d.vocab, hidden_size=d.hidden, num_layers=d.layers,
                              num_heads=d.heads, intermediate_size=d.intermediate,
                              max_position_embeddings=d.positions, layer_norm_eps=d.eps,
                              pad_token_id=d.pad_id, bos_token_id=d.bos_id,
                              eos_token_id=d.eos_id),
        max_length=dims.max_length,
    )


def tokenizer(dims: Dims):
    """The program's ``CharTokenizer`` over the benchmark's vocabulary."""
    from manga_ocr_tpu_torch.models.tokenizer import CharTokenizer

    return CharTokenizer(vocab.chars(dims.decoder.vocab))


def engine(params: dict, cfg: dict, dims: Dims, device):
    """``TorchMangaOcrEngine`` in the configuration's serving form."""
    from manga_ocr_tpu_torch.engine.engine import TorchMangaOcrEngine

    form = cfg["serving"]
    return TorchMangaOcrEngine(
        params, model_config(cfg, dims), tokenizer(dims), max_length=dims.max_length,
        dtype=getattr(torch, form["dtype"]), device=device,
        serving_kernels=form["serving_kernels"], quantize_int8=form["quantize_int8"],
        aot=form["aot"],
    )


def service(eng, mix: dict):
    """``serve.OcrService`` around the engine: its ``MicroBatcher`` with the
    mix's window and largest batch."""
    from manga_ocr_tpu_torch.serve import OcrService

    svc = OcrService(eng, window_ms=mix["window_ms"])
    svc.batcher.max_batch = mix["max_batch"]
    return svc


def dispatches(crops: list, orientation: str) -> list[tuple[tuple[int, int], int, list[int]]]:
    """The dispatches ``ocr_page`` makes of ``crops``, by the program's own
    rules: ``(bucket (h, w), padded batch, crop indices)`` in bucket order."""
    from manga_ocr_tpu_torch.parallel import batching

    rot = ORIENTATIONS[orientation]
    groups: dict = {}
    for i, c in enumerate(crops):
        h, w = c.shape[:2]
        if (rot == 1 and w > h) or (rot == 2 and h > w):
            h, w = w, h
        hw = batching.pick_bucket(h, w)
        if h > hw[0] or w > hw[1]:
            raise ValueError(f"crop {h}x{w} fits no bucket: the benchmark's traffic never "
                             "sends one")
        groups.setdefault(hw, []).append(i)
    return [(hw, batching.pad_batch_size(len(idx)), idx)
            for hw, idx in sorted(groups.items(), key=lambda kv: kv[0][0] * kv[0][1])]


def batch_sizes(max_batch: int) -> list[int]:
    """The padded batch sizes a dispatch of at most ``max_batch`` crops can take."""
    from manga_ocr_tpu_torch.parallel import batching

    top = batching.pad_batch_size(max_batch)
    return [n for n in batching.BATCH_SCHEDULE if n <= top]


def warm(eng, pairs) -> None:
    """Capture (or run once) each (bucket, padded batch) shape."""
    for hw, n in sorted(set(pairs)):
        eng.warmup(bucket_hws=[hw], batch_sizes=[n])


def unplanned_compiles() -> int:
    """The program's count of dispatch shapes outside the warmed set."""
    from manga_ocr_tpu_torch.utils.metrics import COMPILE_EVENTS

    return COMPILE_EVENTS.get("unplanned_compile")


def pages(eng, page_iter, orientation: str, lookahead: int) -> list:
    return eng.ocr_pages(page_iter, orientation=ORIENTATIONS[orientation], lookahead=lookahead)
