"""The port's own config, rebuilt from a JAX package config's fields: the
CPU parity tests hand each package its own configuration object."""

import dataclasses

from manga_ocr_tpu_torch.models import config as tcfg


def port_config(cfg) -> tcfg.MangaOCRConfig:
    """A ``manga_ocr_tpu.models.config.MangaOCRConfig`` -> the port's
    ``MangaOCRConfig`` with the same field values."""
    return tcfg.MangaOCRConfig(
        encoder=tcfg.EncoderConfig(**dataclasses.asdict(cfg.encoder)),
        decoder=tcfg.DecoderConfig(**dataclasses.asdict(cfg.decoder)),
        max_length=cfg.max_length,
    )
