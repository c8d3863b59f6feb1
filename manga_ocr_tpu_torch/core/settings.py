"""Settings system: schema-compatible JSON config with deep-merge defaults
(the port's own copy of ``manga_ocr_tpu/core/settings.py``).

A ``settings.json`` whose user values deep-merge over ``default_settings()``,
plus accessors for API keys with round-robin rotation (the reference's
``get_active_key``, ``src/core/config.py:273-295``).  The JSON schema is the
reference's (``config.py:122-266``), so existing settings files load
unchanged.  The engine knobs live under the ``"tpu"`` block with the JAX
package's key names (``tpu.detector_checkpoint``,
``tpu.latin_craft_checkpoint``, ...): the block's name is part of the file
format that both packages read, not a statement about the hardware.
"""

from __future__ import annotations

import copy
import json
import os
import sys
import threading
from typing import Any


def default_settings() -> dict:
    if sys.platform.startswith("win"):
        default_tess = r"C:\Program Files\Tesseract-OCR\tesseract.exe"
    elif sys.platform.startswith("darwin"):
        default_tess = "/usr/local/bin/tesseract"
    else:
        default_tess = "/usr/bin/tesseract"
    return {
        "general": {"save_format": "PNG", "save_quality": 95},
        "apis": {
            "gemini": {"keys": []},
            "openai": {"keys": []},
            "deepl": {"keys": []},
            "google": {"keys": []},
        },
        "tesseract": {"path": default_tess, "auto_detected": False},
        "cleanup": {
            "use_background_box": True,
            "use_inpaint": True,
            "apply_mode": "selected",
            "text_color_threshold": 128,
            "auto_text_color": True,
            "remove_ai_temp_files": False,
        },
        "typeset": {
            "outline_enabled": True,
            "outline_thickness": 2,
            "outline_width": 2.0,
            "outline_color": "#000000",
            "outline_style": "stroke",
        },
        "ocr": {
            "openrouter": {
                "url": "https://openrouter.ai/api/v1/chat/completions",
                "api_key": "",
                "models": [],
            },
            "other": {"url": "", "api_key": "", "models": []},
        },
        "translate": {
            "openrouter": {
                "url": "https://openrouter.ai/api/v1/chat/completions",
                "api_key": "",
                "models": [],
            },
            "other": {"url": "", "api_key": "", "models": []},
        },
        "autosave": {"enabled": True, "interval_ms": 300000},
        # -- TPU engine block (new; additive to the reference schema) --------
        "tpu": {
            "checkpoint_dir": "",  # HF checkpoint dir for the OCR model
            "detector_checkpoint": "",  # .npz for the bubble segmenter
            "compute_dtype": "bfloat16",
            "max_decode_length": 300,
            "microbatch_window_ms": 10,
            "mesh": {"data": -1, "model": 1},  # -1 = all remaining devices
            # TPU-native Latin engine (engine/latin.py): torch .pth
            # checkpoints converted at load time (models/convert_latin.py);
            # latin_crnn_checkpoint may also be a native dir written by
            # train_latin (its manifest then provides the charset)
            "latin_craft_checkpoint": "",
            "latin_crnn_checkpoint": "",
            "latin_charset": "",  # "" = engine default charset
        },
    }


def deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge ``override`` into a copy of ``base``."""
    out = copy.deepcopy(base)
    for key, val in (override or {}).items():
        if isinstance(val, dict) and isinstance(out.get(key), dict):
            out[key] = deep_merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


def load_or_create_settings(path: str) -> dict:
    """Load settings.json deep-merged over defaults; create it if missing."""
    defaults = default_settings()
    if os.path.exists(path):
        try:
            with open(path, encoding="utf-8") as f:
                user = json.load(f)
        except (OSError, json.JSONDecodeError):
            user = {}
        merged = deep_merge(defaults, user if isinstance(user, dict) else {})
    else:
        merged = defaults
        save_settings(merged, path)
    return merged


def save_settings(settings: dict, path: str) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(settings, f, ensure_ascii=False, indent=2)
    os.replace(tmp, path)  # atomic (the reference's project-save discipline)


class Settings:
    """Thread-safe settings store with dotted-path access and key rotation."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._data = load_or_create_settings(path) if path else default_settings()
        self._key_cursor: dict[str, int] = {}

    def get(self, dotted: str, default: Any = None) -> Any:
        node: Any = self._data
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                return default
            node = node[part]
        return node

    def set(self, dotted: str, value: Any) -> None:
        with self._lock:
            parts = dotted.split(".")
            node = self._data
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value

    def save(self) -> None:
        if self.path:
            with self._lock:
                save_settings(self._data, self.path)

    def as_dict(self) -> dict:
        return copy.deepcopy(self._data)

    # -- API key management (reference: get_active_key, round-robin) ---------

    def get_active_key(self, provider: str) -> str | None:
        keys = self.get(f"apis.{provider}.keys") or []
        keys = [k for k in keys if k]
        if not keys:
            return None
        with self._lock:
            i = self._key_cursor.get(provider, 0) % len(keys)
            self._key_cursor[provider] = i + 1
        return keys[i]

    def add_key(self, provider: str, key: str) -> None:
        with self._lock:
            keys = (
                self._data.setdefault("apis", {})
                .setdefault(provider, {})
                .setdefault("keys", [])
            )
            if key not in keys:
                keys.append(key)
