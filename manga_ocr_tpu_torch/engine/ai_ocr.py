"""AI-OCR: vision-LLM OCR over HTTP (the reference's AI_OCR / MOFRL-GPT; the
port's own copy of ``manga_ocr_tpu/engine/ai_ocr.py``).

The reference's ``_call_ai_ocr`` (``src/ui/main_window.py:10000-10186``)
and ``_call_mofrl_ocr`` (``:10188-10472``):

- the crop is PNG-encoded into a base64 data URL,
- several request payload schemas are tried in order, because OpenAI-style
  endpoints disagree (``image_url`` block, ``input_image`` block, plain text
  prompt with the data URL inline); Gemini uses ``inline_data`` with the key
  in the query string,
- responses are cached on disk keyed by md5(image + prompt + model) so
  re-runs are free (``:10023-10034``),
- ``max_completion_tokens`` replaces ``max_tokens`` for gpt-5* models,
- language-specific prompts (incl. furigana-pairing guidance for Japanese).

Transport is injectable; everything runs offline in tests.
"""

from __future__ import annotations

import base64
import hashlib
import io
import json
import os
from typing import Callable, Optional

import numpy as np

from manga_ocr_tpu_torch.utils.http import robust_post


def _err(msg: str) -> str:
    return f"[ERROR: {msg}]"


def _png_data_url(image_bgr: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(image_bgr[..., ::-1]).save(buf, format="PNG")
    b64 = base64.b64encode(buf.getvalue()).decode()
    return f"data:image/png;base64,{b64}"


def ocr_prompt(lang: str = "ja") -> str:
    """Language-specific OCR prompt.

    Conveys the same output contract as the reference's
    ``_get_ai_ocr_prompt`` (``main_window.py:9933-9998``) in fresh wording:
    plain text only (no commentary/markdown), line breaks kept, punctuation
    preserved, and — for Japanese — furigana or side notes rendered in
    parentheses immediately after the kanji they annotate."""
    base = (
        "Transcribe ALL text visible in this image exactly as written, in "
        "natural reading order. Reply with the transcription only — no "
        "commentary, no translation, no markdown or formatting symbols. "
        "Keep the original line breaks and preserve all punctuation "
        "(including ellipses)."
    )
    if lang.startswith("ja"):
        base += (
            " The text is Japanese; read vertical text top-to-bottom, "
            "right-to-left. When furigana or a small side note accompanies a "
            "kanji — whether written beside, above, or before it — output "
            "the kanji followed by the note in parentheses, e.g. 漢字(note). "
            "Unrelated annotations also go in parentheses. Never merge the "
            "note and the kanji into one bracketed block, and never drop "
            "ellipses (…)."
        )
    return base


def _extract_text(data: dict) -> str | None:
    """Pull the reply text out of OpenAI- or Gemini-shaped responses
    (``_extract_ai_ocr_text`` behavior)."""
    try:  # OpenAI chat
        return data["choices"][0]["message"]["content"].strip()
    except (KeyError, IndexError, TypeError, AttributeError):
        pass
    try:  # Gemini
        parts = data["candidates"][0]["content"]["parts"]
        return "".join(p.get("text", "") for p in parts).strip()
    except (KeyError, IndexError, TypeError):
        pass
    return None


def engine_from_settings(
    settings_root: dict,
    job_settings: dict,
    cache_dir: str | None = None,
    transport: Callable | None = None,
) -> "AiOcrEngine | None":
    """Build the AI-OCR engine instance a job selects.

    The per-job ``ocr_ai_provider`` (the reference's combo payload,
    ``_get_ai_ocr_entries`` at ``main_window.py:3349-3381``) picks the
    provider block under ``settings['ocr']`` and the URL, API key and model
    swap TOGETHER — the payload dialect is keyed on the resulting instance
    URL (see ``perform_ocr``), so a provider switch can never pair one
    provider's dialect with another's endpoint."""
    provider = str(job_settings.get("ocr_ai_provider", "")).strip()
    block = (settings_root.get("ocr") or {}).get(provider) or {}
    url = str(block.get("url") or "").strip()
    if not url:
        return None
    model = str(
        job_settings.get("ocr_ai_model_id")
        or job_settings.get("ocr_ai_model_name")
        or ""
    )
    if not model:
        for m in block.get("models") or []:
            if isinstance(m, dict) and m.get("active") and m.get("id"):
                model = str(m["id"])
                break
    return AiOcrEngine(
        url,
        api_key=str(block.get("api_key") or ""),
        model=model,
        cache_dir=cache_dir,
        transport=transport,
    )


class AiOcrEngine:
    """HTTP vision-LLM OCR with payload-variant ladder + disk cache."""

    def __init__(
        self,
        url: str,
        api_key: str = "",
        model: str = "",
        cache_dir: str | None = None,
        transport: Callable | None = None,
        timeout: float = 90.0,
        max_output_tokens: int = 1024,
    ):
        self.url = url
        self.api_key = api_key
        self.model = model
        self.cache_dir = cache_dir
        self.transport = transport
        self.timeout = timeout
        self.max_output_tokens = max_output_tokens
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    # -- cache ------------------------------------------------------------------

    def _cache_key(self, image_bytes: bytes, prompt: str, model: str) -> str:
        return hashlib.md5(
            image_bytes + prompt.encode() + model.encode()
        ).hexdigest()

    def _cache_get(self, key: str) -> str | None:
        if not self.cache_dir:
            return None
        path = os.path.join(self.cache_dir, f"{key}.json")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)["text"]
            except (OSError, json.JSONDecodeError, KeyError):
                return None
        return None

    def _cache_put(self, key: str, text: str) -> None:
        if not self.cache_dir:
            return
        path = os.path.join(self.cache_dir, f"{key}.json")
        with open(path, "w") as f:
            json.dump({"text": text}, f, ensure_ascii=False)

    # -- payload variants ----------------------------------------------------------

    def _payload_variants(self, data_url: str, prompt: str, model: str) -> list[dict]:
        tokens_key = (
            "max_completion_tokens" if model.startswith("gpt-5") else "max_tokens"
        )
        common = {"model": model, tokens_key: self.max_output_tokens}
        return [
            {  # OpenAI vision: image_url content block
                **common,
                "messages": [
                    {
                        "role": "user",
                        "content": [
                            {"type": "text", "text": prompt},
                            {"type": "image_url", "image_url": {"url": data_url}},
                        ],
                    }
                ],
            },
            {  # responses-style: input_image block
                **common,
                "messages": [
                    {
                        "role": "user",
                        "content": [
                            {"type": "text", "text": prompt},
                            {"type": "input_image", "image_url": data_url},
                        ],
                    }
                ],
            },
            {  # plain text with inline data URL
                **common,
                "messages": [{"role": "user", "content": f"{prompt}\n{data_url}"}],
            },
        ]

    # -- engine interface -------------------------------------------------------------

    def perform_ocr(self, cv_bgr_image: np.ndarray, settings: dict | None = None) -> str:
        settings = settings or {}
        lang = str(settings.get("ocr_lang", "ja"))
        prompt = settings.get("ai_ocr_prompt") or ocr_prompt(lang)
        # The job dict carries the selected AI-OCR model (the reference's
        # combo payload: get_current_settings keys).  Per-job overrides stay
        # LOCAL — mutating self.model would leak one job's selection into
        # every later job and race under the reference's 15-thread worker
        # pattern (and poison the md5 cache key).
        model = (
            settings.get("ocr_ai_model_id")
            or settings.get("ocr_ai_model_name")
            or self.model
        )
        try:
            data_url = _png_data_url(cv_bgr_image)
        except Exception as e:
            return _err(f"encode: {e}")
        image_bytes = data_url.encode()
        key = self._cache_key(image_bytes, prompt, model)
        cached = self._cache_get(key)
        if cached is not None:
            return cached

        # The payload dialect is keyed on the instance URL only: the engine
        # instance is URL-bound, so a per-job provider string mentioning
        # "gemini" must NOT flip an OpenAI-style endpoint onto the Gemini
        # inline_data/?key= path (it would fail every request).  Integration
        # layers that switch providers swap the engine instance (URL + key)
        # together.
        if "generativelanguage" in self.url:
            # Gemini inline_data path — reuse the base64 PNG already encoded
            # for the cache key instead of PNG-compressing the crop again
            b64_png = data_url.split(",", 1)[1]
            return self._call_gemini(b64_png, prompt, key)

        headers = {}
        if self.api_key:
            headers["Authorization"] = f"Bearer {self.api_key}"
        last_error = "no payload variant accepted"
        for payload in self._payload_variants(data_url, prompt, model):
            try:
                resp = robust_post(
                    self.url,
                    json=payload,
                    headers=headers,
                    timeout=self.timeout,
                    transport=self.transport,
                )
            except ConnectionError as e:
                last_error = str(e)
                continue
            if not resp.ok:
                last_error = f"HTTP {resp.status_code}"
                continue
            text = _extract_text(resp.json())
            if text:
                self._cache_put(key, text)
                return text
        return _err(f"AI_OCR: {last_error}")

    def _call_gemini(self, b64_png: str, prompt: str, key: str) -> str:
        payload = {
            "contents": [
                {
                    "parts": [
                        {"text": prompt},
                        {
                            "inline_data": {
                                "mime_type": "image/png",
                                "data": b64_png,
                            }
                        },
                    ]
                }
            ]
        }
        url = f"{self.url}?key={self.api_key}" if self.api_key else self.url
        try:
            resp = robust_post(
                url, json=payload, timeout=self.timeout, transport=self.transport
            )
        except ConnectionError as e:
            return _err(f"AI_OCR: {e}")
        if not resp.ok:
            return _err(f"AI_OCR: HTTP {resp.status_code}")
        text = _extract_text(resp.json())
        if text:
            self._cache_put(key, text)
            return text
        return _err("AI_OCR: empty response")
