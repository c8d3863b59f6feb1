"""Cloud translation provider clients (Gemini / OpenAI / OpenRouter / DeepL;
the port's own copy of ``manga_ocr_tpu/translate/providers.py``).

The reference's provider layer (``translate_with_gemini``
``src/ui/main_window.py:3865``, ``translate_with_openai`` ``:3955``,
``translate_with_openrouter`` ``:4090``, DeepL ``translate_text``
``:5103``) on plain HTTP (``robust_post``) instead of vendor SDKs: one
retry policy and an injectable transport, so every path runs offline.  Each
client returns the reply text or raises ``ProviderError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from manga_ocr_tpu_torch.utils.http import HttpResponse, robust_post


class ProviderError(RuntimeError):
    pass


@dataclasses.dataclass
class Usage:
    input_tokens: int = 0
    output_tokens: int = 0


class _BaseClient:
    def __init__(self, api_key: str, transport: Callable | None = None, timeout: float = 60.0):
        self.api_key = api_key
        self.transport = transport
        self.timeout = timeout
        self.last_usage = Usage()

    def _post(self, url: str, json: dict, headers: dict) -> HttpResponse:
        resp = robust_post(
            url, json=json, headers=headers, timeout=self.timeout, transport=self.transport
        )
        if not resp.ok:
            raise ProviderError(f"HTTP {resp.status_code}: {resp.text[:300]}")
        return resp


class GeminiClient(_BaseClient):
    URL = "https://generativelanguage.googleapis.com/v1beta/models/{model}:generateContent"

    def generate(self, prompt: str, model: str = "gemini-2.5-flash-lite") -> str:
        url = self.URL.format(model=model) + f"?key={self.api_key}"
        payload = {
            "contents": [{"parts": [{"text": prompt}]}],
            # The reference disables all safety blocks for manga dialogue.
            "safetySettings": [
                {"category": c, "threshold": "BLOCK_NONE"}
                for c in (
                    "HARM_CATEGORY_HARASSMENT",
                    "HARM_CATEGORY_HATE_SPEECH",
                    "HARM_CATEGORY_SEXUALLY_EXPLICIT",
                    "HARM_CATEGORY_DANGEROUS_CONTENT",
                )
            ],
        }
        data = self._post(url, payload, {}).json()
        try:
            cand = data["candidates"][0]
            text = "".join(p.get("text", "") for p in cand["content"]["parts"])
        except (KeyError, IndexError) as e:
            raise ProviderError(f"unexpected Gemini response: {data}") from e
        meta = data.get("usageMetadata", {})
        self.last_usage = Usage(
            meta.get("promptTokenCount", 0), meta.get("candidatesTokenCount", 0)
        )
        return text.strip()


class OpenAIClient(_BaseClient):
    URL = "https://api.openai.com/v1/chat/completions"

    def __init__(self, api_key: str, base_url: str | None = None, **kw):
        super().__init__(api_key, **kw)
        self.url = base_url or self.URL

    def generate(
        self, prompt: str, model: str = "gpt-4o-mini", system: str | None = None
    ) -> str:
        messages = []
        if system:
            messages.append({"role": "system", "content": system})
        messages.append({"role": "user", "content": prompt})
        payload: dict = {"model": model, "messages": messages}
        # gpt-5* models reject custom temperature and use max_completion_tokens
        # (the reference special-cases this, main_window.py:10263-10265).
        if not model.startswith("gpt-5"):
            payload["temperature"] = 0.3
        data = self._post(
            self.url, payload, {"Authorization": f"Bearer {self.api_key}"}
        ).json()
        try:
            text = data["choices"][0]["message"]["content"]
        except (KeyError, IndexError) as e:
            raise ProviderError(f"unexpected OpenAI response: {data}") from e
        usage = data.get("usage", {})
        self.last_usage = Usage(
            usage.get("prompt_tokens", 0), usage.get("completion_tokens", 0)
        )
        return (text or "").strip()


class OpenRouterClient(OpenAIClient):
    """OpenRouter speaks the OpenAI chat schema at a different URL."""

    URL = "https://openrouter.ai/api/v1/chat/completions"

    def __init__(self, api_key: str, base_url: str | None = None, **kw):
        super().__init__(api_key, base_url or self.URL, **kw)


class DeepLClient(_BaseClient):
    URL_FREE = "https://api-free.deepl.com/v2/translate"
    URL_PRO = "https://api.deepl.com/v2/translate"

    def translate(
        self, text: str, target_lang: str = "EN", source_lang: str | None = None
    ) -> str:
        url = self.URL_FREE if self.api_key.endswith(":fx") else self.URL_PRO
        payload: dict = {"text": [text], "target_lang": target_lang.upper()}
        if source_lang:
            payload["source_lang"] = source_lang.upper()
        data = self._post(
            url, payload, {"Authorization": f"DeepL-Auth-Key {self.api_key}"}
        ).json()
        try:
            return data["translations"][0]["text"]
        except (KeyError, IndexError) as e:
            raise ProviderError(f"unexpected DeepL response: {data}") from e
