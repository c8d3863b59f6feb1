"""Translation dispatch service: provider routing, rate limits, fallbacks
(the port's own copy of ``manga_ocr_tpu/translate/service.py``).

The reference's translate orchestration (``translate_with_ai`` dispatch,
``src/ui/main_window.py:3854-3862``; the DeepL fallback ladder,
``workers.py:359-380`` and ``translate_text`` ``:5103-5142``; the
rate-limit wait, ``workers.py:424-432``):

- provider chosen per call (settings-driven),
- AI failure falls back to DeepL when a key exists,
- every AI call passes the rate limiter (blocking acquire) and records
  token costs,
- errors surface as ``"[ERROR: ...]"`` sentinel strings, never exceptions
  (the pipeline contract).
"""

from __future__ import annotations

from typing import Callable, Optional

from manga_ocr_tpu_torch.core.settings import Settings
from manga_ocr_tpu_torch.translate import prompts
from manga_ocr_tpu_torch.translate.providers import (
    DeepLClient,
    GeminiClient,
    OpenAIClient,
    OpenRouterClient,
    ProviderError,
)
from manga_ocr_tpu_torch.utils.rate_limit import RateLimiter


def _err(msg: str) -> str:
    return f"[ERROR: {msg}]"


class TranslationService:
    def __init__(
        self,
        settings: Settings | None = None,
        rate_limiter: RateLimiter | None = None,
        transport: Callable | None = None,
    ):
        self.settings = settings or Settings()
        self.limiter = rate_limiter or RateLimiter()
        self.transport = transport
        self._clients: dict[str, object] = {}

    # -- client factory --------------------------------------------------------

    def _client(self, provider: str):
        # Fetch the active key EVERY call: get_active_key round-robins over
        # the configured keys to spread quota, so the cache is per
        # (provider, key) — caching per provider alone would pin the first
        # key forever and defeat the rotation.
        key = self.settings.get_active_key(provider)
        if not key:
            raise ProviderError(f"no API key configured for {provider}")
        cached = self._clients.get((provider, key))
        if cached is not None:
            return cached
        if provider == "gemini":
            client = GeminiClient(key, transport=self.transport)
        elif provider == "openai":
            client = OpenAIClient(key, transport=self.transport)
        elif provider == "openrouter":
            url = self.settings.get("translate.openrouter.url")
            client = OpenRouterClient(key, base_url=url, transport=self.transport)
        elif provider == "deepl":
            client = DeepLClient(key, transport=self.transport)
        else:
            raise ProviderError(f"unknown provider {provider}")
        self._clients[(provider, key)] = client
        return client

    # -- main entry points -------------------------------------------------------

    def translate_with_ai(
        self,
        text: str,
        provider: str = "gemini",
        model: str = "gemini-2.5-flash-lite",
        target_lang: str = "English",
        is_enhanced: bool = False,
        ocr_results: dict | None = None,
        context: str | None = None,
    ) -> str:
        """AI translation with rate limiting, cost accounting and DeepL
        fallback; sentinel error string on total failure."""
        prompt = prompts.build_translation_prompt(
            text,
            target_lang=target_lang,
            is_enhanced=is_enhanced,
            ocr_results=ocr_results,
            context=context,
        )
        try:
            client = self._client(provider)
            self.limiter.acquire(model)
            out = client.generate(prompt, model=model)
            u = client.last_usage
            self.limiter.add_cost(model, u.input_tokens, u.output_tokens)
            if out:
                return out
        except ProviderError:
            pass
        except Exception as e:  # unexpected — still never raise to pipeline
            return _err(f"{type(e).__name__}: {e}")
        # Fallback ladder: DeepL if configured
        fallback = self.translate_text(text, target_lang=target_lang)
        if fallback:
            return fallback
        return _err(f"translation failed via {provider}/{model}")

    def translate_for_job(self, text: str, settings: dict) -> str | None:
        """The reference's per-job translation routing
        (``run_standard_pipeline``, ``workers.py:359-380``):

        1. ``use_ai_only_translate`` → AI provider/model from
           ``settings['ai_model']`` (a (provider, model) pair),
        2. ``use_deepl_only_translate`` → plain DeepL,
        3. default → DeepL (the standard non-AI flow).

        Enhanced jobs carry ``is_enhanced``/``ocr_results`` (the dual-pass
        merge contract) into the AI prompt."""
        settings = settings or {}
        target = settings.get("target_lang", "English")
        if settings.get("use_ai_only_translate"):
            ai_model = settings.get("ai_model") or ("gemini", "gemini-2.5-flash-lite")
            provider, model = ai_model
            return self.translate_with_ai(
                text,
                provider=provider,
                model=model,
                target_lang=target,
                is_enhanced=bool(settings.get("is_enhanced")),
                ocr_results=settings.get("ocr_results"),
            )
        if settings.get("use_deepl_only_translate"):
            return self.translate_text(text, target_lang=target)
        # option 3: standard flow — DeepL as the primary non-AI translator
        return self.translate_text(text, target_lang=target)

    def translate_text(self, text: str, target_lang: str = "English") -> str | None:
        """Plain DeepL translation (the reference's non-AI path)."""
        lang_code = {"english": "EN", "indonesian": "ID", "japanese": "JA"}.get(
            target_lang.lower(), target_lang[:2].upper()
        )
        try:
            client = self._client("deepl")
            self.limiter.acquire("deepl")
            return client.translate(text, target_lang=lang_code)
        except ProviderError:
            return None

    def translate_batch(
        self,
        texts: list[str],
        provider: str = "gemini",
        model: str = "gemini-2.5-flash-lite",
        target_lang: str = "English",
    ) -> list[str | None]:
        """One numbered prompt for many texts; per-slot parse-back
        (``BatchProcessorWorker``'s Gemini path, without its NameError bugs —
        SURVEY §2.8)."""
        if not texts:
            return []
        prompt = prompts.build_batch_prompt(texts, target_lang=target_lang)
        try:
            client = self._client(provider)
            self.limiter.acquire(model)
            reply = client.generate(prompt, model=model)
            u = client.last_usage
            self.limiter.add_cost(model, u.input_tokens, u.output_tokens)
        except ProviderError as e:
            return [None] * len(texts)
        return prompts.parse_numbered_response(reply, len(texts))

    def review_scene(
        self,
        entries: list[tuple[str, str]],
        provider: str = "gemini",
        model: str = "gemini-2.5-flash-lite",
        target_lang: str = "English",
        instruction: str | None = None,
    ) -> list[str | None]:
        """Scene-context revision pass ([Text N] contract)."""
        if not entries:
            return []
        prompt = prompts.build_scene_prompt(entries, target_lang, instruction)
        try:
            client = self._client(provider)
            self.limiter.acquire(model)
            reply = client.generate(prompt, model=model)
        except ProviderError:
            return [None] * len(entries)
        return prompts.parse_scene_response(reply, len(entries))

    def review_batch(
        self,
        entries: list[tuple[str, str]],
        mode: str = "proofread",
        provider: str = "gemini",
        model: str = "gemini-2.5-flash-lite",
    ) -> list[dict]:
        """Proofread/QC pass returning structured suggestions."""
        if not entries:
            return []
        prompt = prompts.build_review_prompt(entries, mode)
        try:
            client = self._client(provider)
            self.limiter.acquire(model)
            reply = client.generate(prompt, model=model)
        except ProviderError:
            return []
        return prompts.parse_json_array_response(reply)
