"""Retrying HTTP client for the cloud translation / AI-OCR providers (the
port's own copy of ``manga_ocr_tpu/utils/http.py``).

The reference's ``robust_post`` (``src/utils/helpers.py:114-149``): POST
with bounded retries, exponential backoff with jitter, and 4xx treated as
fatal except 429 (rate limit).  Uses ``requests`` when it is installed,
the standard library's ``urllib`` otherwise, and accepts an injected
transport (tests run without the network).
"""

from __future__ import annotations

import json as jsonlib
import os
import time
from typing import Callable, Optional


class HttpResponse:
    def __init__(self, status: int, body: bytes, headers: dict | None = None):
        self.status_code = status
        self.content = body
        self.headers = headers or {}

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self):
        return jsonlib.loads(self.text)

    @property
    def ok(self) -> bool:
        return 200 <= self.status_code < 300


def _default_transport(
    url: str, data: bytes, headers: dict, timeout: float
) -> HttpResponse:
    try:
        import requests

        r = requests.post(url, data=data, headers=headers, timeout=timeout)
        return HttpResponse(r.status_code, r.content, dict(r.headers))
    except ImportError:
        import urllib.error
        import urllib.request

        req = urllib.request.Request(url, data=data, headers=headers, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return HttpResponse(resp.status, resp.read(), dict(resp.headers))
        except urllib.error.HTTPError as e:
            return HttpResponse(e.code, e.read() or b"", dict(e.headers or {}))


def _jitter() -> float:
    """0..1 jitter from os.urandom (no global RNG state)."""
    return int.from_bytes(os.urandom(2), "big") / 65535.0


def robust_post(
    url: str,
    json: dict | None = None,
    data: bytes | None = None,
    headers: dict | None = None,
    timeout: float = 60.0,
    max_retries: int = 3,
    backoff_base: float = 1.5,
    transport: Callable[..., HttpResponse] | None = None,
    sleep: Callable[[float], None] = time.sleep,
) -> HttpResponse:
    """POST with retries.  Retriable: network errors, 5xx, 429.
    Non-retriable: other 4xx (client errors won't heal)."""
    transport = transport or _default_transport
    headers = dict(headers or {})
    if json is not None:
        data = jsonlib.dumps(json).encode("utf-8")
        headers.setdefault("Content-Type", "application/json")
    last_exc: Exception | None = None
    last_resp: HttpResponse | None = None
    for attempt in range(max_retries + 1):
        try:
            resp = transport(url, data or b"", headers, timeout)
            if resp.ok:
                return resp
            if 400 <= resp.status_code < 500 and resp.status_code != 429:
                return resp  # fatal client error: surface immediately
            last_resp = resp
        except Exception as e:  # network layer
            last_exc = e
        if attempt < max_retries:
            delay = (backoff_base**attempt) + _jitter()
            sleep(delay)
    if last_resp is not None:
        return last_resp
    raise ConnectionError(f"POST {url} failed after {max_retries + 1} attempts") from last_exc
