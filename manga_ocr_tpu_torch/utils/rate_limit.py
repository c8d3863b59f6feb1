"""Per-model rate limiting + usage/cost accounting (the port's own copy of
``manga_ocr_tpu/utils/rate_limit.py``).

Per-model RPM/RPD windows with a usage store persisted across sessions (the
reference's ``check_and_increment_usage``, ``src/ui/main_window.py:
5186-5216``; its pickle store ``:5144-5184``; cost accounting
``add_api_cost`` ``:3669-3706``).  Differences from the reference by
design: JSON persistence instead of pickle, an injected clock for tests,
and a blocking ``acquire`` in place of the reference's worker
sleep-to-minute loop (``workers.py:424-432``)."""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass(frozen=True)
class ModelLimits:
    rpm: int = 0  # 0 = unlimited
    rpd: int = 0
    input_cost_per_1k: float = 0.0
    output_cost_per_1k: float = 0.0


# Representative provider/model limit+pricing table (the reference embeds one
# at main_window.py:544-598; values are user-editable settings, not contract).
DEFAULT_LIMITS: dict[str, ModelLimits] = {
    "gemini-2.5-flash-lite": ModelLimits(4000, 10_000_000, 0.0001, 0.0004),
    "gemini-2.5-flash": ModelLimits(1000, 10_000, 0.0003, 0.0025),
    "gpt-4o-mini": ModelLimits(500, 10_000, 0.00015, 0.0006),
    "deepl": ModelLimits(0, 0, 0.0, 0.0),
}


class RateLimiter:
    """Sliding-window RPM/RPD limiter with blocking acquire."""

    def __init__(
        self,
        limits: dict[str, ModelLimits] | None = None,
        store_path: str | None = None,
        clock: Callable[[], float] = time.time,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.limits = dict(limits or DEFAULT_LIMITS)
        self.store_path = store_path
        self.clock = clock
        self.sleep = sleep
        self._lock = threading.Lock()
        # model -> deque of request timestamps, pruned to the 24h window
        # (deque: O(1) popleft — the rpd window can legitimately hold
        # millions of entries at e.g. gemini-flash-lite's 10M rpd).  A
        # separate 60s deque serves the rpm check so acquire never scans
        # the day window.
        self._requests: dict[str, deque[float]] = {}
        self._minute: dict[str, deque[float]] = {}
        self._costs: dict[str, float] = {}
        self._tokens: dict[str, dict[str, int]] = {}
        self._load()

    # -- limiting -------------------------------------------------------------

    def _prune(self, model: str, now: float) -> tuple[deque, deque]:
        reqs = self._requests.setdefault(model, deque())
        cutoff = now - 86400.0
        while reqs and reqs[0] < cutoff:
            reqs.popleft()
        minute = self._minute.setdefault(model, deque())
        m_cutoff = now - 60.0
        while minute and minute[0] <= m_cutoff:
            minute.popleft()
        return reqs, minute

    def try_acquire(self, model: str) -> bool:
        """Non-blocking: register one request if within limits."""
        lim = self.limits.get(model, ModelLimits())
        now = self.clock()
        with self._lock:
            reqs, minute = self._prune(model, now)
            if lim.rpm and len(minute) >= lim.rpm:
                return False
            if lim.rpd and len(reqs) >= lim.rpd:
                return False
            reqs.append(now)
            minute.append(now)
            return True

    def seconds_until_slot(self, model: str) -> float:
        lim = self.limits.get(model, ModelLimits())
        now = self.clock()
        with self._lock:
            reqs, minute = self._prune(model, now)
            waits = [0.0]
            if lim.rpm and len(minute) >= lim.rpm:
                waits.append(minute[0] + 60.0 - now)
            if lim.rpd and len(reqs) >= lim.rpd:
                waits.append(reqs[0] + 86400.0 - now)
            return max(waits)

    def acquire(self, model: str, timeout: float | None = None) -> bool:
        """Block until a slot frees (the reference's wait_for_api_slot)."""
        deadline = None if timeout is None else self.clock() + timeout
        while not self.try_acquire(model):
            wait = max(0.05, self.seconds_until_slot(model))
            if deadline is not None:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    return False
                wait = min(wait, remaining)
            self.sleep(wait)
        return True

    # -- accounting -----------------------------------------------------------

    def add_cost(self, model: str, input_tokens: int, output_tokens: int) -> float:
        lim = self.limits.get(model, ModelLimits())
        cost = (
            input_tokens / 1000.0 * lim.input_cost_per_1k
            + output_tokens / 1000.0 * lim.output_cost_per_1k
        )
        with self._lock:
            self._costs[model] = self._costs.get(model, 0.0) + cost
            tk = self._tokens.setdefault(model, {"input": 0, "output": 0})
            tk["input"] += input_tokens
            tk["output"] += output_tokens
        return cost

    def usage_summary(self) -> dict:
        now = self.clock()
        with self._lock:
            out = {}
            for model in list(self._requests):
                reqs, minute = self._prune(model, now)
                out[model] = {
                    "rpm_used": len(minute),
                    "rpd_used": len(reqs),
                    "cost_usd": round(self._costs.get(model, 0.0), 6),
                    "tokens": dict(self._tokens.get(model, {})),
                }
            return out

    # -- persistence ----------------------------------------------------------

    def save(self) -> None:
        if not self.store_path:
            return
        # Snapshot COPIES under the lock: serializing the live structures
        # outside it races concurrent try_acquire/add_cost mutation
        # ("dictionary changed size during iteration" / torn files).
        with self._lock:
            payload = {
                "requests": {k: list(v) for k, v in self._requests.items()},
                "costs": dict(self._costs),
                "tokens": {k: dict(v) for k, v in self._tokens.items()},
            }
        tmp = f"{self.store_path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.store_path)

    def _load(self) -> None:
        if not self.store_path or not os.path.exists(self.store_path):
            return
        try:
            with open(self.store_path) as f:
                payload = json.load(f)
            now = self.clock()
            self._requests = {
                k: deque(v) for k, v in payload.get("requests", {}).items()
            }
            # the 60s window is derived state: rebuild it from the tail
            self._minute = {
                k: deque(t for t in v if t > now - 60.0)
                for k, v in self._requests.items()
            }
            self._costs = dict(payload.get("costs", {}))
            self._tokens = dict(payload.get("tokens", {}))
        except (OSError, json.JSONDecodeError, TypeError):
            pass
