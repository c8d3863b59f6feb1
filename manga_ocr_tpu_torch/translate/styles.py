"""Translation styles: named reusable prompt-style presets (the port's own
copy of ``manga_ocr_tpu/translate/styles.py``).

The reference's translation-styles store (JSON next to the settings,
``src/ui/main_window.py:4424-4461``; the per-area ``translation_style``
field of ``TypesetArea``).  A style is a name plus prompt guidance (tone,
register, honorific policy) that flows into ``build_translation_prompt``'s
``style_notes``.
"""

from __future__ import annotations

import json
import os
import threading

DEFAULT_STYLES = {
    "Standard": "Natural, colloquial dialogue.",
    "Formal": "Polite, formal register; preserve keigo distinctions.",
    "Casual": "Loose, casual speech; contractions welcome.",
    "Literal": "Stay close to the source structure; no localization.",
}


class TranslationStyles:
    def __init__(self, path: str | None = None):
        self.path = path
        self._lock = threading.Lock()
        self._styles = dict(DEFAULT_STYLES)
        if path and os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    data = json.load(f)
                if isinstance(data, dict):
                    self._styles.update(
                        {str(k): str(v) for k, v in data.items()}
                    )
            except (OSError, json.JSONDecodeError):
                pass

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._styles)

    def get(self, name: str) -> str | None:
        with self._lock:
            return self._styles.get(name)

    def set(self, name: str, notes: str) -> None:
        with self._lock:
            self._styles[name] = notes

    def delete(self, name: str) -> None:
        with self._lock:
            self._styles.pop(name, None)

    def save(self) -> None:
        if not self.path:
            return
        with self._lock:
            data = dict(self._styles)
        tmp = f"{self.path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(data, f, ensure_ascii=False, indent=2)
        os.replace(tmp, self.path)
