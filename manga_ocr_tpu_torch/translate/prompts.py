"""Prompt construction + response parsing for the AI translation paths (the
port's own copy of ``manga_ocr_tpu/translate/prompts.py``).

Single-crop translation prompts (with the enhanced dual-OCR merge mode,
the reference's ``workers.py:411-419``), batch/scene prompts that tag each
text with ``[Text N]`` and parse numbered replies
(``main_window.py:2017-2162``, ``workers.py:576-647``), and review prompts
expecting JSON-array answers (``main_window.py:4728-4766``).  The wording
is original; the contracts (inputs, tags, parse formats) are the
reference's, and both packages send the same bytes.
"""

from __future__ import annotations

import json
import re
from typing import Sequence


def build_translation_prompt(
    text: str,
    target_lang: str = "English",
    source_lang: str = "Japanese",
    is_enhanced: bool = False,
    ocr_results: dict | None = None,
    context: str | None = None,
    style_notes: str | None = None,
) -> str:
    """Single-bubble translation prompt.

    Enhanced mode supplies both OCR passes (raw manga-ocr + binarized
    Tesseract) and asks the model to reconstruct the most plausible source
    text before translating — the dual-pass merge contract."""
    lines = [
        f"You are a professional manga translator. Translate {source_lang} "
        f"manga dialogue into natural, colloquial {target_lang}.",
        "Rules: keep honorifics, preserve tone and speech quirks, do not add "
        "explanations — reply with the translation only.",
    ]
    if style_notes:
        lines.append(f"Style notes: {style_notes}")
    if context:
        lines.append(f"Scene context: {context}")
    if is_enhanced and ocr_results:
        lines.append(
            "Two OCR engines read the same speech bubble; each may contain "
            "recognition errors. Reconstruct the most plausible original "
            "line, then translate it."
        )
        for engine, result in ocr_results.items():
            lines.append(f"OCR[{engine}]: {result}")
    else:
        lines.append(f"Text: {text}")
    return "\n".join(lines)


def build_batch_prompt(
    texts: Sequence[str], target_lang: str = "English", source_lang: str = "Japanese"
) -> str:
    """Numbered batch prompt; answers must come back as ``N. translation``."""
    lines = [
        f"Translate each numbered {source_lang} manga line into {target_lang}.",
        "Reply with one line per item, formatted exactly as 'N. translation' "
        "with the same numbering. No extra commentary.",
        "",
    ]
    for i, t in enumerate(texts, 1):
        lines.append(f"{i}. {t}")
    return "\n".join(lines)


_NUMBERED = re.compile(r"^\s*(\d+)[\.\):]\s*(.*\S)?\s*$")


def parse_numbered_response(reply: str, n: int) -> list[str | None]:
    """Parse ``N. text`` lines back into an n-slot list (None = missing)."""
    out: list[str | None] = [None] * n
    for line in reply.splitlines():
        m = _NUMBERED.match(line)
        if m:
            idx = int(m.group(1)) - 1
            if 0 <= idx < n:
                out[idx] = (m.group(2) or "").strip()
    return out


def build_scene_prompt(
    entries: Sequence[tuple[str, str]],
    target_lang: str = "English",
    instruction: str | None = None,
) -> str:
    """Scene batch: [Text N] tagged originals + current translations, the
    model revises with full-scene context (``process_scene_with_ai``)."""
    lines = [
        "You are reviewing a manga scene. Using the full conversation as "
        f"context, produce improved {target_lang} translations.",
        "Reply with one block per item, each starting with its tag on its own "
        "line, exactly: [Text N] followed by the revised translation.",
    ]
    if instruction:
        lines.append(f"Additional instruction: {instruction}")
    lines.append("")
    for i, (original, current) in enumerate(entries, 1):
        lines.append(f"[Text {i}]")
        lines.append(f"Original: {original}")
        lines.append(f"Current translation: {current}")
        lines.append("")
    return "\n".join(lines)


_SCENE_TAG = re.compile(r"\[Text\s+(\d+)\]", re.IGNORECASE)


def parse_scene_response(reply: str, n: int) -> list[str | None]:
    """Split a [Text N]-tagged reply back into per-entry revisions."""
    out: list[str | None] = [None] * n
    matches = list(_SCENE_TAG.finditer(reply))
    for j, m in enumerate(matches):
        idx = int(m.group(1)) - 1
        if not (0 <= idx < n):
            continue
        end = matches[j + 1].start() if j + 1 < len(matches) else len(reply)
        body = reply[m.end() : end].strip()
        # Drop any echoed "Original:/Current translation:" lines
        body_lines = [
            ln
            for ln in body.splitlines()
            if not re.match(r"^\s*(Original|Current translation)\s*:", ln, re.I)
        ]
        text = "\n".join(body_lines).strip()
        if text:
            out[idx] = text
    return out


def build_review_prompt(
    entries: Sequence[tuple[str, str]], mode: str = "proofread"
) -> str:
    """Batch proofread/quality-check prompt expecting a JSON array reply
    (``_build_review_prompt`` contract)."""
    task = (
        "proofread each translation for grammar, naturalness and typos"
        if mode == "proofread"
        else "assess each translation's accuracy against its original"
    )
    lines = [
        f"For the following manga translations, {task}.",
        'Reply ONLY with a JSON array; element i must be {"index": i, '
        '"verdict": "ok"|"fix", "suggestion": "<improved text or empty>"}.',
        "",
    ]
    for i, (original, translation) in enumerate(entries):
        lines.append(json.dumps({"index": i, "original": original, "translation": translation}, ensure_ascii=False))
    return "\n".join(lines)


def parse_json_array_response(reply: str) -> list[dict]:
    """Extract the first JSON array from a model reply (tolerates fences)."""
    m = re.search(r"\[.*\]", reply, re.DOTALL)
    if not m:
        return []
    try:
        data = json.loads(m.group(0))
    except json.JSONDecodeError:
        return []
    return [d for d in data if isinstance(d, dict)]
