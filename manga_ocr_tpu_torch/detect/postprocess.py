"""Detection post-processing as pure functions (Qt-free; the port's own copy
of ``manga_ocr_tpu/detect/postprocess.py``).

Behavioral rebuild of the reference's detection pipeline helpers, which are
methods on the GUI god-object operating on QPolygon/QRect:

- noise filter (``_filter_detection_noise``,
  ``main_window.py:9551-9598``),
- greedy block merge (``_merge_text_boxes_to_blocks`` ``:9617-9670``),
- over-wide bubble split (``split_extended_bubbles`` ``:8773-8795``).

Items are ``(text, polygon [N,2] int array)``; detections are dicts
``{"polygon": [N,2], "text": str|None}`` (the AutoDetectorWorker schema,
``workers.py:462-474``).
"""

from __future__ import annotations

import math
import re

import numpy as np

from manga_ocr_tpu_torch.core.geometry import (
    Rect,
    axis_overlap_ratio,
    clamp_polygon,
    polygon_bounding_rect,
    polygon_from_rect,
    rect_distance,
)


def clean_detected_text(text: str | None) -> str:
    if not text:
        return ""
    return re.sub(r"\s+", " ", text).strip()


def combine_texts(texts) -> str:
    return " ".join(t.strip() for t in texts if t and t.strip())


def filter_detection_noise(
    items: list[tuple[str, np.ndarray]],
    image_shape: tuple,
    advanced: bool = False,
) -> list[tuple[str, np.ndarray]]:
    """Drop detections that are statistically noise: empty/punctuation-only
    text, degenerate or page-filling boxes, extreme aspect ratios."""
    if not items:
        return []
    h, w = image_shape[:2]
    min_area_ratio = 0.00004 if advanced else 0.00003
    min_area = max(80, min_area_ratio * w * h)
    max_area_ratio = 0.85 if advanced else 0.9

    out = []
    for text, polygon in items:
        cleaned = clean_detected_text(text)
        if not cleaned:
            continue
        if len(cleaned) <= 1 and not cleaned.isalnum():
            continue
        if re.fullmatch(r"[\W_]+", cleaned):
            continue
        letters = sum(ch.isalpha() for ch in cleaned)
        digits = sum(ch.isdigit() for ch in cleaned)
        if advanced:
            if letters == 0 and digits == 0 and len(cleaned) <= 3:
                continue
            if re.fullmatch(r"[!?\-•°]+", cleaned):
                continue
            repeated = re.search(r"(.)\1{2,}", cleaned)
            if repeated and len(cleaned) <= 5 and repeated.group(1) != "~":
                continue
        unique_chars = set(cleaned)
        if len(unique_chars) == 1 and cleaned[0] in "!?…#@*/":
            continue
        punctuation = sum(
            1 for ch in cleaned if not ch.isalnum() and not ch.isspace()
        )
        if advanced and punctuation / max(1, len(cleaned)) > 0.6:
            continue

        rect = polygon_bounding_rect(polygon)
        area = rect.w * rect.h
        if area < min_area or area > w * h * max_area_ratio:
            continue
        if rect.w < 6 or rect.h < 6:
            continue
        aspect = rect.w / max(1, rect.h)
        if advanced and (aspect > 9.0 or aspect < 0.12):
            continue
        out.append((cleaned, clamp_polygon(polygon, w, h)))
    return out


def _rects_should_merge(a: Rect, b: Rect, strict: bool, max_gap: float) -> bool:
    if a.intersects(b):
        return True
    distance = rect_distance(a, b)
    if distance > max_gap:
        return False
    v = axis_overlap_ratio(a.top, a.top + a.h, b.top, b.top + b.h)
    hz = axis_overlap_ratio(a.left, a.left + a.w, b.left, b.left + b.w)
    if strict:
        if v >= 0.35 and distance <= max_gap * 0.75:
            return True
        if hz >= 0.55 and distance <= max_gap * 0.75:
            return True
        return False
    if v >= 0.2 or hz >= 0.65:
        return True
    return distance <= max_gap * 0.6


def merge_text_boxes_to_blocks(
    boxes: list[tuple[str, np.ndarray]],
    image_shape: tuple,
    strict: bool = False,
) -> list[tuple[str, np.ndarray]]:
    """Greedy top-down clustering of text boxes into reading blocks."""
    if not boxes:
        return []
    h, w = image_shape[:2]
    diag = math.hypot(w, h)
    max_gap = diag * (0.018 if strict else 0.04)
    valid = [(t, p) for t, p in boxes if p is not None]
    valid.sort(key=lambda item: polygon_bounding_rect(item[1]).top)

    clusters: list[dict] = []
    for text, polygon in valid:
        rect = polygon_bounding_rect(polygon).clamped(w, h)
        for cluster in clusters:
            if _rects_should_merge(rect, cluster["rect"], strict, max_gap):
                cluster["rect"] = cluster["rect"].united(rect)
                cluster["texts"].append(text)
                break
        else:
            clusters.append({"rect": rect, "texts": [text]})

    return [
        (combine_texts(c["texts"]), polygon_from_rect(c["rect"])) for c in clusters
    ]


def split_extended_bubbles(
    detections: list[dict], split_threshold: float = 2.5
) -> list[dict]:
    """Halve detections with extreme aspect ratio; split halves re-OCR
    (text=None)."""
    out = []
    for item in detections:
        bbox = polygon_bounding_rect(item["polygon"])
        if bbox.w <= 0 or bbox.h <= 0:
            continue
        aspect = bbox.w / bbox.h
        if aspect > split_threshold:
            half = bbox.w // 2
            # second half takes the remainder: odd widths must not drop the
            # bubble's final column from both re-OCR crops
            r1 = Rect(bbox.left, bbox.top, half, bbox.h)
            r2 = Rect(bbox.left + half, bbox.top, bbox.w - half, bbox.h)
            out.append({"polygon": polygon_from_rect(r1), "text": None})
            out.append({"polygon": polygon_from_rect(r2), "text": None})
        elif aspect > 0 and (1 / aspect) > split_threshold:
            half = bbox.h // 2
            r1 = Rect(bbox.left, bbox.top, bbox.w, half)
            r2 = Rect(bbox.left, bbox.top + half, bbox.w, bbox.h - half)
            out.append({"polygon": polygon_from_rect(r1), "text": None})
            out.append({"polygon": polygon_from_rect(r2), "text": None})
        else:
            out.append(item)
    return out
