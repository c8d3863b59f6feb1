"""Host-side box extraction from CRAFT score maps (data-dependent shapes; the
port's own copy of ``manga_ocr_tpu/detect/craft_boxes.py``).

Mirrors the public CRAFT ``getDetBoxes`` contract the reference consumes
through EasyOCR (``main_window.py:9805-9810``):

1. binarize: combined = (region ≥ low_text) ∨ (affinity ≥ link_threshold),
2. connected components over the combined map,
3. reject components whose peak region score < text_threshold,
4. expand each component by the upstream size-dependent margin
   (√(area·min(w,h)/(w·h)) · 2) and emit its box in IMAGE coordinates
   (score maps are half input resolution).

Differences from upstream, by design: boxes are axis-aligned (the
recognizer crops axis-aligned lines; upstream's rotated minAreaRect is a
refinement for skewed scene text, not manga pages), and components touch
via 4-connectivity.  Everything here is pure numpy — contours/labeling are
inherently host-side (data-dependent output sizes, SURVEY §7.4).
"""

from __future__ import annotations

import numpy as np


def label_components(binary: np.ndarray) -> tuple[np.ndarray, int]:
    """Two-pass 4-connectivity labeling with union-find (pure numpy rows).

    Returns (labels int32 [H,W] with 0 = background, count)."""
    h, w = binary.shape
    labels = np.zeros((h, w), np.int32)
    parent = [0]  # union-find; parent[0] = background sentinel

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    next_label = 1
    for y in range(h):
        row = binary[y]
        if not row.any():
            continue
        up = labels[y - 1] if y > 0 else None
        for x in np.flatnonzero(row):
            x = int(x)
            left_lab = labels[y, x - 1] if x > 0 and binary[y, x - 1] else 0
            up_lab = int(up[x]) if up is not None and up[x] else 0
            if left_lab and up_lab:
                lab = min(left_lab, up_lab)
                ra, rb = find(left_lab), find(up_lab)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)
            elif left_lab or up_lab:
                lab = left_lab or up_lab
            else:
                parent.append(next_label)
                lab = next_label
                next_label += 1
            labels[y, x] = lab
    # resolve + compact
    if next_label == 1:
        return labels, 0
    roots = np.array([find(i) for i in range(next_label)], np.int32)
    remap = np.zeros(next_label, np.int32)
    uniq = np.unique(roots[1:])
    remap[uniq] = np.arange(1, len(uniq) + 1)
    labels = remap[roots[labels]]
    return labels, len(uniq)


def extract_boxes(
    region: np.ndarray,
    affinity: np.ndarray,
    text_threshold: float = 0.7,
    link_threshold: float = 0.4,
    low_text: float = 0.4,
    min_area: int = 10,
) -> list[tuple[int, int, int, int]]:
    """(region, affinity) half-resolution score maps → [(x, y, w, h)] boxes
    in IMAGE coordinates, reading order (top-to-bottom, left-to-right)."""
    region = np.asarray(region, np.float32)
    affinity = np.asarray(affinity, np.float32)
    combined = (region >= low_text) | (affinity >= link_threshold)
    labels, count = label_components(combined)
    boxes = []
    for lab in range(1, count + 1):
        ys, xs = np.nonzero(labels == lab)
        if ys.size < min_area:
            continue
        if float(region[ys, xs].max()) < text_threshold:
            continue
        x0, x1 = int(xs.min()), int(xs.max()) + 1
        y0, y1 = int(ys.min()), int(ys.max()) + 1
        bw, bh = x1 - x0, y1 - y0
        # upstream size-dependent dilation margin
        margin = int(np.sqrt(ys.size * min(bw, bh) / (bw * bh)) * 2.0)
        x0 = max(0, x0 - margin)
        y0 = max(0, y0 - margin)
        x1 = min(region.shape[1], x1 + margin)
        y1 = min(region.shape[0], y1 + margin)
        # score maps are half input resolution
        boxes.append((x0 * 2, y0 * 2, (x1 - x0) * 2, (y1 - y0) * 2))
    boxes.sort(key=lambda b: (b[1], b[0]))
    return boxes


def group_lines(
    boxes: list[tuple[int, int, int, int]], overlap: float = 0.5
) -> list[list[tuple[int, int, int, int]]]:
    """Group word boxes into text lines by vertical-overlap ratio, each line
    sorted left-to-right (the EasyOCR paragraph-assembly behavior the
    engine's joined-text output mirrors)."""
    lines: list[list[tuple[int, int, int, int]]] = []
    for box in sorted(boxes, key=lambda b: b[1] + b[3] / 2):
        x, y, w, h = box
        for line in lines:
            ly0 = min(b[1] for b in line)
            ly1 = max(b[1] + b[3] for b in line)
            inter = min(y + h, ly1) - max(y, ly0)
            if inter > overlap * min(h, ly1 - ly0):
                line.append(box)
                break
        else:
            lines.append([box])
    for line in lines:
        line.sort(key=lambda b: b[0])
    lines.sort(key=lambda line: min(b[1] for b in line))
    return lines
