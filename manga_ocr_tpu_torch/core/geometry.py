"""Qt-free geometry primitives + JSON serialization (the port's own copy of
``manga_ocr_tpu/core/geometry.py``; NumPy only).

The reference represents regions as ``QRect``/``QPolygon`` and serializes
them for project files (``utils/geometry.py:96-159``).
This framework is GUI-toolkit-free: rects are ``Rect`` dataclasses, polygons
are ``[N, 2]`` int numpy arrays, and the JSON dict/list wire formats match
the reference's so project files interoperate.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def coerce_int(value, default: int = 0) -> int:
    try:
        return int(round(float(value)))
    except (TypeError, ValueError):
        return default


def coerce_float(value, default: float = 0.0) -> float:
    try:
        f = float(value)
    except (TypeError, ValueError):
        return default
    if math.isnan(f) or math.isinf(f):
        return default
    return f


@dataclasses.dataclass(frozen=True)
class Rect:
    """Integer rect, Qt conventions: right = x + w - 1, bottom = y + h - 1."""

    x: int
    y: int
    w: int
    h: int

    @property
    def left(self) -> int:
        return self.x

    @property
    def top(self) -> int:
        return self.y

    @property
    def right(self) -> int:
        return self.x + self.w - 1

    @property
    def bottom(self) -> int:
        return self.y + self.h - 1

    @property
    def area(self) -> int:
        return max(0, self.w) * max(0, self.h)

    def center(self) -> tuple[int, int]:
        return (self.x + self.w // 2, self.y + self.h // 2)

    def intersects(self, o: "Rect") -> bool:
        return not (
            o.left > self.right
            or o.right < self.left
            or o.top > self.bottom
            or o.bottom < self.top
        )

    def united(self, o: "Rect") -> "Rect":
        x1 = min(self.left, o.left)
        y1 = min(self.top, o.top)
        x2 = max(self.right, o.right)
        y2 = max(self.bottom, o.bottom)
        return Rect(x1, y1, x2 - x1 + 1, y2 - y1 + 1)

    def adjusted(self, dl: int, dt: int, dr: int, db: int) -> "Rect":
        x1, y1 = self.left + dl, self.top + dt
        x2, y2 = self.right + dr, self.bottom + db
        return Rect(x1, y1, x2 - x1 + 1, y2 - y1 + 1)

    def clamped(self, width: int, height: int) -> "Rect":
        x = max(0, self.left)
        y = max(0, self.top)
        right = min(self.right, width - 1)
        bottom = min(self.bottom, height - 1)
        right = max(right, x)
        bottom = max(bottom, y)
        return Rect(x, y, right - x + 1, bottom - y + 1)

    def to_dict(self) -> dict:
        return {"x": self.x, "y": self.y, "w": self.w, "h": self.h}

    @staticmethod
    def from_dict(d: dict) -> "Rect":
        return Rect(
            coerce_int(d.get("x")),
            coerce_int(d.get("y")),
            max(0, coerce_int(d.get("w"))),
            max(0, coerce_int(d.get("h"))),
        )


def rect_distance(a: Rect, b: Rect) -> float:
    """Min gap between rect borders (0 when intersecting)."""
    dx = max(0, max(b.left - a.right, a.left - b.right))
    dy = max(0, max(b.top - a.bottom, a.top - b.bottom))
    return math.hypot(dx, dy)


def axis_overlap_ratio(a_start, a_end, b_start, b_end) -> float:
    overlap = max(0.0, min(a_end, b_end) - max(a_start, b_start))
    if overlap <= 0:
        return 0.0
    min_size = max(1.0, min(a_end - a_start, b_end - b_start))
    return overlap / min_size


# -- polygons ([N, 2] int arrays) -------------------------------------------


def polygon_from_rect(r: Rect) -> np.ndarray:
    return np.array(
        [
            [r.left, r.top],
            [r.right, r.top],
            [r.right, r.bottom],
            [r.left, r.bottom],
        ],
        np.int32,
    )


def polygon_bounding_rect(poly: np.ndarray) -> Rect:
    poly = np.asarray(poly)
    x1, y1 = poly.min(axis=0)
    x2, y2 = poly.max(axis=0)
    return Rect(int(x1), int(y1), int(x2 - x1 + 1), int(y2 - y1 + 1))


def clamp_polygon(poly: np.ndarray, width: int, height: int) -> np.ndarray:
    poly = np.asarray(poly).copy()
    poly[:, 0] = np.clip(poly[:, 0], 0, width - 1)
    poly[:, 1] = np.clip(poly[:, 1], 0, height - 1)
    return poly


def polygon_to_list(poly: np.ndarray) -> list:
    return [[int(x), int(y)] for x, y in np.asarray(poly)]


def list_to_polygon(points: list) -> np.ndarray:
    return np.array(
        [[coerce_int(p[0]), coerce_int(p[1])] for p in points if len(p) >= 2],
        np.int32,
    )
