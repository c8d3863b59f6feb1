"""TypesetArea — the serializable unit of typeset output (Qt-free; the port's
own copy of ``manga_ocr_tpu/typeset/area.py``).

Behavioral rebuild of the reference's ``TypesetArea``
(``canvas.py:78-675``): the datatype the OCR→translate
pipeline produces and the renderer consumes, persisted in project JSON.
The payload schema matches the reference's ``to_payload``/``from_payload``
(``canvas.py:388-547``) so project files interoperate; fonts are plain dicts
(family/size/bold/italic) and colors are hex strings instead of QFont/QColor.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Optional

import numpy as np

from manga_ocr_tpu_torch.core.geometry import (
    Rect,
    coerce_float,
    coerce_int,
    list_to_polygon,
    polygon_from_rect,
    polygon_to_list,
)

DEFAULT_FONT = {"family": "Arial", "size": 12, "bold": False, "italic": False}


def _sanitize_font(font: dict | None, fallback: dict | None = None) -> dict:
    base = dict(fallback or DEFAULT_FONT)
    if isinstance(font, dict):
        base["family"] = str(font.get("family", base["family"]))
        base["size"] = max(1, coerce_int(font.get("size", base["size"]), base["size"]))
        base["bold"] = bool(font.get("bold", base["bold"]))
        base["italic"] = bool(font.get("italic", base["italic"]))
    return base


def _sanitize_color(color, fallback: str = "#000000") -> str:
    if isinstance(color, str) and color.startswith("#") and len(color) in (7, 9):
        return color
    return fallback


@dataclasses.dataclass
class TypesetArea:
    rect: Rect = dataclasses.field(default_factory=lambda: Rect(0, 0, 0, 0))
    text: str = ""
    font: dict = dataclasses.field(default_factory=lambda: dict(DEFAULT_FONT))
    color: str = "#000000"
    polygon: Optional[np.ndarray] = None
    # Cleanup geometry is frozen at creation (the reference freezes it so
    # user edits to the text region don't change what gets erased).
    cleanup_rect: Optional[Rect] = None
    cleanup_polygon: Optional[np.ndarray] = None
    orientation: str = "horizontal"  # or "vertical"
    effect: str = "none"  # none | curved | wavy | jagged
    effect_intensity: float = 0.0
    bezier_points: Optional[list] = None
    bubble_enabled: bool = False
    bubble_fill: str = "#ffffff"
    bubble_outline: str = "#000000"
    bubble_outline_width: float = 3.0
    segments: list = dataclasses.field(default_factory=list)  # rich text runs
    text_outline: bool = False
    text_outline_width: float = 2.0
    text_outline_color: str = "#000000"
    text_outline_style: str = "stroke"  # stroke | glow
    alignment: str = "center"  # left | center | right
    line_spacing: float = 1.0
    char_spacing: float = 0.0
    rotation: float = 0.0
    margins: dict = dataclasses.field(
        default_factory=lambda: {"top": 0, "right": 0, "bottom": 0, "left": 0}
    )
    history_id: Optional[str] = None
    original_text: str = ""
    translation_style: str = ""
    review_notes: dict = dataclasses.field(default_factory=dict)
    overrides: dict = dataclasses.field(default_factory=dict)
    gradient_enabled: bool = False
    gradient_colors: Optional[list] = None
    gradient_angle: float = 0.0

    def __post_init__(self):
        if self.polygon is None:
            self.polygon = polygon_from_rect(self.rect)
        if self.cleanup_rect is None:
            self.cleanup_rect = self.rect
        if self.cleanup_polygon is None:
            self.cleanup_polygon = np.array(self.polygon, np.int32)

    # -- per-area overrides (cleanup behavior knobs) --------------------------

    def get_override(self, key: str, default: Any = None) -> Any:
        return self.overrides.get(key, default)

    def set_override(self, key: str, value: Any) -> None:
        self.overrides[key] = value

    # -- serialization ----------------------------------------------------------

    def to_payload(self) -> dict:
        return {
            "rect": self.rect.to_dict(),
            "cleanup_rect": (self.cleanup_rect or self.rect).to_dict(),
            "text": self.text or "",
            "font": _sanitize_font(self.font),
            "color": _sanitize_color(self.color),
            "polygon": polygon_to_list(self.polygon),
            "cleanup_polygon": polygon_to_list(
                self.cleanup_polygon if self.cleanup_polygon is not None else self.polygon
            ),
            "orientation": self.orientation,
            "effect": self.effect,
            "effect_intensity": float(self.effect_intensity),
            "bezier_points": self.bezier_points or None,
            "bubble_enabled": bool(self.bubble_enabled),
            "segments": copy.deepcopy(self.segments or []),
            "bubble_fill": self.bubble_fill or "#ffffff",
            "bubble_outline": self.bubble_outline or "#000000",
            # NB: 0.0 is a legitimate "no outline" width — default only when
            # unset, or save/load would resurrect a removed outline
            "bubble_outline_width": float(
                3.0 if self.bubble_outline_width is None else self.bubble_outline_width
            ),
            "text_outline": bool(self.text_outline),
            "text_outline_width": float(self.text_outline_width),
            "text_outline_color": _sanitize_color(self.text_outline_color),
            "text_outline_style": self.text_outline_style,
            "alignment": self.alignment,
            "line_spacing": float(self.line_spacing),
            "char_spacing": float(self.char_spacing),
            "rotation": float(self.rotation),
            "margins": {
                k: coerce_int(self.margins.get(k, 0))
                for k in ("top", "right", "bottom", "left")
            },
            "history_id": self.history_id,
            "original_text": self.original_text or "",
            "translation_style": self.translation_style or "",
            "review_notes": copy.deepcopy(self.review_notes),
            "overrides": copy.deepcopy(self.overrides),
            "gradient_enabled": bool(self.gradient_enabled),
            "gradient_colors": self.gradient_colors,
            "gradient_angle": float(self.gradient_angle or 0.0),
        }

    @classmethod
    def from_payload(cls, data: dict) -> "TypesetArea":
        if not isinstance(data, dict):
            return cls()
        rect = Rect.from_dict(data.get("rect") or {})
        cleanup_rect = (
            Rect.from_dict(data["cleanup_rect"]) if data.get("cleanup_rect") else rect
        )
        polygon = (
            list_to_polygon(data["polygon"])
            if data.get("polygon")
            else polygon_from_rect(rect)
        )
        cleanup_polygon = (
            list_to_polygon(data["cleanup_polygon"])
            if data.get("cleanup_polygon")
            else polygon
        )
        return cls(
            rect=rect,
            text=str(data.get("text") or ""),
            font=_sanitize_font(data.get("font")),
            color=_sanitize_color(data.get("color")),
            polygon=polygon,
            cleanup_rect=cleanup_rect,
            cleanup_polygon=cleanup_polygon,
            orientation=str(data.get("orientation") or "horizontal"),
            effect=str(data.get("effect") or "none"),
            effect_intensity=coerce_float(data.get("effect_intensity")),
            bezier_points=data.get("bezier_points"),
            bubble_enabled=bool(data.get("bubble_enabled")),
            bubble_fill=str(data.get("bubble_fill") or "#ffffff"),
            bubble_outline=str(data.get("bubble_outline") or "#000000"),
            bubble_outline_width=coerce_float(data.get("bubble_outline_width"), 3.0),
            segments=list(data.get("segments") or []),
            text_outline=bool(data.get("text_outline")),
            text_outline_width=coerce_float(data.get("text_outline_width"), 2.0),
            text_outline_color=_sanitize_color(data.get("text_outline_color")),
            text_outline_style=str(data.get("text_outline_style") or "stroke"),
            alignment=str(data.get("alignment") or "center"),
            line_spacing=coerce_float(data.get("line_spacing"), 1.0),
            char_spacing=coerce_float(data.get("char_spacing")),
            rotation=coerce_float(data.get("rotation")),
            margins=dict(
                data.get("margins")
                or {"top": 0, "right": 0, "bottom": 0, "left": 0}
            ),
            history_id=data.get("history_id"),
            original_text=str(data.get("original_text") or ""),
            translation_style=str(data.get("translation_style") or ""),
            review_notes=dict(data.get("review_notes") or {}),
            overrides=dict(data.get("overrides") or {}),
            gradient_enabled=bool(data.get("gradient_enabled")),
            gradient_colors=data.get("gradient_colors"),
            gradient_angle=coerce_float(data.get("gradient_angle")),
        )
