"""Typeset rendering: compose translated text back onto the page (PIL; the
port's own copy of ``manga_ocr_tpu/typeset/render.py``).

The reference's Qt renderer (``draw_single_area``,
``main_window.py:6881-7115``; text layout ``:7311-7551``; bubble ``:7157``;
outline ``:7208-7309``) without Qt:

- cleanup (erase original text) via ``typeset.cleanup``,
- optional bubble ellipse with fill/outline,
- word-wrapped text fitted into the rect (font size auto-shrinks to fit),
- horizontal and vertical (top-to-bottom, right-to-left columns) layout,
- stroke outline and glow, alignment, line/char spacing, rotation
  (rendered to an RGBA layer, rotated, composited -- the reference renders
  horizontal then rotates the pixmap the same way, ``:7507-7511``).

Rendering is a pure function of (page, areas); callers cache composed
pages.  Fonts are looked up in ``manga_ocr_tpu_torch/fonts``, then
``/usr/share/fonts`` (``register_font_dir`` puts a directory first), with
this module's own caches.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
from PIL import Image, ImageDraw, ImageFont

from manga_ocr_tpu_torch.core.geometry import Rect
from manga_ocr_tpu_torch.typeset import cleanup as cl
from manga_ocr_tpu_torch.typeset.area import TypesetArea

_FONT_CACHE: dict = {}
_FONT_DIRS = [
    os.path.join(os.path.dirname(__file__), "..", "fonts"),
    "/usr/share/fonts",
]


def register_font_dir(path: str) -> None:
    if path not in _FONT_DIRS:
        _FONT_DIRS.insert(0, path)
        _FONT_PATH_CACHE.clear()  # new dir may resolve families differently


_FONT_PATH_CACHE: dict = {}


def _find_font_file(family: str) -> str | None:
    # cache family -> path: _fit_font probes many sizes per area and each
    # size miss would otherwise re-walk the whole font tree
    want = family.lower().replace(" ", "")
    if want in _FONT_PATH_CACHE:
        return _FONT_PATH_CACHE[want]
    found = None
    for root in _FONT_DIRS:
        if not os.path.isdir(root):
            continue
        for dirpath, _, files in os.walk(root):
            for f in files:
                if f.lower().endswith((".ttf", ".otf", ".ttc")):
                    stem = os.path.splitext(f)[0].lower().replace(" ", "").replace("-", "")
                    if want in stem:
                        found = os.path.join(dirpath, f)
                        break
            if found:
                break
        if found:
            break
    _FONT_PATH_CACHE[want] = found
    return found


def load_font(font_info: dict) -> ImageFont.FreeTypeFont | ImageFont.ImageFont:
    family = font_info.get("family", "Arial")
    size = int(font_info.get("size", 12))
    key = (family, size)
    if key in _FONT_CACHE:
        return _FONT_CACHE[key]
    path = _find_font_file(family) or _find_font_file("dejavusans")
    try:
        font = (
            ImageFont.truetype(path, size)
            if path
            else ImageFont.load_default(size=size)
        )
    except Exception:
        font = ImageFont.load_default()
    _FONT_CACHE[key] = font
    return font


def _wrap_text(text: str, font, max_width: int, draw: ImageDraw.ImageDraw) -> list[str]:
    """Greedy word wrap; CJK text (no spaces) wraps per character."""
    lines: list[str] = []
    for paragraph in text.split("\n"):
        words = paragraph.split(" ") if " " in paragraph else list(paragraph)
        joiner = " " if " " in paragraph else ""
        cur = ""
        for word in words:
            cand = f"{cur}{joiner}{word}" if cur else word
            if draw.textlength(cand, font=font) <= max_width or not cur:
                cur = cand
            else:
                lines.append(cur)
                cur = word
        lines.append(cur)
    return lines or [""]


def _fit_font(area: TypesetArea, draw, inner_w: int, inner_h: int):
    """Shrink font size until wrapped text fits the rect."""
    info = dict(area.font)
    size = max(6, int(info.get("size", 12)))
    while size >= 6:
        info["size"] = size
        font = load_font(info)
        lines = _wrap_text(area.text, font, inner_w, draw)
        line_h = int(size * 1.2 * area.line_spacing)
        if len(lines) * line_h <= inner_h or size == 6:
            return font, lines, line_h
        size -= 1
    font = load_font(info)
    return font, _wrap_text(area.text, font, inner_w, draw), int(6 * 1.2)


def _hex_to_rgb(color: str) -> tuple[int, int, int]:
    color = color.lstrip("#")
    return tuple(int(color[i : i + 2], 16) for i in (0, 2, 4))  # type: ignore[return-value]


def _gradient_image(w: int, h: int, colors, angle_deg: float) -> Image.Image:
    """Linear gradient across the layer at the given angle."""
    c0 = _hex_to_rgb(colors[0] if colors else "#000000")
    c1 = _hex_to_rgb(colors[1] if colors and len(colors) > 1 else "#ffffff")
    theta = np.deg2rad(angle_deg)
    dx, dy = np.cos(theta), np.sin(theta)
    yy, xx = np.mgrid[0:h, 0:w]
    proj = xx * dx + yy * dy
    lo, hi = proj.min(), proj.max()
    t = (proj - lo) / max(hi - lo, 1e-6)
    grad = np.stack(
        [(c0[i] * (1 - t) + c1[i] * t).astype(np.uint8) for i in range(3)], axis=-1
    )
    return Image.fromarray(grad)


def _apply_gradient(layer: Image.Image, area: TypesetArea) -> Image.Image:
    """Recolor the rendered glyphs with a linear gradient, keeping alpha
    (the reference's QLinearGradient glyph fill, main_window.py:7252-7309)."""
    grad = _gradient_image(
        layer.width, layer.height, area.gradient_colors, area.gradient_angle
    )
    out = Image.new("RGBA", layer.size, (0, 0, 0, 0))
    out.paste(grad, (0, 0), layer.getchannel("A"))
    return out


def _effect_offset(effect: str, frac: float, intensity: float, index: int) -> float:
    """Per-character vertical offset along the line (curved/wavy/jagged —
    the reference's Bézier/sine/alternating paths, main_window.py:7553-7706)."""
    import math

    if effect == "curved":
        # parabola through the line: ends at 0, middle at -intensity
        return -4.0 * intensity * frac * (1.0 - frac)
    if effect == "wavy":
        return intensity * math.sin(frac * 2.0 * math.pi)
    if effect == "jagged":
        return intensity if index % 2 else -intensity
    return 0.0


def _draw_effect_line(area, draw, line, font, x, y, inner_w, stroke):
    """Per-glyph placement with the active effect's vertical displacement."""
    total = max(draw.textlength(line, font=font), 1.0)
    cx = x
    for i, ch in enumerate(line):
        frac = (cx - x) / total
        dy = _effect_offset(area.effect, frac, area.effect_intensity, i)
        draw.text(
            (cx, y + dy),
            ch,
            font=font,
            fill=area.color,
            stroke_width=stroke,
            stroke_fill=area.text_outline_color,
        )
        cx += draw.textlength(ch, font=font) + area.char_spacing
    return cx


def _draw_text_layer(area: TypesetArea, w: int, h: int) -> Image.Image:
    """Render the text (with outline) into a transparent RGBA layer sized to
    the area rect."""
    layer = Image.new("RGBA", (max(w, 1), max(h, 1)), (0, 0, 0, 0))
    draw = ImageDraw.Draw(layer)
    m = area.margins
    inner_w = max(1, w - m.get("left", 0) - m.get("right", 0))
    inner_h = max(1, h - m.get("top", 0) - m.get("bottom", 0))

    if area.orientation == "vertical":
        _draw_vertical(area, draw, layer, inner_w, inner_h, m)
        if area.gradient_enabled:
            layer = _apply_gradient(layer, area)
        return layer

    font, lines, line_h = _fit_font(area, draw, inner_w, inner_h)
    total_h = len(lines) * line_h
    y = m.get("top", 0) + max(0, (inner_h - total_h) // 2)
    stroke = int(round(area.text_outline_width)) if area.text_outline else 0
    for line in lines:
        tw = draw.textlength(line, font=font)
        if area.alignment == "left":
            x = m.get("left", 0)
        elif area.alignment == "right":
            x = m.get("left", 0) + inner_w - tw
        else:
            x = m.get("left", 0) + (inner_w - tw) / 2
        if area.effect != "none" or area.char_spacing > 0:
            _draw_effect_line(area, draw, line, font, x, y, inner_w, stroke)
        else:
            draw.text(
                (x, y),
                line,
                font=font,
                fill=area.color,
                stroke_width=stroke,
                stroke_fill=area.text_outline_color,
            )
        y += line_h
    if area.gradient_enabled:
        layer = _apply_gradient(layer, area)
    return layer


def _draw_vertical(area, draw, layer, inner_w, inner_h, m):
    """Vertical Japanese layout: top-to-bottom characters, columns right-to-
    left."""
    info = dict(area.font)
    size = max(6, int(info.get("size", 12)))
    text = area.text.replace("\n", "")
    stroke = int(round(area.text_outline_width)) if area.text_outline else 0
    while size > 6:
        info["size"] = size
        step = int(size * 1.1 + area.char_spacing)
        per_col = max(1, inner_h // step)
        ncols = -(-len(text) // per_col)
        col_w = int(size * 1.2 * area.line_spacing)
        if ncols * col_w <= inner_w:
            break
        size -= 1
    info["size"] = size
    font = load_font(info)
    step = int(size * 1.1 + area.char_spacing)
    per_col = max(1, inner_h // step)
    ncols = -(-len(text) // per_col) if text else 0
    col_w = int(size * 1.2 * area.line_spacing)
    x0 = m.get("left", 0) + inner_w - col_w  # start at rightmost column
    total_w = ncols * col_w
    x0 -= max(0, (inner_w - total_w) // 2)
    for c in range(ncols):
        chars = text[c * per_col : (c + 1) * per_col]
        col_h = len(chars) * step
        y = m.get("top", 0) + max(0, (inner_h - col_h) // 2)
        x = x0 - c * col_w
        for ch in chars:
            cw = draw.textlength(ch, font=font)
            draw.text(
                (x + (col_w - cw) / 2, y),
                ch,
                font=font,
                fill=area.color,
                stroke_width=stroke,
                stroke_fill=area.text_outline_color,
            )
            y += step


def draw_single_area(
    page_bgr: np.ndarray,
    area: TypesetArea,
    bubble_mask: np.ndarray | None = None,
    do_cleanup: bool = True,
) -> np.ndarray:
    """Compose one area onto a BGR page (cleanup → bubble → text)."""
    out = page_bgr
    if do_cleanup and (area.get_override("use_inpaint", True) or area.get_override("use_background_box", True)):
        out = cl.erase_area(
            out,
            area.cleanup_polygon,
            area.cleanup_rect or area.rect,
            bubble_mask=bubble_mask,
            use_inpaint=bool(area.get_override("use_inpaint", True)),
            use_background_box=bool(area.get_override("use_background_box", True)),
        )
    img = Image.fromarray(out[..., ::-1])  # BGR -> RGB
    r = area.rect.clamped(out.shape[1], out.shape[0])

    if area.bubble_enabled:
        d = ImageDraw.Draw(img)
        d.ellipse(
            [r.left, r.top, r.right, r.bottom],
            fill=area.bubble_fill,
            outline=area.bubble_outline,
            width=max(1, int(area.bubble_outline_width)),
        )

    if area.text:
        layer = _draw_text_layer(area, r.w, r.h)
        if abs(area.rotation) > 0.01:
            layer = layer.rotate(-area.rotation, expand=True, resample=Image.BICUBIC)
        px = r.left + (r.w - layer.width) // 2
        py = r.top + (r.h - layer.height) // 2
        img.paste(layer, (px, py), layer)

    return np.asarray(img)[..., ::-1].copy()  # RGB -> BGR


def render_page(
    page_bgr: np.ndarray,
    areas: Sequence[TypesetArea],
    bubble_masks: Sequence[np.ndarray | None] | None = None,
) -> np.ndarray:
    """Compose all areas of a page (the redraw_all_typeset_areas path)."""
    out = page_bgr.copy()
    for i, area in enumerate(areas):
        mask = bubble_masks[i] if bubble_masks else None
        out = draw_single_area(out, area, bubble_mask=mask)
    return out
