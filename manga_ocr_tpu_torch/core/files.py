"""File/folder/PDF management: image discovery, robust decode, natural sort
(the port's own copy of ``manga_ocr_tpu/core/files.py``; NumPy, PIL and
cv2 only, the latter two imported where they are used).

Behavioral rebuild of the reference's file layer (SURVEY §2.5 #45):
folder scan with natural ordering (``main_window.py:5349-5413``), robust
image opening with fallbacks for truncated files (``safe_open_image``
``:4248-4284``), and PDF page rasterization behind the reference's
``"path::page::N"`` data-key convention (``:5491-5542``).  PyMuPDF is
optional; when absent, PDF functions raise ``PdfSupportUnavailable``.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".webp", ".bmp", ".gif", ".tif", ".tiff")
PDF_PAGE_KEY_SEP = "::page::"


class PdfSupportUnavailable(RuntimeError):
    pass


def natural_sort_key(name: str):
    """'page2' < 'page10' (the reference natural-sorts export collections)."""
    return [
        int(tok) if tok.isdigit() else tok.lower()
        for tok in re.split(r"(\d+)", name)
    ]


def list_images(folder: str) -> list[str]:
    try:
        names = os.listdir(folder)
    except OSError:
        return []
    files = [
        os.path.join(folder, n)
        for n in sorted(names, key=natural_sort_key)
        if n.lower().endswith(IMAGE_EXTENSIONS)
    ]
    return files


def safe_open_image(path: str) -> Optional[np.ndarray]:
    """Robust BGR uint8 decode: PIL with truncated-file tolerance, then cv2.
    Returns None only when every decoder fails (the reference's ladder)."""
    try:
        from PIL import Image, ImageFile

        ImageFile.LOAD_TRUNCATED_IMAGES = True
        with Image.open(path) as img:
            rgb = np.asarray(img.convert("RGB"))
        return rgb[..., ::-1].copy()
    except Exception:
        pass
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is not None:
            return img
    except Exception:
        pass
    return None


def save_image(
    path: str, image_bgr: np.ndarray, fmt: str = "PNG", quality: int = 95
) -> None:
    """Save honoring the settings contract (save_format / save_quality)."""
    from PIL import Image

    img = Image.fromarray(image_bgr[..., ::-1])
    fmt = fmt.upper()
    kwargs = {}
    if fmt in ("JPG", "JPEG"):
        fmt = "JPEG"
        kwargs["quality"] = quality
    elif fmt == "WEBP":
        kwargs["quality"] = quality
    img.save(path, format=fmt, **kwargs)


# -- PDF ------------------------------------------------------------------------


def pdf_page_key(path: str, page: int) -> str:
    return f"{path}{PDF_PAGE_KEY_SEP}{page}"


def parse_pdf_page_key(key: str) -> tuple[str, int] | None:
    if PDF_PAGE_KEY_SEP not in key:
        return None
    path, _, page = key.rpartition(PDF_PAGE_KEY_SEP)
    try:
        return path, int(page)
    except ValueError:
        return None


def _require_fitz():
    try:
        import fitz  # PyMuPDF

        return fitz
    except ImportError as e:
        raise PdfSupportUnavailable(
            "PDF support requires PyMuPDF (pip install pymupdf)"
        ) from e


def pdf_page_count(path: str) -> int:
    fitz = _require_fitz()
    with fitz.open(path) as doc:
        return doc.page_count


def rasterize_pdf_page(path: str, page: int, dpi: int = 150) -> np.ndarray:
    """One PDF page -> BGR uint8 at the reference's default 150 DPI."""
    fitz = _require_fitz()
    with fitz.open(path) as doc:
        pg = doc.load_page(page)
        pix = pg.get_pixmap(dpi=dpi)
        arr = np.frombuffer(pix.samples, np.uint8).reshape(pix.height, pix.width, pix.n)
    if arr.shape[-1] == 4:
        arr = arr[..., :3]
    return arr[..., ::-1].copy()  # RGB -> BGR


def export_images_to_pdf(image_paths: list[str], out_path: str) -> None:
    """Collect typeset images into a single PDF, natural-sorted (the
    reference's export, ``main_window.py:8605-8659``).  Uses PIL (always
    available) rather than PyMuPDF."""
    from PIL import Image

    ordered = sorted(image_paths, key=lambda p: natural_sort_key(os.path.basename(p)))
    pages = []
    for p in ordered:
        img = safe_open_image(p)
        if img is not None:
            pages.append(Image.fromarray(img[..., ::-1]))
    if not pages:
        raise ValueError("no readable images to export")
    pages[0].save(out_path, save_all=True, append_images=pages[1:], format="PDF")
