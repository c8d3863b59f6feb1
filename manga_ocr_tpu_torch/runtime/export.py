"""Export pipeline: batch re-render + save of typeset pages (the port's own
copy of ``manga_ocr_tpu/runtime/export.py``, on the port's
``core/files.py``).

The reference's batch save (``BatchSaveWorker``, ``workers.py:651-719``):
for every page with typeset areas, re-render a fresh composition and write
``<name>_typeset.<ext>``; plus single-image save and PDF collection.  Runs
on a thread pool (the reference uses one QThread; rendering pages is
embarrassingly parallel on the host)."""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

from manga_ocr_tpu_torch.core import files as fio
from manga_ocr_tpu_torch.core.project import Project
from manga_ocr_tpu_torch.typeset.render import render_page


def typeset_output_path(image_path: str, fmt: str) -> str:
    stem, _ = os.path.splitext(image_path)
    return f"{stem}_typeset.{fmt.lower()}"


def save_single(
    image_path: str,
    project: Project,
    fmt: str = "PNG",
    quality: int = 95,
    out_path: str | None = None,
) -> str:
    page = fio.safe_open_image(image_path)
    if page is None:
        raise FileNotFoundError(image_path)
    areas = project.image_state(image_path).areas
    composed = render_page(page, areas)
    out = out_path or typeset_output_path(image_path, fmt)
    fio.save_image(out, composed, fmt, quality)
    return out


def batch_save(
    project: Project,
    fmt: str = "PNG",
    quality: int = 95,
    progress: Callable[[int, int, str], None] | None = None,
    max_workers: int = 4,
) -> list[str]:
    """Render + save every page that has areas; returns written paths."""
    targets = [path for path, st in project.images.items() if st.areas]
    written: list[str] = []

    def _one(path: str) -> str | None:
        try:
            return save_single(path, project, fmt, quality)
        except Exception:
            return None

    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        for i, out in enumerate(pool.map(_one, targets)):
            if out:
                written.append(out)
            if progress:
                progress(i + 1, len(targets), targets[i])
    return written


def export_pdf(project: Project, out_path: str, fmt: str = "PNG") -> str:
    """Collect the project's *_typeset images into one PDF (writes any that
    are missing first)."""
    paths = batch_save(project, fmt=fmt)
    if not paths:
        raise ValueError("project has no typeset pages to export")
    fio.export_images_to_pdf(paths, out_path)
    return out_path
