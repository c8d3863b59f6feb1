"""Host orchestration of the OCR pipeline (the port's own copy of
``manga_ocr_tpu/runtime/pipeline.py``).

- ``MicroBatcher`` keeps a per-crop calling convention: single ``submit()``
  calls coalesce within a small window (default 10 ms) and run as ONE
  batched call (``engine.ocr_page``), so per-crop callers get page-batch
  throughput.
- ``PagePipeline`` is the batch-first path: detect → crop jobs → one
  ``ocr_page`` call per page (one dispatch per shape bucket) → (optional)
  concurrent translation on host threads → ``TypesetArea`` construction with
  frozen cleanup geometry and per-area overrides (``_create_typeset_area``
  behavior, ``main_window.py:4498-4533``).  ``process_pages`` prepares
  the next two pages (detection and crops) on worker threads while the
  current page's OCR runs.

Translation is HTTP-bound and stays concurrent on host threads; device work
never blocks on the network.
"""

from __future__ import annotations

import dataclasses
import inspect
import queue
import re
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

from manga_ocr_tpu_torch.core.geometry import Rect
from manga_ocr_tpu_torch.typeset.area import TypesetArea


@dataclasses.dataclass
class OcrJob:
    """The crop-job schema (reference: ``main_window.py:6432-6438``)."""

    image_path: str
    rect: Rect
    polygon: np.ndarray
    cropped_image: np.ndarray  # BGR uint8
    settings: dict = dataclasses.field(default_factory=dict)
    pre_text: Optional[str] = None  # pre-detected text skips OCR


@dataclasses.dataclass
class JobResult:
    job: OcrJob
    original_text: str
    translated_text: str
    area: Optional[TypesetArea] = None
    error: Optional[str] = None


class MicroBatcher:
    """Coalesce single-crop OCR calls into batched dispatches.

    ``submit(crop)`` returns a Future; a background thread drains the queue
    every ``window_ms`` (or when ``max_batch`` is reached) and runs one
    batched call for everything collected."""

    def __init__(
        self,
        batch_fn: Callable[[list[np.ndarray]], list[str]],
        window_ms: float = 10.0,
        max_batch: int = 256,
    ):
        self.batch_fn = batch_fn
        self.window_s = window_ms / 1000.0
        self.max_batch = max_batch
        self._queue: "queue.Queue[tuple[np.ndarray, Future]]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, crop: np.ndarray) -> Future:
        fut: Future = Future()
        self._queue.put((crop, fut))
        return fut

    def ocr(self, crop: np.ndarray, timeout: float | None = 600.0) -> str:
        """The default timeout covers a first call that builds the kernels."""
        return self.submit(crop).result(timeout)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            # Adaptive window: a lone request on an idle engine dispatches
            # (almost) immediately — only a sub-ms grace period to catch
            # simultaneous submitters; the full coalescing window applies
            # only under load (more work already queued).
            time.sleep(0.0005)
            if not self._queue.empty():
                end = time.monotonic() + self.window_s
                while len(batch) < self.max_batch:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        batch.append(self._queue.get(timeout=remaining))
                    except queue.Empty:
                        break
            while len(batch) < self.max_batch:  # final non-blocking drain
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            # Drop entries whose caller cancelled while queued (and claim the
            # rest against further cancellation) BEFORE spending device time.
            live = [(c, f) for c, f in batch if f.set_running_or_notify_cancel()]
            if not live:
                continue
            crops = [c for c, _ in live]
            futures = [f for _, f in live]
            try:
                texts = self.batch_fn(crops)
            except Exception as e:
                for fut in futures:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for fut, text in zip(futures, texts):
                # a cancelled/raced future must not poison its batchmates
                if not fut.done():
                    fut.set_result(text)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


def apply_safe_mode(text: str, settings: dict | None = None) -> str:
    """The reference's Safe Mode word filter (``workers.py:249-257``):
    case-insensitive substitution of blocked words in the translated text.
    Applied only when ``settings['safe_mode']`` is on."""
    if not text or not (settings or {}).get("safe_mode"):
        return text
    text = re.sub(r"vagina", "meong", text, flags=re.IGNORECASE)
    text = re.sub(r"penis", "burung", text, flags=re.IGNORECASE)
    return text


def create_typeset_area(
    job: OcrJob, translated: str, original: str, settings: dict | None = None
) -> TypesetArea:
    """Build the output area with frozen cleanup geometry + overrides,
    honoring every typeset key of the reference's job-settings dict
    (``_create_typeset_area``, ``main_window.py:4498-4533``; key names from
    ``get_current_settings`` ``:4886-4973``)."""
    settings = settings or job.settings or {}
    area = TypesetArea(
        rect=job.rect,
        text=translated,
        polygon=np.asarray(job.polygon, np.int32),
        cleanup_rect=job.rect,
        cleanup_polygon=np.asarray(job.polygon, np.int32),
        orientation=settings.get("orientation_mode", "horizontal"),
        effect=settings.get("text_effect", "none"),
        effect_intensity=float(settings.get("effect_intensity", 20.0)),
        bezier_points=settings.get("bezier_points"),
        bubble_enabled=bool(settings.get("create_bubble", False)),
        text_outline=bool(settings.get("text_outline", False)),
        text_outline_width=float(settings.get("outline_width", 2.0)),
        text_outline_color=settings.get("outline_color", "#000000"),
        text_outline_style=settings.get("outline_style", "stroke"),
        alignment=settings.get("alignment", "center"),
        line_spacing=float(settings.get("line_spacing", 1.1)),
        char_spacing=float(settings.get("char_spacing", 100.0)),
        margins=dict(
            settings.get("margins", {"top": 0, "right": 0, "bottom": 0, "left": 0})
        ),
        original_text=original,
        translation_style=settings.get("translation_style", ""),
    )
    area.set_override("use_inpaint", bool(settings.get("use_inpaint", True)))
    area.set_override(
        "use_background_box", bool(settings.get("use_background_box", True))
    )
    if settings.get("font"):
        area.font = dict(settings["font"])
    if settings.get("color"):
        area.color = settings["color"]
    elif settings.get("text_color"):
        area.color = settings["text_color"]
    return area


class PagePipeline:
    """Batch-first page processing: one OCR dispatch per bucket per page,
    concurrent HTTP translation, TypesetArea assembly."""

    def __init__(
        self,
        ocr_page: Callable[[Sequence[np.ndarray]], list[str]],
        translate: Callable[[str, dict], str] | None = None,
        translate_batch: Callable[[list[str], dict], list[str | None]] | None = None,
        dual_pass: Callable[[Sequence[np.ndarray]], list[tuple[str, str]]] | None = None,
        max_http_workers: int = 8,
    ):
        self.ocr_page = ocr_page
        self.translate = translate
        self.translate_batch = translate_batch
        self.dual_pass = dual_pass
        self._pool = ThreadPoolExecutor(max_workers=max_http_workers)

    def process_jobs(
        self,
        jobs: Sequence[OcrJob],
        enhanced: bool | None = None,
        on_result: Callable[[JobResult], None] | None = None,
    ) -> list[JobResult]:
        """Run a page's worth of jobs.  Pre-detected text skips OCR
        (reference rule, ``workers.py:282-284``).  ``enhanced`` defaults to
        the jobs' own ``enhanced_pipeline`` setting (the reference's dual
        pipeline switch, ``workers.py:260-279``)."""
        jobs = list(jobs)
        if enhanced is None:
            enhanced = bool(
                jobs and (jobs[0].settings or {}).get("enhanced_pipeline")
            )
        results: list[Optional[JobResult]] = [None] * len(jobs)

        need_ocr = [i for i, j in enumerate(jobs) if not j.pre_text]
        originals: dict[int, str] = {
            i: j.pre_text for i, j in enumerate(jobs) if j.pre_text
        }
        merged_inputs: dict[int, dict] = {}

        if need_ocr:
            crops = [jobs[i].cropped_image for i in need_ocr]
            if enhanced and self.dual_pass is not None:
                # forward the jobs' settings when the dual-pass callable
                # takes them (the reference merges {**settings, ...} into
                # the second pass — workers.py:399-403); probed via
                # signature, not try/except, so real TypeErrors surface
                try:
                    takes_settings = "settings" in inspect.signature(
                        self.dual_pass
                    ).parameters
                except (TypeError, ValueError):
                    takes_settings = False
                if takes_settings:
                    pairs = self.dual_pass(
                        crops, settings=jobs[need_ocr[0]].settings or {}
                    )
                else:
                    pairs = self.dual_pass(crops)
                for i, (raw, pre) in zip(need_ocr, pairs):
                    # longer text wins as the display original (workers.py:404)
                    originals[i] = raw if len(raw) >= len(pre) else pre
                    merged_inputs[i] = {"manga_ocr": raw, "preprocessed": pre}
            else:
                texts = self.ocr_page(crops)
                for i, text in zip(need_ocr, texts):
                    originals[i] = text

        # Translation (concurrent HTTP; batch API when provided).  OCR
        # sentinel failures ("[ERROR: ...]") are never sent to translators —
        # a wasted network call whose output would be a translation of the
        # error text; they pass through and become JobResult.error below.
        translations: dict[int, str] = {}
        idxs = [
            i
            for i in range(len(jobs))
            if not str(originals.get(i, "")).startswith("[ERROR")
        ]
        if self.translate_batch is not None and not enhanced:
            batch_out = self.translate_batch(
                [originals[i] for i in idxs], jobs[0].settings if jobs else {}
            )
            for i, t in zip(idxs, batch_out):
                if t:
                    translations[i] = t
        missing = [i for i in idxs if i not in translations]
        if self.translate is not None and missing:
            def _do(i):
                settings = dict(jobs[i].settings or {})
                if i in merged_inputs:
                    settings["ocr_results"] = merged_inputs[i]
                    settings["is_enhanced"] = True
                return i, self.translate(originals[i], settings)

            for i, t in self._pool.map(_do, missing):
                translations[i] = t
        for i in range(len(jobs)):
            # no translator / error sentinel: passthrough
            translations.setdefault(i, originals.get(i, ""))

        for i, job in enumerate(jobs):
            original = originals.get(i, "")
            translated = apply_safe_mode(translations.get(i, ""), job.settings)
            error = None
            if isinstance(original, str) and original.startswith("[ERROR"):
                error = original
            area = None if error else create_typeset_area(job, translated, original)
            res = JobResult(job, original, translated, area, error)
            results[i] = res
            if on_result:
                on_result(res)
        return results  # type: ignore[return-value]

    def process_pages(
        self,
        pages: Sequence[tuple[str, np.ndarray]],
        detect: Callable[[np.ndarray], list[dict]],
        settings: dict | None = None,
        enhanced: bool = False,
        on_page: Callable[[str, list[JobResult]], None] | None = None,
    ) -> dict[str, list[JobResult]]:
        """Multi-page pipeline with host/device overlap: page N+1's host-side
        detection + crop extraction runs on a worker thread while page N's
        OCR dispatch is in flight (the reference's AutoDetector → queue →
        worker fan-out collapsed into a two-stage pipeline)."""
        from manga_ocr_tpu_torch.detect.detector import crops_from_detections

        settings = settings or {}

        def prepare(item):
            path, page = item
            detections = detect(page)
            crops, metas = crops_from_detections(page, detections)
            jobs = [
                OcrJob(path, m["rect"], m["polygon"], crop, settings, m["text"])
                for crop, m in zip(crops, metas)
            ]
            return path, jobs

        results: dict[str, list[JobResult]] = {}
        # Two prep workers give a real two-page lookahead (page N+1 and N+2
        # prepare while page N's OCR dispatch is in flight); on error the
        # remaining prepped pages are cancelled, not abandoned.
        prep_pool = ThreadPoolExecutor(max_workers=2)
        futures = [prep_pool.submit(prepare, item) for item in pages]
        try:
            for fut in futures:
                path, jobs = fut.result()
                page_results = self.process_jobs(jobs, enhanced=enhanced)
                results[path] = page_results
                if on_page:
                    on_page(path, page_results)
        finally:
            prep_pool.shutdown(wait=False, cancel_futures=True)
        return results

    def close(self) -> None:
        self._pool.shutdown(wait=False)
