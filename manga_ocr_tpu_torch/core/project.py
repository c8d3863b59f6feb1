"""Project persistence: schema-versioned JSON with atomic writes (the
port's own copy of ``manga_ocr_tpu/core/project.py``: a project file
written by either package loads in the other).

The reference's project layer: ``schema_version: 2`` payloads
(``_build_project_payload``, ``main_window.py:7957-7983``), atomic
tmp+replace writes (``ProjectSaveWorker``, ``workers.py:120-154``), tolerant
readers with legacy migration (``:7986-8027``), per-image undo/redo stacks,
history entries, scenes, and autosave.  Pickle fallback is intentionally NOT
supported on read (unsafe deserialization); legacy pickle projects must be
converted by the original tool first -- a deliberate behavioral difference
from the reference, as in the JAX package.
"""

from __future__ import annotations

import copy
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from manga_ocr_tpu_torch.typeset.area import TypesetArea

SCHEMA_VERSION = 2
APP_VERSION = "0.1.0"


@dataclass
class ImageState:
    """Per-image typeset state incl. undo/redo stacks."""

    areas: list = field(default_factory=list)  # list[TypesetArea]
    undo_stack: list = field(default_factory=list)  # list[list[payload]]
    redo_stack: list = field(default_factory=list)

    def snapshot(self) -> list[dict]:
        return [a.to_payload() for a in self.areas]

    def push_undo(self, limit: int = 50) -> None:
        self.undo_stack.append(self.snapshot())
        del self.undo_stack[:-limit]
        self.redo_stack.clear()

    def undo(self) -> bool:
        if not self.undo_stack:
            return False
        self.redo_stack.append(self.snapshot())
        self.areas = [TypesetArea.from_payload(p) for p in self.undo_stack.pop()]
        return True

    def redo(self) -> bool:
        if not self.redo_stack:
            return False
        self.undo_stack.append(self.snapshot())
        self.areas = [TypesetArea.from_payload(p) for p in self.redo_stack.pop()]
        return True


@dataclass
class Project:
    project_dir: Optional[str] = None
    current_image_path: Optional[str] = None
    current_pdf_page: int = -1
    images: dict = field(default_factory=dict)  # path -> ImageState
    history_entries: list = field(default_factory=list)
    proofreader_entries: list = field(default_factory=list)
    quality_entries: list = field(default_factory=list)
    history_counter: int = 0
    typeset_defaults: dict = field(default_factory=dict)
    settings: dict = field(default_factory=dict)
    scenes: dict = field(default_factory=dict)
    scene_order: list = field(default_factory=list)
    current_scene_name: Optional[str] = None
    config: dict = field(default_factory=dict)

    # -- state management -------------------------------------------------------

    def image_state(self, path: str) -> ImageState:
        return self.images.setdefault(path, ImageState())

    def add_area(self, path: str, area: TypesetArea, push_undo: bool = True) -> None:
        state = self.image_state(path)
        if push_undo:
            state.push_undo()
        state.areas.append(area)

    def register_history_entry(self, path: str, area: TypesetArea, original: str, translated: str) -> dict:
        """History record per area (``register_history_entry`` behavior,
        ``main_window.py:4540-4593``)."""
        self.history_counter += 1
        hid = f"h{self.history_counter}"
        area.history_id = hid
        entry = {
            "id": hid,
            "image_path": path,
            "original": original,
            "translated": translated,
            "rect": area.rect.to_dict(),
            "timestamp": time.time(),
        }
        self.history_entries.append(entry)
        return entry

    # -- serialization ------------------------------------------------------------

    def to_payload(self) -> dict:
        return {
            "schema_version": SCHEMA_VERSION,
            "project_dir": os.path.abspath(self.project_dir) if self.project_dir else None,
            "current_image_path": self.current_image_path,
            "current_pdf_page": int(self.current_pdf_page),
            "typeset_data": {
                path: {
                    "areas": state.snapshot(),
                    "undo_stack": copy.deepcopy(state.undo_stack),
                    "redo_stack": copy.deepcopy(state.redo_stack),
                }
                for path, state in self.images.items()
            },
            "history_entries": copy.deepcopy(self.history_entries),
            "proofreader_entries": copy.deepcopy(self.proofreader_entries),
            "quality_entries": copy.deepcopy(self.quality_entries),
            "history_counter": int(self.history_counter),
            "typeset_defaults": copy.deepcopy(self.typeset_defaults),
            "settings": copy.deepcopy(self.settings),
            "scenes": copy.deepcopy(self.scenes),
            "scene_order": list(self.scene_order),
            "current_scene_name": self.current_scene_name,
            "saved_at": time.time(),
            "app_version": APP_VERSION,
            "config": copy.deepcopy(self.config),
        }

    @classmethod
    def from_payload(cls, data: dict) -> "Project":
        if not isinstance(data, dict):
            return cls()
        data = migrate_legacy(data)
        proj = cls(
            project_dir=data.get("project_dir"),
            current_image_path=data.get("current_image_path"),
            # NB: page 0 is valid — a plain `or -1` would coerce it to the
            # "no PDF page" sentinel
            current_pdf_page=(
                int(data["current_pdf_page"])
                if data.get("current_pdf_page") is not None
                else -1
            ),
            history_entries=list(data.get("history_entries") or []),
            proofreader_entries=list(data.get("proofreader_entries") or []),
            quality_entries=list(data.get("quality_entries") or []),
            history_counter=int(data.get("history_counter", 0) or 0),
            typeset_defaults=dict(data.get("typeset_defaults") or {}),
            settings=dict(data.get("settings") or {}),
            scenes=dict(data.get("scenes") or {}),
            scene_order=list(data.get("scene_order") or []),
            current_scene_name=data.get("current_scene_name"),
            config=dict(data.get("config") or {}),
        )
        for path, block in (data.get("typeset_data") or {}).items():
            if isinstance(block, list):  # legacy: bare list of areas
                block = {"areas": block}
            state = ImageState(
                areas=[TypesetArea.from_payload(p) for p in block.get("areas") or []],
                undo_stack=list(block.get("undo_stack") or []),
                redo_stack=list(block.get("redo_stack") or []),
            )
            proj.images[path] = state
        return proj


def migrate_legacy(data: dict) -> dict:
    """Upgrade schema_version < 2 payloads in place (mirrors
    ``_migrate_legacy_project`` tolerance: missing blocks become empty)."""
    version = data.get("schema_version", 1)
    if version >= SCHEMA_VERSION:
        return data
    out = dict(data)
    out.setdefault("typeset_data", out.pop("areas_by_image", {}) or {})
    out.setdefault("history_entries", [])
    out["schema_version"] = SCHEMA_VERSION
    return out


# -- file IO ---------------------------------------------------------------------


def save_project(project: Project, path: str) -> None:
    """Atomic JSON write (tmp + os.replace)."""
    payload = project.to_payload()
    tmp = f"{path}.tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(payload, f, ensure_ascii=False)
    os.replace(tmp, path)


def load_project(path: str) -> Project:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return Project.from_payload(data)


class AutoSaver:
    """Background autosave (the reference's QTimer, ``main_window.py:501-511``):
    interval from settings (floor 5 s), thread-based, stop()-able."""

    def __init__(self, get_project, path: str, interval_ms: int = 300_000):
        self.get_project = get_project
        self.path = path
        self.interval_s = max(5.0, interval_ms / 1000.0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                save_project(self.get_project(), self.path)
            except Exception:
                pass  # autosave must never crash the app

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None
