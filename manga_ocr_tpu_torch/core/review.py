"""Scenes + review workflows (history-driven QA passes; the port's own copy
of ``manga_ocr_tpu/core/review.py``).

- **Scenes** — named, ordered groups of history entries that get revised
  together with full conversational context (the reference's
  ``process_scene_with_ai``, ``src/ui/main_window.py:2017-2162``);
  revisions apply back to the typeset areas by history id.
- **Proofread / quality review** — batch passes over (original, translation)
  pairs producing structured suggestions (``_build_review_prompt``
  ``:4728-4766``), recorded as proofreader/quality entries on the project.

The AI calls go through ``TranslationService`` (injected), so everything is
testable offline.
"""

from __future__ import annotations

from typing import Optional, Sequence

from manga_ocr_tpu_torch.core.project import Project


class SceneManager:
    def __init__(self, project: Project):
        self.project = project

    def create_scene(self, name: str, history_ids: Sequence[str]) -> dict:
        scene = {"name": name, "history_ids": list(history_ids)}
        self.project.scenes[name] = scene
        if name not in self.project.scene_order:
            self.project.scene_order.append(name)
        return scene

    def delete_scene(self, name: str) -> None:
        self.project.scenes.pop(name, None)
        if name in self.project.scene_order:
            self.project.scene_order.remove(name)

    def scene_entries(self, name: str) -> list[dict]:
        scene = self.project.scenes.get(name)
        if not scene:
            return []
        by_id = {e["id"]: e for e in self.project.history_entries}
        return [by_id[h] for h in scene.get("history_ids", []) if h in by_id]

    def revise_with_ai(
        self,
        name: str,
        service,
        instruction: str | None = None,
        provider: str = "gemini",
        model: str = "gemini-2.5-flash-lite",
        target_lang: str = "English",
    ) -> list[tuple[str, str | None]]:
        """Run the scene-context revision pass; returns
        [(history_id, revised_text|None)] and updates history entries."""
        entries = self.scene_entries(name)
        if not entries:
            return []
        pairs = [(e["original"], e["translated"]) for e in entries]
        revised = service.review_scene(
            pairs, provider=provider, model=model,
            target_lang=target_lang, instruction=instruction,
        )
        out = []
        for entry, new_text in zip(entries, revised):
            if new_text:
                entry["translated"] = new_text
            out.append((entry["id"], new_text))
        return out

    def apply_to_areas(self, name: str) -> int:
        """Push scene revisions back onto the typeset areas (matched by
        history id); returns the number of areas updated."""
        entries = {e["id"]: e for e in self.scene_entries(name)}
        updated = 0
        for state in self.project.images.values():
            for area in state.areas:
                if area.history_id in entries:
                    area.text = entries[area.history_id]["translated"]
                    updated += 1
        return updated


def run_review_pass(
    project: Project,
    service,
    mode: str = "proofread",
    provider: str = "gemini",
    model: str = "gemini-2.5-flash-lite",
    history_ids: Sequence[str] | None = None,
) -> list[dict]:
    """Batch proofread/QC over history entries; records entries on the
    project (proofreader_entries / quality_entries) and returns them."""
    entries = project.history_entries
    if history_ids is not None:
        wanted = set(history_ids)
        entries = [e for e in entries if e["id"] in wanted]
    if not entries:
        return []
    pairs = [(e["original"], e["translated"]) for e in entries]
    suggestions = service.review_batch(pairs, mode=mode, provider=provider, model=model)
    records = []
    for s in suggestions:
        idx = s.get("index")
        if not isinstance(idx, int) or not (0 <= idx < len(entries)):
            continue
        records.append(
            {
                "history_id": entries[idx]["id"],
                "verdict": s.get("verdict", "ok"),
                "suggestion": s.get("suggestion", ""),
                "mode": mode,
            }
        )
    target = (
        project.proofreader_entries if mode == "proofread" else project.quality_entries
    )
    target.extend(records)
    return records


def apply_review_suggestions(
    project: Project, records: Sequence[dict], only_fix: bool = True
) -> int:
    """Apply accepted review suggestions to history + areas."""
    by_id = {e["id"]: e for e in project.history_entries}
    applied = 0
    for rec in records:
        if only_fix and rec.get("verdict") != "fix":
            continue
        suggestion = rec.get("suggestion")
        hid = rec.get("history_id")
        if not suggestion or hid not in by_id:
            continue
        by_id[hid]["translated"] = suggestion
        for state in project.images.values():
            for area in state.areas:
                if area.history_id == hid:
                    area.text = suggestion
                    applied += 1
    return applied
