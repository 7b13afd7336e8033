"""Sweep progress journal: crash-safe resume for long val-set sweeps (port
of ``saliency/journal.py``, byte for byte the same JSONL).

The reference's saliency scripts lose everything on interruption. A val-set
sweep can run for hours (50k images), so each image's terminal outcome
appends to a JSONL journal the moment it finalizes, and a re-run with
``resume=True`` restores finished work and re-explains only the rest.

Journal lines are the sweep's own event dicts:

* ``image_done``: the full per-image result row (terminal),
* ``skip_misclassified``: terminal (the decision is deterministic),
* ``image_failed`` / ``batch_failed``: recorded for observability but not
  terminal: failed images retry on resume.

Heatmaps (when the sweep runs with ``keep_heatmaps=True``, for the GP
surrogate passes) persist per image as ``<journal>.heatmaps/<index>.npy`` so
a resumed sweep still stacks the complete set.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np


class SweepJournal:
    """Append-only per-image outcome journal with resume restore."""

    def __init__(self, path: str, resume: bool = False,
                 keep_heatmaps: bool = False, config: Optional[dict] = None,
                 ) -> None:
        """``config``: run-settings fingerprint (mask counts, segmenter,
        seed, mode, ...). Stamped as the journal's first line on a fresh
        run; a resume whose config differs from the stamped one REFUSES —
        mixing rows produced under different settings would silently
        average incomparable quantities."""
        self.path = path
        self.keep_heatmaps = keep_heatmaps
        self.heat_dir = path + ".heatmaps"
        self.done: set = set()
        self.restored_rows: list = []   # image_done rows, journal order
        self.restored_skips: int = 0
        self._stamped_config: Optional[dict] = None
        if resume and os.path.exists(path):
            self._load()
            if (config is not None and self._stamped_config is not None
                    and self._stamped_config != config):
                raise ValueError(
                    "journal config mismatch — this journal was written "
                    f"under {self._stamped_config}, resume requested "
                    f"{config}; restored rows would be incomparable. "
                    "Start fresh (drop --resume) or match the settings."
                )
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        if keep_heatmaps:
            os.makedirs(self.heat_dir, exist_ok=True)
        # Fresh run truncates; resume appends after what was restored.
        resuming = resume and bool(self.done)
        self._f = open(path, "a" if resuming else "w")
        if resuming:
            # A crash mid-write can leave a torn tail with no newline; the
            # next record would concatenate onto it and BOTH lines would be
            # lost to the following resume's JSON parse. A leading newline
            # isolates the fragment (blank/torn lines are skipped on load).
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                if f.tell() > 0:
                    f.seek(-1, os.SEEK_END)
                    torn = f.read(1) != b"\n"
            if torn:
                self._f.write("\n")
        elif config is not None:
            self.record({"event": "config", "config": config})

    def _load(self) -> None:
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail line from a crash mid-write
                kind = ev.get("event")
                if kind == "config":
                    self._stamped_config = ev.get("config")
                elif kind == "image_done" and "index" in ev:
                    idx = int(ev["index"])
                    if idx not in self.done:
                        self.done.add(idx)
                        self.restored_rows.append(
                            {k: v for k, v in ev.items() if k != "event"}
                        )
                elif kind == "skip_misclassified" and "index" in ev:
                    idx = int(ev["index"])
                    if idx not in self.done:
                        self.done.add(idx)
                        self.restored_skips += 1
                # failed/batch_failed: not terminal — those indices retry.

    def record(self, event: dict) -> None:
        """Append one event line (called from the sweep's emit stream).
        ``default=str`` matches PhaseLogger.emit — a stray non-native value
        must not raise out of finish_image after counters were updated
        (the image would count both explained and failed)."""
        self._f.write(json.dumps(event, default=str) + "\n")
        self._f.flush()

    def save_heatmap(self, index: int, heat) -> None:
        if not self.keep_heatmaps:
            return
        # Atomic rename so resume never loads a torn .npy (np.save appends
        # ".npy" unless the name already ends with it, hence the tmp suffix).
        tmp = os.path.join(self.heat_dir, f".tmp.{int(index)}.npy")
        np.save(tmp, np.asarray(heat, np.float32))
        os.replace(tmp, os.path.join(self.heat_dir, f"{int(index)}.npy"))

    def load_heatmap(self, index: int) -> Optional[np.ndarray]:
        p = os.path.join(self.heat_dir, f"{int(index)}.npy")
        if os.path.exists(p):
            return np.load(p)
        return None

    def close(self) -> None:
        self._f.close()

    # -- restore -----------------------------------------------------------

    def restore_into(self, res, iou_m, surv_m, latencies,
                     keep_heatmaps: bool) -> None:
        """Seed a fresh SweepResult (and its meters) with journaled work.

        Restored rows keep their original ``seconds`` (valid per-image
        spans, pooled into p50); ``evals_per_sec`` intentionally reflects
        only THIS run's new work over this run's wall clock.
        """
        if keep_heatmaps and not self.keep_heatmaps:
            raise ValueError(
                "sweep runs with keep_heatmaps=True but the journal was "
                "created with keep_heatmaps=False — restored images would "
                "silently miss their heatmaps (build the journal with "
                "keep_heatmaps=True)"
            )
        for row in self.restored_rows:
            res.images_total += 1
            res.images_explained += 1
            res.per_image.append(row)
            if "survival" in row:
                surv_m.update(float(row["survival"]))
            if "iou" in row:
                iou_m.update(float(row["iou"]))
            if "seconds" in row:
                latencies.append(float(row["seconds"]))
            if keep_heatmaps:
                heat = self.load_heatmap(int(row["index"]))
                if heat is not None:
                    res.heatmaps[int(row["index"])] = heat
        res.images_total += self.restored_skips
        res.images_skipped_misclassified += self.restored_skips


class JournalingLogger:
    """PhaseLogger wrapper that tees terminal sweep events to a journal.

    Every per-image outcome in the sweeps already flows through
    ``logger.emit`` with an ``event`` key, so wrapping the logger journals
    all dispatch paths (streaming / batched / BO / attribution) without
    touching each site.
    """

    _RECORDED = ("image_done", "skip_misclassified",
                 "image_failed", "batch_failed")

    def __init__(self, inner, journal: SweepJournal) -> None:
        self._inner = inner
        self._journal = journal

    def emit(self, payload: dict) -> None:
        self._inner.emit(payload)
        if payload.get("event") in self._RECORDED:
            self._journal.record(payload)

    def phase(self, *args, **kwargs):
        return self._inner.phase(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._inner, name)
