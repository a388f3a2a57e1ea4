"""Session metrics: JSONL trace + Table-1-style throughput summary (a
copy of ``repro/train_loop/metrics.py``: the same records).

One line per event, ``kind`` discriminated:

    {"kind": "train", "step": 7, "loss": 4.31, "lr": 0.01,
     "step_time_ms": 12.4, "images_per_sec": 2580.6}
    {"kind": "eval", "step": 10, "loss": 4.1, "top1_err": 0.87,
     "lr_dropped": false}
    {"kind": "summary", "steps": 100, "images_per_sec": 2612.0,
     "step_ms_p50": 12.2, "step_ms_p90": 13.0, "step_ms_p99": 19.8, ...}

``images_per_sec`` is the paper's Table 1 unit.  The trace is the
session's single source of truth: tests diff resumed-vs-uninterrupted
``train`` lines bit-exactly.

On resume, entries past the restored step are dropped (they came from the
killed run's un-checkpointed tail) and the file continues in place, so one
session — however many restarts — yields one coherent trace.  Under
loss scaling (the bf16 numerics preset) each ``train`` line and the
summary carry ``loss_scale`` and the cumulative ``skipped_steps``.
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile (q in [0,100]) of an ascending list:
    the smallest value with at least q% of the sample at or below it."""
    if not sorted_vals:
        return float("nan")
    i = min(len(sorted_vals) - 1,
            max(0, math.ceil(q / 100 * len(sorted_vals)) - 1))
    return sorted_vals[i]


def read_jsonl(path: str, kind: str = None, *,
               tolerant: bool = False) -> list:
    """Parse a metrics file; optionally filter to one ``kind``.

    ``tolerant`` skips unparseable lines — a run SIGKILLed mid-write
    leaves a torn final line, and the resume path must shrug it off (the
    torn record is part of the un-checkpointed tail it drops anyway).
    """
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                if tolerant:
                    continue
                raise
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out


class MetricsWriter:
    """Append-only JSONL writer with throughput bookkeeping."""

    def __init__(self, path: Optional[str], *, images_per_step: int = 0,
                 resume_step: int = None):
        self._path = path
        self._f = None
        self._images = images_per_step
        self._times_ms: list = []
        self._stage_ms: list = []
        self._last_scale: Optional[float] = None
        self._last_skipped: Optional[int] = None
        if path is None:
            return
        if resume_step is not None and os.path.exists(path):
            # drop the killed run's tail beyond the checkpoint we resumed
            # (tolerant: a SIGKILL mid-write leaves a torn final line)
            kept = [r for r in read_jsonl(path, tolerant=True)
                    if r.get("step", 0) <= resume_step
                    and r.get("kind") != "summary"]
            with open(path, "w") as f:
                for r in kept:
                    f.write(json.dumps(r) + "\n")
            self._f = open(path, "a")
        else:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "w")

    def _write(self, rec: dict):
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()

    def train(self, step: int, loss: float, lr: float, step_time_s: float,
              *, timed: bool = True, stage_wait_ms: Optional[float] = None,
              loss_scale: Optional[float] = None,
              skipped_steps: Optional[int] = None):
        """``timed=False`` marks a warm-up step (the first of a run, which
        builds the kernels and warms the allocator): logged, but excluded
        from the throughput percentiles (it would dominate p99).
        ``stage_wait_ms`` is how long the trainer was blocked waiting for
        this step's batch to be staged (loader stall — observable loading
        overlap, not inferred).  ``loss_scale``/``skipped_steps`` trace the
        loss-scaling state (written only when scaling is on): the current
        scale and the cumulative non-finite-skip count."""
        ms = step_time_s * 1e3
        if timed:
            self._times_ms.append(ms)
        rec = {"kind": "train", "step": step, "loss": loss, "lr": lr,
               "step_time_ms": round(ms, 3)}
        if stage_wait_ms is not None:
            rec["stage_wait_ms"] = round(stage_wait_ms, 3)
            if timed:
                self._stage_ms.append(stage_wait_ms)
        if loss_scale is not None:
            rec["loss_scale"] = loss_scale
            self._last_scale = loss_scale
        if skipped_steps is not None:
            rec["skipped_steps"] = skipped_steps
            self._last_skipped = skipped_steps
        if not timed:
            rec["compile"] = True
        if self._images and timed and step_time_s > 0:
            rec["images_per_sec"] = round(self._images / step_time_s, 1)
        self._write(rec)

    def eval(self, step: int, metrics: dict, lr_dropped: bool):
        self._write({"kind": "eval", "step": step, **metrics,
                     "lr_dropped": lr_dropped})

    def summary(self, steps: int) -> dict:
        """Table-1-format rollup over this process's timed steps (excludes
        the warm-up step — callers time steady-state only)."""
        ts = sorted(self._times_ms)
        total_s = sum(ts) / 1e3
        out = {"kind": "summary", "steps": steps,
               "timed_steps": len(ts),
               "step_ms_p50": round(percentile(ts, 50), 3),
               "step_ms_p90": round(percentile(ts, 90), 3),
               "step_ms_p99": round(percentile(ts, 99), 3)}
        if self._stage_ms:
            out["stage_wait_ms_mean"] = round(
                sum(self._stage_ms) / len(self._stage_ms), 3)
            out["stage_wait_ms_p90"] = round(
                percentile(sorted(self._stage_ms), 90), 3)
        if self._images and total_s > 0:
            out["images_per_sec"] = round(len(ts) * self._images / total_s, 1)
        if self._last_scale is not None:
            out["loss_scale"] = self._last_scale
        if self._last_skipped is not None:
            out["skipped_steps"] = self._last_skipped
        self._write(out)
        return out

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
