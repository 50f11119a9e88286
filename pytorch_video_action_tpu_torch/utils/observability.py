"""Structured metrics and a device-synchronised throughput meter
(counterpart of ``pytorch_video_action_tpu/utils/observability.py``):

* ``MetricsLogger`` appends JSONL records with the same keys (``event``,
  ``time``; per epoch ``epoch``, ``train_loss``, ``dev_frame_acc``,
  ``dev_segment_acc``, ``lr``, ``wall_s``, ``frames``,
  ``frames_per_sec``).
* ``StepTimer`` synchronises the card before reading the clock, so
  asynchronous launches cannot inflate frames/s.
* ``profile_trace`` (``--profile_dir``) is not ported yet and raises.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Iterator

import torch

__all__ = ["MetricsLogger", "profile_trace", "StepTimer"]


class MetricsLogger:
    """Write structured metric records to a JSONL file, one per line,
    truncating it first; a ``path`` of ``None`` makes every call a no-op.
    Appending to a resumed run's file comes with ``--resume`` (ROADMAP
    item 14)."""

    def __init__(self, path: str | None):
        self.path = path
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(path, "w"):
                pass
            self.log("run_start", resumed=False)

    def log(self, event: str, **fields: Any) -> None:
        if not self.path:
            return
        rec = {"event": event, "time": round(time.time(), 3)}
        rec.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")

    def epoch(self, epoch: int, loss: float, frame_acc: float, seg_acc: float,
              lr: float, wall_s: float, frames: int) -> None:
        self.log("epoch", epoch=epoch, train_loss=round(loss, 6),
                 dev_frame_acc=round(frame_acc, 4),
                 dev_segment_acc=round(seg_acc, 4), lr=lr,
                 wall_s=round(wall_s, 3), frames=frames,
                 frames_per_sec=(round(frames / wall_s, 1) if wall_s > 0
                                 else None))


@contextlib.contextmanager
def profile_trace(profile_dir: str | None) -> Iterator[None]:
    """No-op without a directory; with one it raises: the profiler trace of
    an epoch is not ported yet."""
    if profile_dir:
        raise NotImplementedError(
            "--profile_dir is not ported yet (ROADMAP.md, 'Modules to "
            "port', item 14)")
    yield


class StepTimer:
    """Throughput meter for the train loop: ``note(frames, result)``
    accumulates frames; ``elapsed()`` first waits for the card when the
    last result lies on it."""

    def __init__(self) -> None:
        self.frames = 0
        self._last: Any = None
        self._start = time.perf_counter()

    def note(self, frames: int, result: Any = None) -> None:
        self.frames += int(frames)
        if result is not None:
            self._last = result

    def elapsed(self) -> float:
        if isinstance(self._last, torch.Tensor) and self._last.is_cuda:
            torch.cuda.synchronize(self._last.device)
        return time.perf_counter() - self._start

    def frames_per_sec(self) -> float:
        dt = self.elapsed()
        return self.frames / dt if dt > 0 else 0.0
