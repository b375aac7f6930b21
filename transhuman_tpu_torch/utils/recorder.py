"""Training telemetry: smoothed scalars, the console progress line and the
metrics streams (the port's copy of transhuman_tpu/utils/recorder.py; the
reference's ``lib/train/recorder.py`` and trainer console line).

Window-median scalars are recorded every ``record_interval`` steps into
``metrics.jsonl`` and TensorBoard event files (``utils/tb_writer.py``,
written without a tensorboard package) under the record directory; the
console line (eta, scalars, data and batch time, lr, device memory) prints
every ``log_interval`` steps; ``state_dict`` rides in each checkpoint.  The
device memory is ``torch.cuda.memory_allocated`` (0 without a card).
"""

from __future__ import annotations

import collections
import datetime
import json
import os
from typing import Dict, Optional

import numpy as np


class SmoothedValue:
    """Median/mean over a sliding window (recorder.py:9-36)."""

    def __init__(self, window_size: int = 20):
        self.deque = collections.deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0

    def update(self, value: float):
        v = float(value)
        self.deque.append(v)
        self.total += v
        self.count += 1

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)


class Recorder:
    def __init__(self, record_dir: Optional[str] = None,
                 record_interval: int = 20, log_interval: int = 1,
                 enabled: bool = True):
        self.record_dir = record_dir
        self.record_interval = record_interval
        self.log_interval = log_interval
        self.enabled = enabled
        self.step = 0
        self.epoch = 0
        self.scalars: Dict[str, SmoothedValue] = collections.defaultdict(
            SmoothedValue)
        self.batch_time = SmoothedValue()
        self.data_time = SmoothedValue()
        self._fh = None
        self._tb = None
        if enabled and record_dir:
            os.makedirs(record_dir, exist_ok=True)
            self._fh = open(os.path.join(record_dir, "metrics.jsonl"), "a")
            from .tb_writer import TBWriter

            self._tb = TBWriter(record_dir)

    def update(self, stats: Dict[str, float]):
        for k, v in stats.items():
            self.scalars[k].update(float(v))

    def record(self, prefix: str = "train", extra: Optional[dict] = None,
               force: bool = False):
        """force=True bypasses the record_interval gate (the reference's
        'val' records are unconditional, trainer.py:153-155)."""
        if not self._fh or (not force and self.step % self.record_interval):
            return
        row = {"step": self.step, "epoch": self.epoch, "prefix": prefix,
               **{k: v.median for k, v in self.scalars.items()}}
        if extra:
            row.update(extra)
        row = {k: (v.item() if hasattr(v, "item") else v)
               for k, v in row.items()}
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()
        if self._tb:
            scalars = {f"{prefix}/{k}": v for k, v in row.items()
                       if k not in ("step", "epoch", "prefix")
                       and isinstance(v, (int, float))}
            self._tb.add_scalars(scalars, self.step)
            self._tb.flush()

    def record_image(self, tag: str, image, prefix: str = "train"):
        """Image stream (reference recorder.py:89-100 add_image path)."""
        if self._tb:
            self._tb.add_image(f"{prefix}/{tag}", image, self.step)

    @staticmethod
    def _device_mem_mb() -> float:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return 0.0
        return torch.cuda.memory_allocated() / 2**20

    def console_line(self, max_iter: int, lr: float) -> str:
        eta_s = self.batch_time.global_avg * (max_iter - self.step)
        eta = str(datetime.timedelta(seconds=int(eta_s)))
        parts = [f"eta: {eta}"]
        parts += [f"{k}: {v.median:.4f}" for k, v in self.scalars.items()]
        parts += [f"data: {self.data_time.median:.4f}",
                  f"batch: {self.batch_time.median:.4f}",
                  f"lr: {lr:.6f}",
                  f"mem: {self._device_mem_mb():.0f}MB"]
        return "  ".join(parts)

    def state_dict(self) -> dict:
        return {"step": self.step, "epoch": self.epoch}

    def load_state_dict(self, d: dict):
        self.step = d.get("step", 0)
        self.epoch = d.get("epoch", 0)

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._tb:
            self._tb.close()
            self._tb = None
