"""Profiling hooks: torch.profiler traces and wall-clock scopes (counterpart
of transhuman_tpu/utils/profiling.py).

The reference's tracing is one ``profiler.record_function`` annotation and
smoothed batch timings; the port's console telemetry lives in
utils/recorder.py, the train entry point's traced window and its
device-time summary in train/profile.py.  These helpers cover the rest:
``annotate`` names a range in a trace, ``device_trace`` traces a block and
``Stopwatch`` sums host-clock scopes.

Timing discipline: a card runs asynchronously, so a clock stopped when the
block returns times only the launches.  Both helpers hand the block a
sink: append the block's output to it, and the exit path waits for that
output before it stops the clock or the trace (``torch.cuda.synchronize``
of its card, or one scalar ``.item()`` of a CPU tensor)::

    with sw("render") as sink:
        sink.append(f(x))
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List

import torch


def _first_tensor(obj):
    if torch.is_tensor(obj):
        return obj
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        for x in obj:
            t = _first_tensor(x)
            if t is not None:
                return t
    return None


def _force_readback(sink: List):
    """Wait for the last value the block appended: its card synchronised,
    or one element of a CPU tensor read."""
    if not sink:
        return
    t = _first_tensor(sink[-1])
    if t is None:
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    elif t.numel():
        t.reshape(-1)[0].item()


@contextlib.contextmanager
def device_trace(log_dir: str, name: str = "trace.json"):
    """Trace the enclosed block with torch.profiler (the CPU, and the card
    when there is one) into ``log_dir/name``, a chrome trace.  Yields a
    sink: append the block's outputs so that the trace stops only after
    they are done::

        with device_trace(dir) as sink:
            sink.append(step(state, batch))
    """
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    sink: List = []
    prof.start()
    try:
        yield sink
    finally:
        _force_readback(sink)
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, name))


def annotate(name: str):
    """A named range in a torch.profiler trace."""
    return torch.profiler.record_function(name)


class Stopwatch:
    """Accumulating wall-clock scopes::

        sw = Stopwatch()
        with sw('render') as sink:
            sink.append(f(x))   # waits for f's result before the stop

    Appending the block's output is what makes the measured time the
    compute time; an empty sink times only the launches (fine for host-only
    scopes)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        sink: List = []
        try:
            yield sink
        finally:
            _force_readback(sink)
            self.totals[name] = (self.totals.get(name, 0.0)
                                 + time.perf_counter() - t0)
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> str:
        return "  ".join(f"{k}: {v:.4f}s/{self.counts[k]}"
                         for k, v in sorted(self.totals.items()))
