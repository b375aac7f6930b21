"""Device-time summary of a torch.profiler trace of train steps.

The train entry point traces a steady-state window of steps when
``profile_dir`` is set (as the JAX package's CLI does), writes the chrome
trace there and this summary beside it.  From the trace's device events
(kernels, memcpy, memset) it reports:

* ``busy_ms``: the union of the intervals of those launched inside a step,
  so overlapping or nested ranges count once, and the device's idle share
  of the step functions' host time;
* ``event_sum_ms``: the plain sum of their durations, above ``busy_ms``
  only where device work overlaps;
* ``phases``: the busy time of each phase of the step (the
  ``train_step.*`` ranges of ``train/step.py``).  A device event belongs to
  the phase whose host range holds its launch, matched by correlation id;
  the backward's launches come from autograd's device thread while the main
  thread sits inside its backward range;
* ``groups``: the summed durations per kernel group (name patterns, first
  match wins), K2 and K3 among them.
"""

from __future__ import annotations

import gzip
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
PHASES = ("train_step.forward", "train_step.backward", "train_step.optimizer")
# (group, substrings of the lower-cased kernel name); first match wins
GROUPS = (
    ("K3 dfeat_scatter", ("dfeat_scatter",)),
    ("K2 dparf", ("dparf_kernel",)),
    ("K1 min_excess2", ("min_excess2",)),
    ("sort", ("radixsort", "sort")),
    ("convolution (cuDNN)", ("conv", "cudnn", "fprop", "dgrad", "wgrad",
                             "winograd")),
    ("GEMM", ("gemm", "gemv", "cutlass")),
    ("gather / index", ("index",)),
    ("upsample", ("upsample",)),
)


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _group(name: str, cat: str) -> str:
    if cat != "kernel":
        return "memcpy / memset"
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "elementwise, reductions, other"


def summarize_trace(trace: dict, wall_ms: float, steps: int,
                    phases=PHASES) -> dict:
    """The summary of a trace of ``steps`` steps whose step functions took
    ``wall_ms`` of host time in all; every time is in ms per step.  Device
    events launched outside the step (the sample's copy to the card) are
    left out of the busy time and reported as ``outside_ms``.  ``phases``
    names the host ranges that make up a step (``tools/profile_render.py``
    passes its own)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation" and e["name"] in phases]
    per_phase = {p: [] for p in phases}
    groups: dict = {}
    inside, outside = [], 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t = launch_ts.get(e.get("args", {}).get("correlation"))
        phase = next((name for a, b, name in ranges
                      if t is not None and a <= t <= b), None)
        if phase is None:
            outside += e["dur"]
            continue
        span = (e["ts"], e["ts"] + e["dur"])
        per_phase[phase].append(span)
        inside.append(span)
        g = _group(e["name"], e["cat"])
        groups[g] = groups.get(g, 0.0) + e["dur"]
    busy = _union_us(inside) / 1e3
    per = max(steps, 1)
    return {
        "steps": steps,
        "wall_ms": wall_ms / per,
        "device_events": len(inside) / per,
        "busy_ms": busy / per,
        "event_sum_ms": sum(b - a for a, b in inside) / 1e3 / per,
        "outside_ms": outside / 1e3 / per,
        "idle_share": 1.0 - busy / wall_ms if wall_ms > 0 else None,
        "phases": {p.split(".", 1)[1]: _union_us(v) / 1e3 / per
                   for p, v in per_phase.items()},
        "groups": {g: t / 1e3 / per for g, t in
                   sorted(groups.items(), key=lambda kv: -kv[1])},
    }


def format_summary(s: dict) -> str:
    idle = "n/a" if s["idle_share"] is None else f"{s['idle_share']:.4f}"
    lines = [
        f"profiled {s['steps']} steps, per step: wall {s['wall_ms']:.3f} ms, "
        f"device busy {s['busy_ms']:.3f} ms (sum of events "
        f"{s['event_sum_ms']:.3f} ms, {s['device_events']:.0f} events), "
        f"idle share {idle}; device ms outside the step "
        f"{s['outside_ms']:.3f}",
        "  busy ms per phase: " + ", ".join(
            f"{p} {t:.3f}" for p, t in s["phases"].items()),
    ]
    busy = s["event_sum_ms"] or 1.0
    lines += [f"  {t:9.3f} ms  {100 * t / busy:5.1f}%  {g}"
              for g, t in s["groups"].items()]
    return "\n".join(lines)
