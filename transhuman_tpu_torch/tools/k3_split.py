"""Where K3's time goes: its wrapper's parts, and its share of a train step.

    python -m transhuman_tpu_torch.tools.k3_split [--parent DIR] [--json OUT]
        [--skip-train]

Two measurements of K3 (the d_feat backward, ``kernels/scatter.py``), each
taken through a checkout's own code in a subprocess rooted at it (this
checkout, and the one at DIR when given, in turns parent, change, change,
parent):

- **split**: the float32 and bf16 wrappers (``dfeat_scatter_cuda``,
  ``dfeat_scatter_bf16_cuda``) at the train step's two shapes (V = 3
  views of 512x512 maps; the pixel fetch's 153,600 points at C = 384, the
  painting fetch's 6,890 vertices at C = 192), on two sets of base ids:
  ``step``, those that a full-width train step gives (``_sample_taps`` of
  the uv that ``RenderPipeline.fetch_uv`` projects for sample 0 of the
  synthetic train data at step 0's seed: the patch rays' samples, masked
  rays collapsed onto one texel, and the painted vertices), and
  ``fixture``, the card tests' clustered ids (30 points a touched texel).
  Per call: the CUDA-event time of 20 back-to-back calls, the host's wall
  time, and from a torch.profiler trace of 10 calls each device
  operation's time (sort, cumsum, fills, copies, each hand kernel) and the
  host's time inside CUDA synchronisation calls;
- **train** (unless ``--skip-train``): the train entry point in bf16
  (``configs/train_or_eval.yaml``, ``dataset synthetic``, full width) at
  ``train.batch_size`` 1 and 4, 6 steps each, the step median and the peak
  device memory, and a profiled run at batch 1 (``--steps 11
  profile_dir``) whose trace gives K3's device ms a step, the device's idle
  time inside each K3 call (from its sort's start to its last kernel's
  end) and just after it, and the step's idle share.

The inputs (ids, weights, seeded cotangents) are made once, by this
checkout, and read by both from one file.  Needs one CUDA card and nvcc.
Prints one JSON object as its last line (and writes it to OUT).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

IMAGE = (512, 512)
# the device kernels of K3 (both designs' names), and those of the sort
K3_KERNELS = ("dfeat_scatter", "segments_kernel", "segment_sums_kernel",
              "touched_rows_kernel")
SORT_KERNELS = ("radixsort", "sort")
K3_PRELUDE = ("bf16_keys_kernel", "bf16_range_kernel")  # before its sort


def fixture_ids(n: int, seed: int):
    """The card tests' clustered base ids (3, n): runs of 30 equal ids at
    random texels of a 512x512 map, and random bilinear weights."""
    rng = np.random.default_rng(seed)
    hw, wf = IMAGE[0] * IMAGE[1], IMAGE[1]
    ids = np.stack([np.repeat(rng.integers(0, hw - wf - 2, -(-n // 30)),
                              30)[:n] for _ in range(3)])
    wx, wy = rng.random((2, 3, n)).astype(np.float32)
    w4 = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                   wx * wy], axis=-1)
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(w4)))


def split_inputs(dev) -> dict:
    """name -> (ids (3, N) int32, w4 (3, N, 4), C) on the CPU: the step's
    and the fixture's ids at both train shapes."""
    from ..kernels.gather import _bilinear_w4, _sample_taps
    from .kernel_ab import step_uv

    out = {}
    for tag, uv, c in zip(("pixel", "paint"), step_uv(dev), (384, 192)):
        _, _, base, wx, wy, _, _ = _sample_taps((3, *IMAGE, c), uv, IMAGE)
        out[f"step_{tag}"] = (base.to(torch.int32).contiguous().cpu(),
                              _bilinear_w4(wx, wy).contiguous().cpu(), c)
        ids, w4 = fixture_ids(uv.shape[1], uv.shape[1])
        out[f"fixture_{tag}"] = (ids, w4, c)
    return out


def _run_lengths(ids) -> dict:
    """Distinct ids a view, rows a touched texel and the longest run."""
    runs = [torch.unique(i, return_counts=True)[1] for i in ids]
    return {"distinct": sum(int(r.numel()) for r in runs),
            "per_texel": ids.numel() / sum(int(r.numel()) for r in runs),
            "longest": max(int(r.max()) for r in runs)}


# Run in a checkout's root (argv: the inputs file): the split of that
# checkout's K3 wrappers; prints a JSON line.
SPLIT = r"""
import gzip, json, os, sys, tempfile, time, torch
from transhuman_tpu_torch.kernels import build, scatter

dev = torch.device("cuda")
inp = torch.load(sys.argv[1])
K3 = %(k3)r
SORT = %(sort)r

def event_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters, (time.perf_counter() - t0) * 1e3 / iters

def group(name):
    low = name.lower()
    if any(k in low for k in K3):
        short = name.replace("(anonymous namespace)::", "")
        return short.replace("void ", "").split("<")[0].split("(")[0]
    if any(k in low for k in SORT):
        return "sort"
    if "scan" in low:
        return "cumsum (scan)"
    if "fill" in low:
        return "fill (zeros, ones)"
    return "other"

def profile(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    dev_ms, host_sync = {}, 0.0
    for e in ev:
        cat = e.get("cat")
        if cat == "kernel":
            g = group(e["name"])
        elif cat in ("gpu_memcpy", "gpu_memset"):
            g = e["name"]
        elif cat == "cuda_runtime" and "Synchronize" in e["name"]:
            host_sync += e["dur"]
            continue
        else:
            continue
        dev_ms[g] = dev_ms.get(g, 0.0) + e["dur"] / 1e3 / iters
    # the last call's own synchronisation (outside the wrapper) included
    return dev_ms, host_sync / 1e3 / iters

build.library()
torch.backends.cuda.matmul.allow_tf32 = False
res = {}
for name, (ids, w4, c) in inp["cases"].items():
    ids, w4 = ids.to(dev), w4.to(dev)
    g = torch.randn((3, ids.shape[1], c), device=dev,
                    generator=torch.Generator(dev).manual_seed(6))
    hw = 512 * 512
    for form, fn, gg in (("bf16", scatter.dfeat_scatter_bf16_cuda,
                          g.to(torch.bfloat16)),
                         ("f32", scatter.dfeat_scatter_cuda, g)):
        call = lambda fn=fn, gg=gg: fn(ids, gg, w4, hw, 1, 512)
        ms, wall = event_ms(call)
        dev_ms, sync_ms = profile(call)
        res[f"{form}_{name}"] = {"event_ms": ms, "wall_ms": wall,
                                 "device_ms": dev_ms,
                                 "device_sum_ms": sum(dev_ms.values()),
                                 "host_sync_ms": sync_ms}
    del g
print(json.dumps(res), flush=True)
""" % {"k3": K3_KERNELS, "sort": SORT_KERNELS}

# Run in a checkout's root (argv: a scratch directory): the train entry
# point in bf16 at batch 1 and 4, then a profiled run; prints a JSON line.
TRAIN = r"""
import json, os, sys, torch
from transhuman_tpu_torch.cli import train as train_cli

tmp = sys.argv[1]
res = {}
for tag, b, steps, extra in (("b1", 1, 6, ()), ("b4", 4, 6, ()),
                             ("profile_b1", 1, 11,
                              ("profile_dir", os.path.join(tmp, "prof")))):
    run = os.path.join(tmp, tag)
    argv = ["--device", "cuda", "--steps", str(steps), "--cfg_file",
            os.path.join("configs", "train_or_eval.yaml"), "dataset",
            "synthetic", "ep_iter", str(steps), "train.epoch", "1",
            "compute_dtype", "bfloat16", "train.batch_size", str(b),
            "trained_model_dir", os.path.join(run, "tm"), "record_dir",
            os.path.join(run, "rec"), *extra]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, recs = train_cli.main(argv)
    torch.cuda.synchronize()
    step = [r["step_s"] * 1e3 for r in recs]
    res[tag] = {"step_ms": step,
                "median_ms": sorted(step[1:])[len(step[1:]) // 2],
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
with open(os.path.join(tmp, "prof", "summary.json")) as f:
    res["profile_b1"]["summary"] = json.load(f)
res["trace"] = os.path.join(tmp, "prof", "train_trace.json.gz")
print(json.dumps(res), flush=True)
"""


def k3_in_trace(path: str) -> dict:
    """From a train step trace: K3's device ms a step (its named kernels),
    and per K3 call the device's idle ms inside it and just after it (to
    the next device event's start).  A call spans from its first kernel
    before the sort (the bf16 form's keys), or else from the start of the
    sort the wrapper begins with (the float32 form's route), to its last
    kernel's end."""
    from ..train.profile import PHASES, load_trace

    events = [e for e in load_trace(path).get("traceEvents", [])
              if e.get("ph") == "X"]
    steps = sum(1 for e in events if e.get("cat") == "user_annotation"
                and e["name"] == PHASES[0])
    dev = sorted((e for e in events if e.get("cat") in
                  ("kernel", "gpu_memcpy", "gpu_memset")),
                 key=lambda e: e["ts"])

    def named(e, keys):
        return e["cat"] == "kernel" and any(k in e["name"].lower()
                                            for k in keys)

    # runs of K3 kernels, copies and memsets between them
    clusters, i = [], 0
    while i < len(dev):
        if not named(dev[i], K3_KERNELS):
            i += 1
            continue
        j = i
        while j + 1 < len(dev) and (named(dev[j + 1], K3_KERNELS) or
                                    dev[j + 1]["cat"] != "kernel"):
            j += 1
        while not named(dev[j], K3_KERNELS):
            j -= 1
        clusters.append((i, j))
        i = j + 1
    calls, prelude = [], None
    for i, j in clusters:
        if all(named(e, K3_PRELUDE) for e in dev[i:j + 1]
               if e["cat"] == "kernel"):  # the bf16 form's keys
            prelude = prelude if prelude is not None else i
            continue
        a = prelude
        if a is None:  # back to the start of the sort before the cluster
            a = i
            for back in range(i - 1, max(i - 24, -1), -1):
                if named(dev[back], SORT_KERNELS):
                    a = back
                    while a > 0 and named(dev[a - 1], SORT_KERNELS):
                        a -= 1
                    break
        span = dev[a:j + 1]
        t0, t1 = span[0]["ts"], max(e["ts"] + e["dur"] for e in span)
        busy, end = 0.0, t0
        for e in span:
            b0, b1 = max(e["ts"], end), e["ts"] + e["dur"]
            if b1 > b0:
                busy += b1 - b0
                end = b1
        after = (dev[j + 1]["ts"] - t1) if j + 1 < len(dev) else 0.0
        calls.append({"kernel_ms": sum(e["dur"] for e in span
                                       if named(e, K3_KERNELS)) / 1e3,
                      "span_ms": (t1 - t0) / 1e3,
                      "idle_inside_ms": (t1 - t0 - busy) / 1e3,
                      "idle_after_ms": max(after, 0.0) / 1e3})
        prelude = None
    per = max(steps, 1)
    return {"steps": steps, "calls": calls,
            "k3_kernel_ms_per_step": sum(c["kernel_ms"] for c in calls) / per,
            "k3_span_ms_per_step": sum(c["span_ms"] for c in calls) / per,
            "idle_inside_ms_per_step":
                sum(c["idle_inside_ms"] for c in calls) / per,
            "idle_after_ms_per_step":
                sum(c["idle_after_ms"] for c in calls) / per}


def variants(dev, cases) -> dict:
    """This checkout's bf16 wrapper as it is (the ids checked behind one
    host wait) and with ``ids_in_map`` (no check, no wait), on the step's
    ids at both shapes: each one's CUDA-event ms a call (20 calls after 3),
    the host's ms a call to queue 20 calls (the card synchronised before
    and after), and whether the two maps are the same bits."""
    from ..kernels import scatter

    hw = IMAGE[0] * IMAGE[1]
    res = {}
    for name in ("step_pixel", "step_paint"):
        ids, w4, c = (x.to(dev) if torch.is_tensor(x) else x
                      for x in cases[name])
        v, n = ids.shape
        g = torch.randn((v, n, c), device=dev,
                        generator=torch.Generator(dev).manual_seed(6)).to(
                            torch.bfloat16)
        calls = {"wrapper": lambda: scatter.dfeat_scatter_bf16_cuda(
                     ids, g, w4, hw, 1, IMAGE[1]),
                 "ids_in_map": lambda: scatter.dfeat_scatter_bf16_cuda(
                     ids, g, w4, hw, 1, IMAGE[1], ids_in_map=True)}
        want = calls["wrapper"]()
        res[name] = {tag: {"bit_identical": torch.equal(fn(), want),
                           "ms": _event_ms(fn), "host_ms": _host_ms(fn)}
                     for tag, fn in calls.items()}
        print(f"variants {name}: {json.dumps(res[name])}", flush=True)
    return res


def _event_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _host_ms(fn, iters: int = 20) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def _run(script: str, root: str, *args, timeout: int = 1500) -> dict:
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", script, *args], cwd=root,
                         env=env, capture_output=True, text=True,
                         timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"k3_split: {root} failed:\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="root of a checkout to compare against")
    ap.add_argument("--json", help="also write the result here")
    ap.add_argument("--skip-train", action="store_true",
                    help="only the wrappers' split")
    ap.add_argument("--variants", action="store_true",
                    help="also this checkout's bf16 wrapper with and without "
                         "its ids check")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k3_split: needs a CUDA card")
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    roots = ([("parent", os.path.abspath(args.parent)), ("change", here),
              ("change", here), ("parent", os.path.abspath(args.parent))]
             if args.parent else [("change", here)])
    dev = torch.device("cuda")
    cases = split_inputs(dev)
    res = {"card": torch.cuda.get_device_name(0),
           "ids": {k: _run_lengths(v[0]) for k, v in cases.items()},
           "split_turns": [], "train_turns": []}
    if args.variants:
        res["variants"] = variants(dev, cases)
    with tempfile.TemporaryDirectory(prefix="k3_split_") as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save({"cases": cases}, inputs)
        for tag, root in roots:
            turn = {"checkout": tag, **_run(SPLIT, root, inputs)}
            res["split_turns"].append(turn)
            print(f"split {tag}: " + json.dumps(turn), flush=True)
        if not args.skip_train:
            for i, (tag, root) in enumerate(roots[:2] if args.parent
                                            else roots):
                work = os.path.join(tmp, f"train{i}")
                os.makedirs(work)
                t = _run(TRAIN, root, work)
                t["k3"] = k3_in_trace(t.pop("trace"))
                res["train_turns"].append({"checkout": tag, **t})
                print(f"train {tag}: " + json.dumps(t), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
