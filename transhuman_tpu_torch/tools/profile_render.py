"""Time and profile the full-width serve render on one card, in a compute
dtype:

    python -m transhuman_tpu_torch.tools.profile_render \
        [--compute_dtype float32|bfloat16] [--repeats 3] [--out DIR]

Builds the full-width model (random weights from its seed) and the
RenderService that ``serve.py`` runs, renders one warm-up frame, then the
three 512x512 requests of ``chip_smoke.py`` phase 5 (targets at views 0, 1
and 2, the third at another pose) ``--repeats`` times in that order, each
timed on the host with the card synchronised on both sides (no HTTP), and
the prologue alone (encoder, painting fetch, TransHE) as often.  Then one
more pass over the three requests runs under torch.profiler: the chrome
trace goes to DIR and its device-time summary (``train/profile.py``: busy
time per request, idle share, time per kernel group) is printed and
written beside it.  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

RANGE = "render.request"


def _requests(frame, smpl, hw: int):
    rng = np.random.default_rng(1)
    verts2, _, blend2 = smpl(rng.normal(0, 0.2, 72), np.zeros(10))
    out = []
    for target, verts, blend in ((0, None, None), (1, None, None),
                                 (2, verts2, blend2[:, :3, :3])):
        out.append({
            "images": frame.images.numpy(), "K": frame.K.numpy(),
            "R": frame.R.numpy(), "T": frame.T.numpy(),
            "verts_world": (frame.verts_world.numpy() if verts is None
                            else verts),
            "blend_rot": (frame.blend_rot.numpy() if blend is None
                          else np.ascontiguousarray(blend)),
            "tK": frame.K[target].numpy(), "tR": frame.R[target].numpy(),
            "tT": frame.T[target].numpy(), "H": hw, "W": hw})
    return out


def _synced_ms(fn) -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def main(argv=None) -> dict:
    from ..cli.common import configure_device
    from ..config import Config
    from ..models.network import COMPUTE_DTYPES
    from ..serve import RenderService
    from ..testing import synthetic_setup
    from ..train.profile import format_summary, load_trace, summarize_trace

    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.profile_render")
    p.add_argument("--compute_dtype", default="float32",
                   choices=sorted(COMPUTE_DTYPES))
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--out", default="profile_render")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_render needs a CUDA card")
    dev = configure_device("cuda")
    hw, dtype = 512, args.compute_dtype
    _, pipe, frame, smpl, _ = synthetic_setup(
        image_hw=(hw, hw), device=dev, compute_dtype=COMPUTE_DTYPES[dtype])
    svc = RenderService(Config().merge_opts(["compute_dtype", dtype]), pipe,
                        smpl)
    svc.warmup(hw, hw)
    reqs = _requests(frame, smpl, hw)
    frame_d = frame.to(dev)
    torch.cuda.reset_peak_memory_stats()
    times = {"request": [], "prologue": []}
    for _ in range(args.repeats):
        times["request"].append([_synced_ms(lambda: svc.render(r))
                                 for r in reqs])
        times["prologue"].append(_synced_ms(lambda: pipe.prologue(frame_d)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"render_{dtype}.json.gz")
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    wall = 0.0
    with prof:
        for r in reqs:
            torch.cuda.synchronize()
            t = time.perf_counter()
            with record_function(RANGE):
                svc.render(r)
            torch.cuda.synchronize()
            wall += (time.perf_counter() - t) * 1e3
    prof.export_chrome_trace(path)
    summary = summarize_trace(load_trace(path), wall, len(reqs),
                              phases=(RANGE,))
    card = torch.cuda.get_device_name(0)
    result = {"card": card, "compute_dtype": dtype,
              "request_ms": times["request"],
              "prologue_ms": times["prologue"], "peak_gib": peak,
              "profile": summary}
    with open(os.path.join(args.out, f"render_{dtype}.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(f"{card}, {dtype}: request ms per repeat (views 0, 1, 2 at "
          f"another pose) {times['request']}; prologue ms "
          f"{[round(x, 2) for x in times['prologue']]}; peak "
          f"{peak:.3f} GiB\nprofiled pass, per request:\n"
          f"{format_summary(summary)}", flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
