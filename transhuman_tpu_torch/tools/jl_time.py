"""Seconds of ``chip_smoke.py``'s phases j and l, for checkouts side by side.

    python -m transhuman_tpu_torch.tools.jl_time ROOT [ROOT ...] [--json OUT]

For each ROOT in turn (a checkout, e.g. a ``git archive`` of another commit
in a gitignored directory, or ``.``), runs in a subprocess rooted there
that checkout's own ``chip_smoke.py`` phases 1-2 (device, build), then its
phases j and l as its ``main`` runs them, and reads their seconds: where
the script has ``phase_ranks`` (j and l in one torchrun), K2 at D = 384
and 768 and ``phase_ranks``; else j (``phase_dp_train``,
``phase_sharded_eval``) and l (K2 at D = 384 and 768, ``phase_tp_train``,
``phase_pp``).  Every check of those phases runs as in
the script; a failure ends the run.  Needs one CUDA card and nvcc.  Prints
one JSON object as its last line: per turn its root and seconds.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

_SECTION = r"""
import json, os, shutil, sys, tempfile, time
sys.path.insert(0, os.getcwd())
import chip_smoke as cs

card = cs.phase_device()
cs.phase_build()
tmp = tempfile.mkdtemp(prefix="thp_jl_")
try:
    t = time.perf_counter()
    if hasattr(cs, "phase_ranks"):
        for d in (384, 768):
            cs.check_dparf_width(card, d)
        cs.phase_ranks(card, tmp)
        secs = {"j+l": time.perf_counter() - t}
    else:
        _, ckpt = cs.phase_dp_train(card, tmp)
        cs.phase_sharded_eval(card, tmp, ckpt)
        secs = {"j": time.perf_counter() - t}
        t = time.perf_counter()
        for d in (384, 768):
            cs.check_dparf_width(card, d)
        cs.phase_tp_train(card, tmp)
        cs.phase_pp(card, tmp)
        secs["l"] = time.perf_counter() - t
        secs["j+l"] = secs["j"] + secs["l"]
finally:
    shutil.rmtree(tmp, ignore_errors=True)
print("jl seconds: " + json.dumps(secs), flush=True)
"""


def run_root(root: str, timeout: float) -> dict:
    """Phases j and l of the checkout at root, in a subprocess there: its
    seconds by phase; fails (SystemExit) unless it exits 0."""
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", _SECTION], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)
    sys.stderr.write(proc.stderr[-20000:])
    sys.stdout.write(proc.stdout[-4000:])
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith("jl seconds: ")]
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"jl_time: {root} exited {proc.returncode}")
    return json.loads(lines[-1][len("jl seconds: "):])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", help="checkouts, timed in order")
    ap.add_argument("--json", help="also write the result here")
    ap.add_argument("--timeout", type=float, default=1500,
                    help="seconds for one root's run")
    args = ap.parse_args(argv)
    turns = []
    for root in args.roots:
        root = os.path.abspath(root)
        turns.append({"root": root, "seconds": run_root(root, args.timeout)})
        print(f"jl_time: {root}: {turns[-1]['seconds']}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(turns, f, indent=1)
    print(json.dumps(turns), flush=True)
    return turns


if __name__ == "__main__":
    main()
