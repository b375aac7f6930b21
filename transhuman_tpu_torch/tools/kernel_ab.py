"""Same-card A/B of K1 (cull) and K2 (DPaRF) between two checkouts.

    python -m transhuman_tpu_torch.tools.kernel_ab --parent DIR [--json OUT]

Builds the kernel library of the checkout at DIR (with that checkout's own
``kernels/build.py``, in a subprocess run there) and of this checkout, loads
both with ctypes, and on the inputs of ``chip_smoke.py`` phase 3 (one
32,768-point decode chunk around the seeded synthetic body: 6,890 vertices,
300 clusters, V = 3, D = 192, k = 7):

- says whether K2's five outputs are bit-identical between the two
  libraries, and the largest difference of each output where they are not;
  the same for K1's output;
- times both kernels of each library in turns (parent, change, change,
  parent) with CUDA events, the bare launches without the wrappers.

Needs one CUDA card and nvcc.  Prints one JSON object as its last line (and
writes it to OUT).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..geometry.clusters import ClusterSpec
from ..geometry.smpl import SMPLModel
from ..kernels import build

N_CHUNK = 32768  # points per decode chunk (Config.chunk_size)
K = 7


def phase3_inputs(dev, n: int = N_CHUNK):
    """(pts (n, 3), verts (6890, 3), centers (300, 3), rot (300, 3, 3),
    tokens (3, 300, 192)): body-scale points (vertices of a seeded pose
    jittered across the 0.1 m shell), the cluster centres and rotations
    pooled from that pose, random tokens; float32 on dev."""
    rng = np.random.default_rng(0)
    smpl = SMPLModel.synthetic()
    verts_np, _, blend = smpl(rng.normal(0, 0.2, 72), np.zeros(10))
    base = verts_np[rng.integers(0, verts_np.shape[0], n)]
    pts_np = base + rng.normal(0, 0.08, base.shape).astype(np.float32)
    pts = torch.from_numpy(pts_np.astype(np.float32)).to(dev)
    verts = torch.from_numpy(verts_np).to(dev)
    cluster = ClusterSpec.from_kmeans(smpl.v_template, 300, iters=8)
    pool = torch.from_numpy(cluster.pool_matrix).to(dev)
    centers = (pool @ verts).contiguous()
    rot = torch.einsum("cv,vij->cij", pool,
                       torch.from_numpy(blend[:, :3, :3].copy()).to(dev))
    tokens = torch.from_numpy(
        rng.standard_normal((3, 300, 192)).astype(np.float32)).to(dev)
    return pts, verts, centers, rot.contiguous(), tokens


def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name, (argtypes, restype) in build._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def build_parent(parent: str) -> str:
    """Build DIR's library with DIR's own build.py; its path."""
    code = ("from transhuman_tpu_torch.kernels import build; "
            "r = build.build(); print(r.path); print(f'{r.seconds:.2f}')")
    env = dict(os.environ, PYTHONPATH=parent)
    out = subprocess.run([sys.executable, "-c", code], cwd=parent, env=env,
                         capture_output=True, text=True, check=True,
                         timeout=900).stdout.split()
    print(f"parent library built in {out[-1]} s: {out[-2]}", flush=True)
    return out[-2]


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the checkout to compare against")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = {"parent": _load(build_parent(os.path.abspath(args.parent))),
            "change": _load(build.build().path)}
    dev = torch.device("cuda")
    pts, verts, centers, rot, tokens = phase3_inputs(dev)
    n, m, c = pts.shape[0], verts.shape[0], centers.shape[0]
    v, _, d = tokens.shape
    zeros = torch.zeros(m, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def outputs():
        return (torch.empty(n, device=dev),
                (torch.empty((v, n, d), device=dev),
                 torch.empty((n, 63), device=dev),
                 torch.empty((n, K), device=dev),
                 torch.empty((n, K), dtype=torch.int32, device=dev),
                 torch.empty((n, K), device=dev)))

    def k1(lib, out):
        return lambda: build.check(lib.thp_min_excess2(
            pts.data_ptr(), verts.data_ptr(), zeros.data_ptr(),
            out.data_ptr(), n, m, stream), "K1")

    def k2(lib, outs):
        return lambda: build.check(lib.thp_dparf(
            pts.data_ptr(), centers.data_ptr(), rot.data_ptr(),
            tokens.data_ptr(), *(t.data_ptr() for t in outs), n, c, v, d, K,
            10, 0.5, stream), "K2")

    outs = {tag: outputs() for tag in libs}
    for tag, lib in libs.items():
        k1(lib, outs[tag][0])()
        k2(lib, outs[tag][1])()
    torch.cuda.synchronize()
    names = ("tok", "pe", "dist", "idx", "w")
    k2_diff = {name: float((a.double() - b.double()).abs().max())
               for name, a, b in zip(names, outs["parent"][1],
                                     outs["change"][1])}
    res = {
        "card": torch.cuda.get_device_name(0),
        "k2_bit_identical": all(torch.equal(a, b) for a, b in
                                zip(outs["parent"][1], outs["change"][1])),
        "k2_max_abs_diff": k2_diff,
        "k1_bit_identical": torch.equal(outs["parent"][0], outs["change"][0]),
        "k1_max_abs_diff": float((outs["parent"][0]
                                  - outs["change"][0]).abs().max()),
        "turns": [],
    }
    for tag in ("parent", "change", "change", "parent"):
        res["turns"].append({
            "lib": tag,
            "k1_ms": _time_ms(k1(libs[tag], outs[tag][0])),
            "k2_ms": _time_ms(k2(libs[tag], outs[tag][1])),
        })
    for t in res["turns"]:
        print(f"{t['lib']}: K1 {t['k1_ms']:.4f} ms, K2 {t['k2_ms']:.4f} ms "
              f"(bare launches, {n} pts)", flush=True)
    print(f"K2 bit-identical: {res['k2_bit_identical']} (max diffs "
          f"{k2_diff}); K1 bit-identical: {res['k1_bit_identical']} (max "
          f"diff {res['k1_max_abs_diff']:.3g})", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
