"""Same-card A/B of the hand-written kernels between two checkouts.

    python -m transhuman_tpu_torch.tools.kernel_ab --parent DIR [--json OUT]

Builds the kernel library of the checkout at DIR (with that checkout's own
``kernels/build.py``, in a subprocess run there) and of this checkout, and
on seeded inputs says whether the two give the same bits (the largest
difference where they do not) and times both in turns parent, change,
change, parent with CUDA events:

- K1 (cull) and K2 (DPaRF), whose C entries both checkouts share, as bare
  launches of the two libraries in this process, on the inputs of
  ``chip_smoke.py`` phase 3 (one 32,768-point decode chunk around the
  seeded synthetic body: 6,890 vertices, 300 clusters, V = 3, D = 192,
  k = 7);
- K4 (the feature fetch) and K3 (its backward), whose C entries may differ
  between the checkouts, through each checkout's own wrappers, each in a
  subprocess rooted at its checkout: K4 as the whole
  ``sample_feature_map`` forward (what the render path pays) and in its id
  form on the same taps, at the serve shapes (a 32,768-point chunk into
  (3, 512, 512, 384) maps, the 6,890 vertices into (3, 512, 512, 192)
  maps); K3 at the train shapes (153,600 points at C = 384, the 6,890
  vertices at C = 192).  The points are the phase 3 body points projected
  into the seeded synthetic scene's three 512x512 views, the maps and
  cotangents seeded normals made on the card; the id form's ids and
  weights, and K3's, are this checkout's _sample_taps of those points,
  read by both checkouts from one file.

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
import tempfile

import numpy as np
import torch

from ..geometry.clusters import ClusterSpec
from ..geometry.smpl import SMPLModel
from ..kernels import build

N_CHUNK = 32768  # points per decode chunk (Config.chunk_size)
N_TRAIN = 153600  # points of one train batch (6 patches of 20x20 rays x 64)
K = 7
IMAGE = (512, 512)


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


def fetch_inputs(dev) -> dict:
    """The K4 / K3 inputs that both checkouts read from one file: uv of the
    phase 3 chunk and of the vertices in the synthetic scene's three views,
    and the base ids and tap weights (this checkout's _sample_taps) of the
    chunk, of the vertices and of a train batch's worth of body points."""
    from ..kernels.gather import _bilinear_w4, _sample_taps
    from ..ops.sampling import project_points
    from ..testing import synthetic_scene

    frame, _, _ = synthetic_scene(image_hw=IMAGE)
    cams = [t.to(dev) for t in (frame.K, frame.R, frame.T)]
    pts = phase3_inputs(dev, N_TRAIN)[0]
    verts = frame.verts_world.to(dev)
    out = {"uv_chunk": project_points(pts[:N_CHUNK], *cams)[0].contiguous(),
           "uv_verts": project_points(verts, *cams)[0].contiguous()}
    for tag, uv in (("chunk", out["uv_chunk"]),
                    ("verts", out["uv_verts"]),
                    ("train", project_points(pts, *cams)[0])):
        _, _, base, wx, wy, dx, dy = _sample_taps((3, *IMAGE, 1), uv, IMAGE)
        out[f"ids_{tag}"] = base.to(torch.int32).contiguous()
        out[f"w4_{tag}"] = _bilinear_w4(wx, wy).contiguous()
    out["taps"] = torch.tensor([dx, dy])
    return out


# Run by each checkout's own interpreter in its own root (argv: the inputs
# file, a file for the outputs or "-"): times K4 and K3 through that
# checkout's wrappers, which both checkouts have, and prints a JSON line.
WRAPPER_AB = r"""
import json, sys, torch
from transhuman_tpu_torch.kernels import build, gather, scatter
from transhuman_tpu_torch.ops.sampling import sample_feature_map

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
inp = {k: v.to(dev) for k, v in torch.load(sys.argv[1]).items()}
image = (512, 512)

def seeded(shape, seed):
    return torch.randn(shape, device=dev,
                       generator=torch.Generator(dev).manual_seed(seed))

def time_ms(fn, iters=20, warmup=3):
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

build.library()
calls = {}
dx, dy = (int(x) for x in inp["taps"])
offs = (0, dx, dy, dy + dx)
for tag, c, uv in (("pixel", 384, "chunk"), ("paint", 192, "verts")):
    fmap = seeded((3, 512, 512, c), c)
    src = fmap.reshape(3, -1, c)
    ids, w4 = inp[f"ids_{uv}"], inp[f"w4_{uv}"]
    uv = inp[f"uv_{uv}"]

    def forward(fmap=fmap, uv=uv):
        with torch.no_grad():
            return sample_feature_map(fmap, uv, image)

    calls[f"k4_forward_{tag}"] = forward
    calls[f"k4_ids_{tag}"] = (lambda src=src, ids=ids, w4=w4:
                              gather.feature_gather_cuda(src, ids, w4, offs))
for tag, c, pts in (("pixel", 384, "train"), ("paint", 192, "verts")):
    ids, w4 = inp[f"ids_{pts}"], inp[f"w4_{pts}"]
    g = seeded((3, ids.shape[1], c), 10 + c)
    calls[f"k3_{tag}"] = (lambda ids=ids, g=g, w4=w4:
                          scatter.dfeat_scatter_cuda(ids, g, w4, 512 * 512,
                                                     dx, dy))
if sys.argv[2] != "-":
    torch.save({k: fn().cpu() for k, fn in calls.items()}, sys.argv[2])
print(json.dumps({k: time_ms(fn) for k, fn in calls.items()}), flush=True)
"""


def _load(path: str, names) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = build._SIGNATURES[name]
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


def run_wrappers(root: str, inputs: str, outputs: str = "-") -> dict:
    """WRAPPER_AB in a subprocess rooted at root: its times (and, given a
    file, its outputs there)."""
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", WRAPPER_AB, inputs, outputs],
                         cwd=root, env=env, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"kernel_ab: the wrappers of {root} failed:\n"
                           f"{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


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


def _diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def ab_k1_k2(libs: dict, dev) -> dict:
    """K1 and K2 of both libraries on phase 3's inputs: bits and times."""
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
    res = {
        "k2_bit_identical": all(torch.equal(a, b) for a, b in
                                zip(outs["parent"][1], outs["change"][1])),
        "k2_max_abs_diff": {name: _diff(a, b) for name, a, b in
                            zip(names, outs["parent"][1],
                                outs["change"][1])},
        "k1_bit_identical": torch.equal(outs["parent"][0], outs["change"][0]),
        "k1_max_abs_diff": _diff(outs["parent"][0], outs["change"][0]),
        "turns": [{"lib": tag,
                   "k1_ms": _time_ms(k1(libs[tag], outs[tag][0])),
                   "k2_ms": _time_ms(k2(libs[tag], outs[tag][1]))}
                  for tag in ("parent", "change", "change", "parent")],
    }
    for t in res["turns"]:
        print(f"{t['lib']}: K1 {t['k1_ms']:.4f} ms, K2 {t['k2_ms']:.4f} ms "
              f"(bare launches, {n} pts)", flush=True)
    return res


def ab_k3_k4(parent: str, dev) -> dict:
    """K4 and K3 through each checkout's wrappers: bits and times."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save({k: v.cpu() for k, v in fetch_inputs(dev).items()},
                   inputs)
        turns, outs = [], {}
        for i, (tag, root) in enumerate((("parent", parent),
                                         ("change", here),
                                         ("change", here),
                                         ("parent", parent))):
            path = os.path.join(tmp, f"{tag}.pt") if i < 2 else "-"
            turns.append({"checkout": tag, **run_wrappers(root, inputs,
                                                          path)})
            if i < 2:
                outs[tag] = torch.load(path)
    res = {"wrapper_turns": turns, "bit_identical": {}, "max_abs_diff": {}}
    for name in outs["change"]:
        a, b = outs["parent"][name], outs["change"][name]
        res["bit_identical"][name] = torch.equal(a, b)
        res["max_abs_diff"][name] = _diff(a, b)
    for t in turns:
        print(f"{t['checkout']}: " + ", ".join(
            f"{k} {x:.4f} ms" for k, x in t.items() if k != "checkout"),
            flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the checkout to compare against")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    parent = os.path.abspath(args.parent)
    shared = ("thp_min_excess2", "thp_dparf", "thp_error_string")
    libs = {"parent": _load(build_parent(parent), shared),
            "change": _load(build.build().path, shared)}
    dev = torch.device("cuda")
    res = {"card": torch.cuda.get_device_name(0), **ab_k1_k2(libs, dev),
           **ab_k3_k4(parent, dev)}
    print(f"K2 bit-identical: {res['k2_bit_identical']}; K1 bit-identical: "
          f"{res['k1_bit_identical']}; K3/K4 bit-identical: "
          f"{res['bit_identical']} (max diffs {res['max_abs_diff']})",
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
