"""Same-card A/B of the hand-written kernels between two checkouts.

    python -m transhuman_tpu_torch.tools.kernel_ab --parent DIR [--json OUT]

Builds the kernel library of the checkout at DIR (with that checkout's own
``kernels/build.py``, in a subprocess run there) and of this checkout, and
on seeded inputs says whether the two give the same bits (the largest
difference where they do not) and times both in turns parent, change,
change, parent with CUDA events:

- K1 (cull) and K2 (DPaRF, its float32 and bf16 forms), whose C entries
  both checkouts share, as bare launches of the two libraries in this
  process, on the inputs of ``chip_smoke.py`` phase 3 (one 32,768-point
  decode chunk around the seeded synthetic body: 6,890 vertices, 300
  clusters, V = 3, D = 192, k = 7); K2 also at the survivor size (the cull
  survivors of the median 512-ray chunk of ``chip_smoke.py``'s serve
  request, with that frame's clusters) and, in bf16, at the train shape
  (153,600 body points) and at D = 384 and 768 on the chunk;
- K4 (the feature fetch) and K3 (its backward), whose C entries may differ
  between the checkouts, through each checkout's own wrappers, each in a
  subprocess rooted at its checkout: K4 as the whole
  ``sample_feature_map`` forward (what the render path pays) and in its id
  form on the same taps, at the serve shapes (a 32,768-point chunk into
  (3, 512, 512, 384) maps, the 6,890 vertices into (3, 512, 512, 192)
  maps); its bf16 forward on bf16 maps at the survivor size, the chunk and
  the painting shape (and, its C entry being shared, the bf16 form as bare
  launches of both libraries there too); K3 and its bf16 form at the train
  shapes (153,600 points at C = 384, the 6,890 vertices at C = 192), the
  bf16 form also on the ids of a real train step's two fetches
  (``step_uv``); K4's int8 form (the int8 pixel map's fetch) as the whole
  forward at the chunk and at the survivor size, the seeded map quantised
  by the checkout's own quantiser, where the checkout has the form (a row
  only one side has is timed and listed, not compared), and, its C entry
  being shared, as bare launches of both libraries at both sizes.  The points are the phase 3 body points projected into the
  seeded synthetic scene's three 512x512 views, the maps and cotangents
  seeded normals made on the card; the id form's ids and weights, and
  K3's, are this checkout's _sample_taps of those points, read by both
  checkouts from one file.

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


def serve_chunks(dev, image_hw=IMAGE):
    """The points of ``chip_smoke.py``'s serve request (target view 1 of the
    seeded synthetic scene, its eval rays in the body's box, 64 samples a
    ray) that survive the cull, chunk by chunk as
    ``RenderPipeline.render_frame`` culls them (512 rays a chunk, the
    0.1 m shell): (frame on dev, cluster spec, [world points (n_i, 3) of
    each chunk with survivors])."""
    from ..config import Config
    from ..data.ray_sampling import sample_eval_rays
    from ..geometry.rays import world_bounds
    from ..kernels.cull import shell_cull
    from ..render.pipeline import to_smpl
    from ..render.volume import sample_along_rays
    from ..testing import synthetic_scene

    cfg = Config()
    s, cr = cfg.N_samples, cfg.chunk_size // cfg.N_samples
    frame, _, cluster = synthetic_scene(image_hw=image_hw)
    er = sample_eval_rays(None, frame.K[1].numpy(), frame.R[1].numpy(),
                          frame.T[1].numpy().reshape(3, 1),
                          world_bounds(frame.verts_world.numpy(), False),
                          hw=image_hw)
    frame, rays = frame.to(dev), er.rays.to(dev)
    pts, _ = sample_along_rays(rays.ray_o, rays.ray_d, rays.near, rays.far,
                               s)
    chunks = []
    for a in range(0, rays.ray_o.shape[0], cr):
        flat = pts[a:a + cr].reshape(-1, 3)
        keep = shell_cull(to_smpl(frame, flat).contiguous(),
                          frame.tar_verts_smpl.contiguous(),
                          cfg.cull_distance)
        keep &= rays.mask[a:a + cr].repeat_interleave(s)
        idx = torch.nonzero(keep)[:, 0]
        if idx.numel():
            chunks.append(flat[idx])
    return frame, cluster, chunks


def survivor_inputs(dev, image_hw=IMAGE) -> dict:
    """K2's and K4's inputs at the main path's size: the survivors of the
    median chunk of ``serve_chunks`` (in SMPL coordinates, and their uv in
    the three views), that frame's cluster centres and rotations, and every
    chunk's survivor count."""
    from ..ops.sampling import project_points
    from ..render.pipeline import to_smpl

    frame, cluster, chunks = serve_chunks(dev, image_hw)
    chunks.sort(key=lambda t: t.shape[0])
    mid = chunks[len(chunks) // 2]
    pool = torch.from_numpy(cluster.pool_matrix).float().to(dev)
    return {"pts": to_smpl(frame, mid).contiguous(),
            "centers": (pool @ frame.tar_verts_smpl).contiguous(),
            "rot": torch.einsum("cv,vij->cij", pool,
                                frame.blend_rot).contiguous(),
            "uv": project_points(mid, frame.K, frame.R,
                                 frame.T)[0].contiguous(),
            "counts": [t.shape[0] for t in chunks]}


def step_uv(dev):
    """(uv (3, 153600, 2) of a full-width train step's pixel fetch, uv
    (3, 6890, 2) of its painting fetch): sample 0 of the synthetic train
    data at step 0's seed, projected by the pipeline the train entry point
    builds (masked rays collapsed onto one texel, as the step projects
    them)."""
    from ..cli.train import build_trainer
    from ..config import Config
    from ..render.pipeline import fold_in

    cfg = Config().merge_opts(["dataset", "synthetic"])
    _, _, data, pipe = build_trainer(cfg, dev)
    smp = data.get_train_sample(0).to(dev)
    f = smp.frame
    pts, _, pts_mask, _ = pipe.train_points(smp.rays, fold_in(cfg.seed, 0),
                                            cfg.perturb > 0)
    return pipe.fetch_uv(f, pts, pts_mask), pipe.fetch_uv(f, f.verts_world)


def fetch_inputs(dev) -> dict:
    """The K4 / K3 inputs that both checkouts read from one file: uv of the
    phase 3 chunk, of the vertices in the synthetic scene's three views and
    of the serve request's median chunk of survivors, and the base ids and
    tap weights (this checkout's _sample_taps) of the chunk, of the
    vertices, of a train batch's worth of body points, and of the two
    fetches of a real train step (``step_uv``)."""
    from ..kernels.gather import _bilinear_w4, _sample_taps
    from ..ops.sampling import project_points
    from ..testing import synthetic_scene

    frame, _, _ = synthetic_scene(image_hw=IMAGE)
    cams = [t.to(dev) for t in (frame.K, frame.R, frame.T)]
    pts = phase3_inputs(dev, N_TRAIN)[0]
    verts = frame.verts_world.to(dev)
    out = {"uv_chunk": project_points(pts[:N_CHUNK], *cams)[0].contiguous(),
           "uv_verts": project_points(verts, *cams)[0].contiguous(),
           "uv_surv": survivor_inputs(dev)["uv"]}
    step_pix, step_paint = step_uv(dev)
    for tag, uv in (("chunk", out["uv_chunk"]),
                    ("verts", out["uv_verts"]),
                    ("train", project_points(pts, *cams)[0]),
                    ("steppix", step_pix), ("steppaint", step_paint)):
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
    del src
maps16 = {c: seeded((3, 512, 512, c), c).to(torch.bfloat16) for c in (384, 192)}
for tag, c, uv in (("surv", 384, "surv"), ("pixel", 384, "chunk"),
                   ("paint", 192, "verts")):
    def forward16(fmap=maps16[c], uv=inp[f"uv_{uv}"]):
        with torch.no_grad():
            return sample_feature_map(fmap, uv, image)

    calls[f"k4_bf16_forward_{tag}"] = forward16
if hasattr(gather, "feature_sample_int8_cuda"):  # K4's int8 form
    from transhuman_tpu_torch.ops.sampling import quantize_feature_map

    q8, scale8 = quantize_feature_map(seeded((3, 512, 512, 384), 384))
    for tag, uv in (("pixel", "chunk"), ("surv", "surv")):
        def forward_int8(uv=inp[f"uv_{uv}"]):
            with torch.no_grad():
                return sample_feature_map(q8, uv, image, scale8)

        calls[f"k4_int8_{tag}"] = forward_int8
for tag, c, pts in (("pixel", 384, "train"), ("paint", 192, "verts"),
                    ("step_pixel", 384, "steppix"),
                    ("step_paint", 192, "steppaint")):
    ids, w4 = inp[f"ids_{pts}"], inp[f"w4_{pts}"]
    g = seeded((3, ids.shape[1], c), 10 + c)
    if not tag.startswith("step"):
        calls[f"k3_{tag}"] = (lambda ids=ids, g=g, w4=w4:
                              scatter.dfeat_scatter_cuda(ids, g, w4,
                                                         512 * 512, dx, dy))
    calls[f"k3_bf16_{tag}"] = (lambda ids=ids, g=g.to(torch.bfloat16), w4=w4:
                               scatter.dfeat_scatter_bf16_cuda(
                                   ids, g, w4, 512 * 512, dx, dy))
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


def k2_cases(dev) -> dict:
    """K2's sizes: name -> (C entry, pts, centers, rot, tokens).  The
    float32 form on phase 3's chunk and the survivor chunk; the bf16 form
    there too, at the train shape and at D = 384 and 768 on the chunk."""
    pts, _, centers, rot, tokens = phase3_inputs(dev)
    surv = survivor_inputs(dev)
    gen = torch.Generator(dev).manual_seed(4)
    t16 = tokens.to(torch.bfloat16)
    chunk, at_surv = (pts, centers, rot), (surv["pts"], surv["centers"],
                                           surv["rot"])
    out = {"k2": ("thp_dparf", *chunk, tokens),
           "k2_surv": ("thp_dparf", *at_surv, tokens),
           "k2_bf16": ("thp_dparf_bf16", *chunk, t16),
           "k2_bf16_surv": ("thp_dparf_bf16", *at_surv, t16),
           "k2_bf16_train": ("thp_dparf_bf16", phase3_inputs(dev, N_TRAIN)[0],
                             centers, rot, t16)}
    for d in (384, 768):
        wide = torch.randn((3, centers.shape[0], d), device=dev,
                           generator=gen).to(torch.bfloat16)
        out[f"k2_bf16_d{d}"] = ("thp_dparf_bf16", *chunk, wide)
    return out


def ab_k1_k2(libs: dict, dev) -> dict:
    """K1 on phase 3's inputs and K2 at each of ``k2_cases``, both
    libraries, bare launches: bits and times."""
    pts, verts, _, _, _ = phase3_inputs(dev)
    n, m = pts.shape[0], verts.shape[0]
    zeros = torch.zeros(m, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    cases = k2_cases(dev)

    def k2_outputs(p, tokens):
        nn, (v, _, d) = p.shape[0], tokens.shape
        return (torch.empty((v, nn, d), dtype=tokens.dtype, device=dev),
                torch.empty((nn, 63), device=dev),
                torch.empty((nn, K), device=dev),
                torch.empty((nn, K), dtype=torch.int32, device=dev),
                torch.empty((nn, K), device=dev))

    def k1(lib, out):
        return lambda: build.check(lib.thp_min_excess2(
            pts.data_ptr(), verts.data_ptr(), zeros.data_ptr(),
            out.data_ptr(), n, m, stream), "K1")

    def k2(lib, case, outs):
        entry, p, centers, rot, tokens = cases[case]
        v, c, d = tokens.shape
        return lambda: build.check(getattr(lib, entry)(
            p.data_ptr(), centers.data_ptr(), rot.data_ptr(),
            tokens.data_ptr(), *(t.data_ptr() for t in outs), p.shape[0], c,
            v, d, K, 10, 0.5, stream), case)

    k1_out = {tag: torch.empty(n, device=dev) for tag in libs}
    k2_out = {tag: {case: k2_outputs(x[1], x[4]) for case, x in
                    cases.items()} for tag in libs}
    for tag, lib in libs.items():
        k1(lib, k1_out[tag])()
        for case in cases:
            k2(lib, case, k2_out[tag][case])()
    torch.cuda.synchronize()
    names = ("tok", "pe", "dist", "idx", "w")
    res = {
        "k2_points": {case: x[1].shape[0] for case, x in cases.items()},
        "k2_bit_identical": {
            case: all(torch.equal(a, b) for a, b in
                      zip(k2_out["parent"][case], k2_out["change"][case]))
            for case in cases},
        "k2_max_abs_diff": {
            case: {name: _diff(a, b) for name, a, b in
                   zip(names, k2_out["parent"][case],
                       k2_out["change"][case])} for case in cases},
        "k1_bit_identical": torch.equal(k1_out["parent"], k1_out["change"]),
        "k1_max_abs_diff": _diff(k1_out["parent"], k1_out["change"]),
        "turns": [],
    }
    for tag in ("parent", "change", "change", "parent"):
        turn = {"lib": tag, "k1_ms": _time_ms(k1(libs[tag], k1_out[tag]))}
        for case in cases:
            turn[f"{case}_ms"] = _time_ms(k2(libs[tag], case,
                                             k2_out[tag][case]))
        res["turns"].append(turn)
        print(f"{tag}: " + ", ".join(f"{k} {x:.4f} ms" for k, x in turn.items()
                                     if k != "lib") +
              f" (bare launches; points {res['k2_points']})", flush=True)
    return res


def ab_k4_bf16(libs: dict, dev, fetch: dict) -> dict:
    """K4's bf16 and int8 sampling forms, whose C entries both checkouts
    share, as bare launches of both libraries (the kernel alone: its
    forward through the wrappers, in ``ab_k3_k4``, also pays the host's
    work around it): the bf16 form on seeded bf16 maps at the survivor
    size, the chunk and the painting shape, the int8 form on the seeded
    pixel map quantised (``quantize_feature_map``) with its scale at the
    survivor size and the chunk: bits and times."""
    from ..ops.sampling import quantize_feature_map

    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(dev).manual_seed(3)
    maps = {c: torch.randn((3, *IMAGE, c), device=dev,
                           generator=gen).to(torch.bfloat16)
            for c in (384, 192)}
    q8, scale8 = quantize_feature_map(maps[384].float())
    cases = {"surv": (384, fetch["uv_surv"]), "pixel": (384,
                                                       fetch["uv_chunk"]),
             "paint": (192, fetch["uv_verts"]),
             "int8_surv": (384, fetch["uv_surv"]),
             "int8_pixel": (384, fetch["uv_chunk"])}
    out = {tag: {case: torch.empty((3, uv.shape[1], c), dtype=torch.bfloat16,
                                   device=dev)
                 for case, (c, uv) in cases.items()} for tag in libs}

    def k4(lib, case, o):
        c, uv = cases[case]
        if case.startswith("int8"):
            return lambda: build.check(lib.thp_feature_sample_int8(
                q8.data_ptr(), uv.data_ptr(), o.data_ptr(), 3, uv.shape[1],
                c, IMAGE[0], IMAGE[1], 1.0, 1.0, scale8.data_ptr(), stream),
                case)
        fmap = maps[c]
        return lambda: build.check(lib.thp_feature_sample_bf16(
            fmap.data_ptr(), uv.data_ptr(), o.data_ptr(), 3, uv.shape[1], c,
            IMAGE[0], IMAGE[1], 1.0, 1.0, stream), case)

    for tag, lib in libs.items():
        for case in cases:
            k4(lib, case, out[tag][case])()
    torch.cuda.synchronize()
    res = {"k4_bf16_bit_identical": {
        case: torch.equal(out["parent"][case], out["change"][case])
        for case in cases}, "k4_bf16_turns": []}
    for tag in ("parent", "change", "change", "parent"):
        turn = {"lib": tag}
        for case in cases:
            name = case if case.startswith("int8") else f"bf16_{case}"
            turn[f"k4_{name}_ms"] = _time_ms(k4(libs[tag], case,
                                                out[tag][case]))
        res["k4_bf16_turns"].append(turn)
        print(f"{tag}: " + ", ".join(f"{k} {x:.4f} ms" for k, x in turn.items()
                                     if k != "lib") + " (bare launches)",
              flush=True)
    return res


def ab_k3_k4(parent: str, dev, fetch: dict) -> dict:
    """K4 and K3 through each checkout's wrappers: bits and times."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        inputs = os.path.join(tmp, "inputs.pt")
        torch.save({k: v.cpu() for k, v in fetch.items()}, inputs)
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
    res = {"wrapper_turns": turns, "bit_identical": {}, "max_abs_diff": {},
           "only_in_change": sorted(set(outs["change"]) - set(outs["parent"]))}
    for name in set(outs["change"]) & set(outs["parent"]):
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
    shared = ("thp_min_excess2", "thp_dparf", "thp_dparf_bf16",
              "thp_feature_sample_bf16", "thp_feature_sample_int8",
              "thp_error_string")
    libs = {"parent": _load(build_parent(parent), shared),
            "change": _load(build.build().path, shared)}
    dev = torch.device("cuda")
    fetch = fetch_inputs(dev)
    res = {"card": torch.cuda.get_device_name(0), **ab_k1_k2(libs, dev),
           **ab_k4_bf16(libs, dev, fetch), **ab_k3_k4(parent, dev, fetch)}
    print(f"K2 bit-identical: {res['k2_bit_identical']}; K1 bit-identical: "
          f"{res['k1_bit_identical']}; K4 bf16 and int8 bit-identical (bare): "
          f"{res['k4_bf16_bit_identical']}; K3/K4 bit-identical: "
          f"{res['bit_identical']} (max diffs {res['max_abs_diff']})",
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
