#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's serving path (one NVIDIA GPU).

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in order;
any failure ends the run with a non-zero exit:

1. device: a CUDA card, its name and power limit (nvidia-smi), TF32 off;
2. build: the CUDA kernels from transhuman_tpu_torch/csrc with nvcc;
3. kernels: K1 (cull) and K2 (DPaRF) against their plain PyTorch versions
   on the card at the render path's shapes, with both timed;
4. slice parity: one 64x64 request through RenderService on the card and on
   the CPU (plain versions) with the same full-width weights;
5. serve: the full-width RenderService behind RenderServer on loopback,
   three 512x512 POST /render requests, with the kernels' launch counters
   reset just before and read just after.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Imports only torch, numpy and the port.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch

CULL_DISTANCE = 0.1
N_CHUNK = 32768  # points per decode chunk (Config.chunk_size)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str):
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, by CUDA events over `iters` calls."""
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


def min_dist64(pts, refs, block: int = 4096):
    """Exact (float64) distance from each point to its nearest ref."""
    p, r = pts.double(), refs.double()
    out = torch.empty(p.shape[0], dtype=torch.float64, device=p.device)
    for s in range(0, p.shape[0], block):
        out[s:s + block] = torch.cdist(p[s:s + block], r).min(dim=1).values
    return out


def knn_near_ties(pts, centers, k: int):
    """(N,) bool: some gap among the k+1 nearest squared distances (float64)
    is within 1e-6 relative + 1e-6 absolute.  Below that the kernel's
    difference-form d^2 and the plain version's expanded form
    (|p|^2 + |c|^2 - 2 p.c, rounding ~5e-7 absolute at body scale |p| <= 1 m)
    may rank the two neighbours differently."""
    d2 = torch.cdist(pts.double(), centers.double()) ** 2
    top = torch.topk(d2, min(k + 1, d2.shape[1]), largest=False).values
    gaps = top[:, 1:] - top[:, :-1]
    return (gaps <= 1e-6 * top[:, 1:] + 1e-6).any(dim=1)


# ---------------------------------------------------------------- phases
def phase_device():
    check(torch.cuda.device_count() >= 1, "no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[1 device] {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(smi)
    return smi


def phase_build():
    from transhuman_tpu_torch.kernels import build

    res = build.build()
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    build.library()
    log(f"[2 build] nvcc built {res.path} in {res.seconds:.2f} s")


def phase_kernels(card: str):
    from transhuman_tpu_torch.geometry.clusters import ClusterSpec
    from transhuman_tpu_torch.geometry.smpl import SMPLModel
    from transhuman_tpu_torch.kernels import cull, dparf
    from transhuman_tpu_torch.ops.knn import topk_min, pairwise_dist2

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    smpl = SMPLModel.synthetic()
    verts_np, _, blend = smpl(rng.normal(0, 0.2, 72), np.zeros(10))
    verts = torch.from_numpy(verts_np).to(dev)
    # body-scale sample points: vertices jittered across the 0.1 m shell
    base = verts_np[rng.integers(0, verts_np.shape[0], N_CHUNK)]
    pts_np = base + rng.normal(0, 0.08, base.shape).astype(np.float32)
    pts = torch.from_numpy(pts_np.astype(np.float32)).to(dev)
    results = []

    # K1 -----------------------------------------------------------------
    zeros = torch.zeros(verts.shape[0], device=dev)
    d2_k = cull.min_excess2_cuda(pts, verts, zeros)
    d2_p = cull.min_excess2_plain(pts, verts, zeros)
    torch.cuda.synchronize()
    err = float((d2_k - d2_p).abs().max())
    check(err <= 1e-4, f"K1: max |d2 kernel - plain| = {err} > 1e-4")
    d64 = min_dist64(pts, verts)
    mask_k = d2_k < CULL_DISTANCE**2
    mask_p = torch.sqrt(d2_p) < CULL_DISTANCE
    diff = mask_k != mask_p
    near = (d64 - CULL_DISTANCE).abs() < 1e-5
    check(not bool((diff & ~near).any()),
          f"K1: {int((diff & ~near).sum())} cull decisions differ farther "
          "than 1e-5 from the threshold")
    ms = time_ms(lambda: cull.min_excess2_cuda(pts, verts, zeros))
    plain_ms = time_ms(lambda: cull.min_excess2_plain(pts, verts, zeros))
    log(f"[3 kernels] K1 min_excess2 {N_CHUNK} pts x {verts.shape[0]} verts: "
        f"max|dd2| {err:.3g}, survivors {float(mask_k.float().mean()):.3f}, "
        f"{int(diff.sum())} threshold flips within 1e-5; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms  [{card}]")
    results.append({
        "name": "min_excess2", "route": "cuda",
        "source": "transhuman_tpu_torch/csrc/cull.cu",
        "replaces": "transhuman_tpu/experiments/cull.py:50",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    })

    # K2 -----------------------------------------------------------------
    cluster = ClusterSpec.from_kmeans(smpl.v_template, 300, iters=8)
    pool = torch.from_numpy(cluster.pool_matrix).to(dev)
    centers = (pool @ verts).contiguous()
    rot = torch.einsum("cv,vij->cij", pool,
                       torch.from_numpy(blend[:, :3, :3].copy()).to(dev))
    rot = rot.contiguous()
    tokens = torch.from_numpy(
        rng.standard_normal((3, 300, 192)).astype(np.float32)).to(dev)
    k = 7
    tok_k, pe_k, dist_k = dparf.dparf_cuda(pts, centers, rot, tokens, k)
    tok_p, pe_p, dist_p = dparf.dparf_plain(pts, centers, rot, tokens, k)
    torch.cuda.synchronize()
    ties = knn_near_ties(pts, centers, k)
    ok = ~ties
    tok_err = float((tok_k - tok_p)[:, ok].abs().max())
    pe_err = float((pe_k - pe_p)[ok].abs().max())
    dist_err = float((dist_k - dist_p).abs().max())
    _, idx_p = topk_min(pairwise_dist2(pts, centers), k)
    d_sel = torch.cdist(pts.double(), centers.double()).gather(1, idx_p)
    check(dist_err <= 1e-5, f"K2: max |dist kernel - plain| = {dist_err}")
    check(bool(((dist_k.double() - d_sel).abs() <= 1e-5)[ok].all()),
          "K2: kernel distances are not those of the plain neighbours")
    check(tok_err <= 1e-4, f"K2: tok max err {tok_err} > 1e-4 off ties")
    check(pe_err <= 5e-4, f"K2: pe max err {pe_err} > 5e-4 off ties")
    check(float(ties.float().mean()) < 0.05,
          f"K2: {int(ties.sum())} near-tie points, more than 5%")
    ms = time_ms(lambda: dparf.dparf_cuda(pts, centers, rot, tokens, k))
    plain_ms = time_ms(lambda: dparf.dparf_plain(pts, centers, rot, tokens, k))
    log(f"[3 kernels] K2 dparf {N_CHUNK} pts, C=300, V=3, D=192, k=7: "
        f"tok err {tok_err:.3g}, pe err {pe_err:.3g}, dist err "
        f"{dist_err:.3g}, {int(ties.sum())} near-tie points excluded; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    results.append({
        "name": "dparf", "route": "cuda",
        "source": "transhuman_tpu_torch/csrc/dparf.cu",
        "replaces": "transhuman_tpu/experiments/dparf.py:115",
        "max_abs_err": max(tok_err, pe_err), "ms": ms, "plain_ms": plain_ms,
    })
    return results


def _request(frame, target: int, hw: int, verts=None, blend_rot=None):
    return {
        "images": frame.images.numpy(), "K": frame.K.numpy(),
        "R": frame.R.numpy(), "T": frame.T.numpy(),
        "verts_world": (frame.verts_world.numpy() if verts is None
                        else verts),
        "blend_rot": (frame.blend_rot.numpy() if blend_rot is None
                      else blend_rot),
        "tK": frame.K[target].numpy(), "tR": frame.R[target].numpy(),
        "tT": frame.T[target].numpy(), "H": hw, "W": hw,
    }


def _unstable_pixels(svc, req):
    """Pixels whose ray has a sample within 1e-5 of the cull threshold or a
    kept sample at a kNN near-tie: there the card's kernels and the CPU's
    plain versions may legitimately decide differently."""
    from transhuman_tpu_torch.data.ray_sampling import sample_eval_rays
    from transhuman_tpu_torch.geometry.rays import world_bounds
    from transhuman_tpu_torch.render.pipeline import to_smpl
    from transhuman_tpu_torch.render.volume import sample_along_rays
    from transhuman_tpu_torch.serve import parse_render_request

    pipe = svc.pipe
    frame, (tK, tR, tT), (H, W) = parse_render_request(req, svc.cfg,
                                                       svc.smpl)
    er = sample_eval_rays(None, tK, tR, tT.reshape(3, 1),
                          world_bounds(frame.verts_world.numpy(), False),
                          hw=(H, W))
    frame, rays = frame.to(pipe.device), er.rays.to(pipe.device)
    with torch.no_grad():
        centers = pipe.prologue(frame).centers
        pts, _ = sample_along_rays(rays.ray_o, rays.ray_d, rays.near,
                                   rays.far, pipe.n_samples)
        p = to_smpl(frame, pts.reshape(-1, 3))
        d = min_dist64(p, frame.tar_verts_smpl)
        bad = (d - pipe.cull_distance).abs() < 1e-5
        kept = d < pipe.cull_distance
        bad[kept] |= knn_near_ties(p[kept], centers, pipe.model.knn_k)
    bad_rays = bad.reshape(-1, pipe.n_samples).any(dim=1).cpu().numpy()
    out = np.zeros(H * W, bool)
    out[er.pix_idx[bad_rays]] = True
    return out.reshape(H, W)


def phase_parity(card: str):
    import copy

    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.render.pipeline import RenderPipeline
    from transhuman_tpu_torch.serve import RenderService
    from transhuman_tpu_torch.testing import synthetic_setup

    hw = 64
    cfg = Config().merge_opts(["H", str(2 * hw), "W", str(2 * hw)])
    model, pipe, frame, smpl, cluster = synthetic_setup(
        image_hw=(hw, hw), device="cuda")
    svc_gpu = RenderService(cfg, pipe, smpl)
    model_cpu = copy.deepcopy(model).cpu()
    pipe_cpu = RenderPipeline(model_cpu, cluster, smpl.v_template,
                              n_samples=pipe.n_samples,
                              chunk_rays=pipe.chunk_rays, device="cpu")
    svc_cpu = RenderService(cfg, pipe_cpu, smpl)
    req = _request(frame, 1, hw)
    out_g = svc_gpu.render(req)
    out_c = svc_cpu.render(req)
    skip = _unstable_pixels(svc_gpu, req)
    ok = ~skip
    errs = {k: float(np.abs(out_g[k] - out_c[k])[ok].max())
            for k in ("rgb", "acc", "depth")}
    check(skip.mean() < 0.05, f"parity: {int(skip.sum())} unstable pixels")
    check(errs["rgb"] <= 2e-3 and errs["acc"] <= 2e-3,
          f"parity: rgb/acc CUDA vs CPU {errs} > 2e-3")
    check(errs["depth"] <= 1e-2, f"parity: depth CUDA vs CPU {errs} > 1e-2")
    check(float(out_c["acc"].max()) > 0.5, "parity: the frame is empty")
    log(f"[4 parity] {hw}x{hw} full-width render, CUDA vs CPU: "
        f"max |d rgb| {errs['rgb']:.3g}, |d acc| {errs['acc']:.3g}, "
        f"|d depth| {errs['depth']:.3g} over {int(ok.sum())} pixels "
        f"({int(skip.sum())} at a cull/kNN near-tie excluded)  [{card}]")
    return model, pipe, frame, smpl


def phase_serve(card: str):
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.serve import RenderServer, RenderService
    from transhuman_tpu_torch.testing import synthetic_setup

    hw = 512
    cfg = Config()  # H_render = W_render = 512
    model, pipe, frame, smpl, _ = synthetic_setup(image_hw=(hw, hw),
                                                  device="cuda")
    svc = RenderService(cfg, pipe, smpl)
    svc.warmup(hw, hw)
    server = RenderServer(svc, host="127.0.0.1", port=0)
    server.start()
    rng = np.random.default_rng(1)
    verts2, _, blend2 = smpl(rng.normal(0, 0.2, 72), np.zeros(10))
    reqs = [
        _request(frame, 0, hw),
        _request(frame, 1, hw),
        _request(frame, 2, hw, verts2, np.ascontiguousarray(blend2[:, :3, :3])),
    ]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    lines = []
    try:
        for i, req in enumerate(reqs):
            buf = io.BytesIO()
            np.savez(buf, **req)
            t0 = time.perf_counter()
            resp = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{server.port}/render",
                data=buf.getvalue()), timeout=300)
            body = resp.read()
            lat = (time.perf_counter() - t0) * 1e3
            check(resp.status == 200, f"serve: HTTP {resp.status}")
            out = dict(np.load(io.BytesIO(body)))
            check(out["rgb"].shape == (hw, hw, 3), "serve: rgb shape")
            check(out["acc"].shape == (hw, hw), "serve: acc shape")
            check(out["depth"].shape == (hw, hw), "serve: depth shape")
            check(all(np.isfinite(v).all() for v in out.values()),
                  "serve: non-finite output")
            check(out["acc"].min() >= 0.0 and out["acc"].max() <= 1.0 + 1e-5,
                  "serve: acc outside [0, 1] (+1e-5 f32 rounding)")
            check(out["acc"].max() > 0.5, "serve: no pixel with acc > 0.5")
            st = pipe.last_frame_stats
            lines.append(
                f"[5 serve] request {i}: {hw}x{hw}, latency {lat:.1f} ms, "
                f"{st['points']} points, survivor fraction "
                f"{st['survivors'] / max(st['points'], 1):.4f}  [{card}]")
    finally:
        server.shutdown()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in lines:
        log(line)
    log(f"[5 serve] launches {counts}; peak device memory {peak:.3f} GiB  "
        f"[{card}]")
    for name, n in counts.items():
        check(n > 0, f"serve: kernel {name} was not launched")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing ran", file=sys.stderr)
        return 2
    import transhuman_tpu_torch  # noqa: F401 — fails outside the repo

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    phase_parity(card)
    counts = phase_serve(card)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
