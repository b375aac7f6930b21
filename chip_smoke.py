#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's serving, training and evaluation
paths (one NVIDIA GPU).

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in order;
any failure ends the run with a non-zero exit:

1. device: a CUDA card, its name and power limit (nvidia-smi), TF32 off;
2. build: the CUDA kernels from transhuman_tpu_torch/csrc with nvcc, one
   process per source, all started together;
3. kernels: K1 (cull) and K2 (DPaRF) against their plain PyTorch versions
   on the card at the render path's shapes, K2's token gradient against
   autograd through the plain version, K3 (the feature-fetch backward)
   against its plain version at both train shapes with the ids of a real
   train batch and, with taps +0..+3, against the index_add_ oracle of the
   TPU scatter probe (tools/probe_stream_scatter.py); K4 (the forward
   feature gather) against its plain version and against grid_sample at the
   serve pixel and painting shapes of a real request, in its 1-tap forms at
   the TPU gather probes' shape, and with masked ids; all timed, each beside
   its bound (bytes over 3.35 TB/s or FP32 operations over 67 TFLOP/s);
4. slice parity: one 64x64 request through RenderService on the card and on
   the CPU (plain versions) with the same full-width weights;
5. serve: the full-width RenderService behind RenderServer on loopback,
   three 512x512 POST /render requests, with the kernels' launch counters
   reset just before and read just after;
6. train parity: one full-width train step at 64x64 on the card and on the
   CPU from the same weights, jitter off: loss, gradients, updated weights;
7. train: the train entry point at full width (3 views at 512x512, 2,400
   rays x 64 samples) for 5 steps, with the launch counters reset just
   before and read just after; every parameter the forward reads gets a
   finite gradient and moves, and the checkpoint serves;
8. eval parity: evaluate_frames over 2 frames at 64x64 on the card and on
   the CPU with the same full-width weights: per-frame rgb, PSNR and SSIM;
9. evaluate and visualize: the run entry point at full width (512x512) on
   phase 7's checkpoint, 4 frames evaluated with the launch counters reset
   just before and read just after, then 2 frames visualized; the files
   they write are checked.

The second-to-last line is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  Imports only torch, numpy and the port.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request

import numpy as np
import torch

CULL_DISTANCE = 0.1
N_CHUNK = 32768  # points per decode chunk (Config.chunk_size)
TRAIN_STEPS = 5
EVAL_FRAMES = 4  # of the synthetic scene's 8, at test.frame_interval 2
# the card's published peaks (H100 SXM data sheet): the least time a kernel
# could take is the larger of its bytes over the memory rate and its FP32
# operations over the FP32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the train forward never reads TransHE's token-masking weight (nor does the
# JAX package's): it gets no gradient and does not move
UNREAD_PARAMS = {"ViT.mask_token"}


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


def bound(n_bytes: float, n_ops: float) -> dict:
    """bound_ms and what sets it: bytes (each input read once, each output
    written once) at HBM_BYTES_PER_S, or FP32 operations at
    FP32_OPS_PER_S."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
    # d^2 - b: 3 differences, 3 squares, 2 sums, a subtraction and a min
    # per (point, vertex) pair; no single PyTorch call takes a min over a
    # distance matrix
    results.append({
        "name": "min_excess2", "route": "cuda",
        "source": "transhuman_tpu_torch/csrc/cull.cu",
        "replaces": "transhuman_tpu/experiments/cull.py:50",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes(pts, verts, zeros, d2_k),
                10 * pts.shape[0] * verts.shape[0]),
        "library_ms": None,
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
    tok_k, pe_k, dist_k, idx_k, w_k = dparf.dparf_cuda(pts, centers, rot,
                                                       tokens, k)
    tok_p, pe_p, dist_p, idx_p, w_p = dparf.dparf_plain(pts, centers, rot,
                                                       tokens, k)
    torch.cuda.synchronize()
    ties = knn_near_ties(pts, centers, k)
    ok = ~ties
    tok_err = float((tok_k - tok_p)[:, ok].abs().max())
    pe_err = float((pe_k - pe_p)[ok].abs().max())
    dist_err = float((dist_k - dist_p).abs().max())
    d_sel = torch.cdist(pts.double(), centers.double()).gather(1, idx_p)
    check(dist_err <= 1e-5, f"K2: max |dist kernel - plain| = {dist_err}")
    check(bool(((dist_k.double() - d_sel).abs() <= 1e-5)[ok].all()),
          "K2: kernel distances are not those of the plain neighbours")
    check(tok_err <= 1e-4, f"K2: tok max err {tok_err} > 1e-4 off ties")
    check(bool((idx_k.long() == idx_p)[ok].all()),
          "K2: the neighbour indices differ off ties")
    w_err = float((w_k - w_p)[ok].abs().max())
    check(w_err <= 1e-5, f"K2: weight max err {w_err} > 1e-5 off ties")
    check(pe_err <= 5e-4, f"K2: pe max err {pe_err} > 5e-4 off ties")
    check(float(ties.float().mean()) < 0.05,
          f"K2: {int(ties.sum())} near-tie points, more than 5%")
    ms = time_ms(lambda: dparf.dparf_cuda(pts, centers, rot, tokens, k))
    plain_ms = time_ms(lambda: dparf.dparf_plain(pts, centers, rot, tokens, k))
    log(f"[3 kernels] K2 dparf {N_CHUNK} pts, C=300, V=3, D=192, k=7: "
        f"tok err {tok_err:.3g}, pe err {pe_err:.3g}, dist err "
        f"{dist_err:.3g}, {int(ties.sum())} near-tie points excluded; "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    # operations: 8 per (point, centre) distance, a multiply-add per token
    # channel of each of the k neighbours in each view; no PyTorch call
    # computes the binding
    results.append({
        "name": "dparf", "route": "cuda",
        "source": "transhuman_tpu_torch/csrc/dparf.cu",
        "replaces": "transhuman_tpu/experiments/dparf.py:115",
        "max_abs_err": max(tok_err, pe_err), "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes(pts, centers, rot, tokens, tok_k, pe_k, dist_k, idx_k,
                       w_k),
                8 * pts.shape[0] * centers.shape[0]
                + 2 * k * tokens.numel() // centers.shape[0] * pts.shape[0]),
        "library_ms": None,
    })

    # K2's token gradient and K3, on one full-width train batch -----------
    uv_pix, uv_verts, image, binding = train_batch_projections(dev)
    check_dparf_grad(card, *binding, k)
    k3 = check_dfeat_scatter(card, uv_pix, uv_verts, image)
    k3["t7"] = check_t7_scatter(card)
    results.append(k3)
    # K4 on one full-width request -----------------------------------------
    results.append(check_feature_gather(card))
    return results


def train_batch_projections(dev):
    """What the train step's two feature fetches project, for sample 0 of
    the full-width synthetic train data at step 0's seed, asked of the
    pipeline the train entry point builds (render_train's own helpers):
    (uv (3, 153600, 2) of the ray samples, masked rays collapsed onto one
    texel; uv (3, 6890, 2) of the painted vertices; the image size; the
    samples' SMPL coordinates (N, 3) with the cluster centres and
    rotations)."""
    from transhuman_tpu_torch.cli.train import build_trainer
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.render.pipeline import fold_in, to_smpl

    cfg = Config()
    _, _, data, pipe = build_trainer(cfg, dev)
    smp = data.get_train_sample(0).to(dev)
    f = smp.frame
    pts, _, pts_mask, _ = pipe.train_points(smp.rays, fold_in(cfg.seed, 0),
                                            cfg.perturb > 0)
    pro = pipe.prologue(f)
    return (pipe.fetch_uv(f, pts, pts_mask), pipe.fetch_uv(f, f.verts_world),
            tuple(f.images.shape[1:3]),
            (to_smpl(f, pts).contiguous(), pro.centers, pro.rot))


def check_dparf_grad(card: str, pts, centers, rot, k: int):
    """K2's autograd Function: its token gradient against autograd through
    the plain version, near-tie points given a zero cotangent."""
    from transhuman_tpu_torch.kernels import dparf

    g = torch.randn((3, pts.shape[0], 192), device=pts.device,
                    generator=torch.Generator(pts.device).manual_seed(4))
    ties = knn_near_ties(pts, centers, k)
    g[:, ties] = 0.0
    tokens = torch.randn((3, 300, 192), device=pts.device,
                         generator=torch.Generator(pts.device).manual_seed(5))
    tk = tokens.clone().requires_grad_(True)
    (dparf.dparf(pts, centers, rot, tk, k)[0] * g).sum().backward()
    tp = tokens.clone().requires_grad_(True)
    (dparf.dparf_plain(pts, centers, rot, tp, k)[0] * g).sum().backward()
    torch.cuda.synchronize()
    err = float((tk.grad - tp.grad).abs().max())
    scale = float(tp.grad.abs().max())
    # ~3,600 weighted cotangent rows per centre, summed in two orders with
    # weights from distances formed two ways
    check(err <= 1e-3 + 1e-5 * scale,
          f"K2 backward: max |d tokens| err {err} (max {scale})")
    log(f"[3 kernels] K2 token gradient, {pts.shape[0]} train-batch points: "
        f"max err {err:.3g} of max |d tokens| {scale:.3g}, "
        f"{int(ties.sum())} near-tie points zeroed  [{card}]")


def check_dfeat_scatter(card: str, uv_pix, uv_verts, image):
    """K3 against its plain twin at both train shapes: the pixel fetch
    (3, 512, 512, 384) at 153,600 points and the painting fetch
    (3, 512, 512, 192) at 6,890 vertices; the wrapper (sort + zero-fill +
    kernel) and its parts timed."""
    from transhuman_tpu_torch.kernels import scatter
    from transhuman_tpu_torch.ops.sampling import _sample_taps

    entry = {"name": "dfeat_scatter", "route": "cuda",
             "source": "transhuman_tpu_torch/csrc/scatter.cu",
             "replaces": "transhuman_tpu/experiments/streamscatter.py:172"}
    for tag, uv, c in (("pixel", uv_pix, 384), ("paint", uv_verts, 192)):
        dev = uv.device
        meta = torch.empty((3, image[0], image[1], c), device="meta")
        _, _, base, wx, wy, dx, dy = _sample_taps(meta, uv, image)
        ids = base.to(torch.int32).contiguous()
        w4 = torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                          wx * wy], dim=-1).contiguous()
        g = torch.randn((3, ids.shape[1], c), device=dev,
                        generator=torch.Generator(dev).manual_seed(6))
        hw = image[0] * image[1]
        got = scatter.dfeat_scatter_cuda(ids, g, w4, hw, dx, dy)
        want = scatter.dfeat_scatter_plain(ids, g, w4, hw, dx, dy)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        # float32 sums in another order (atomics: run to run)
        check(err <= 1e-4 + 1e-5 * scale,
              f"K3 {tag}: max err {err} (max |d_feat| {scale})")
        per_texel = ids.numel() / sum(int(torch.unique(i).numel())
                                      for i in ids)
        ms = time_ms(lambda: scatter.dfeat_scatter_cuda(ids, g, w4, hw, dx,
                                                        dy))
        plain_ms = time_ms(lambda: scatter.dfeat_scatter_plain(ids, g, w4, hw,
                                                               dx, dy))
        sort_ms = time_ms(lambda: torch.sort(ids, dim=1, stable=True))
        zero_ms = time_ms(lambda: torch.zeros((3, hw, c), device=dev))
        log(f"[3 kernels] K3 dfeat_scatter {tag}: V=3, N={ids.shape[1]}, "
            f"C={c}, {hw} texels, {per_texel:.2f} rows per touched texel: "
            f"max err {err:.3g} of max {scale:.3g}; wrapper {ms:.4f} ms "
            f"(sort {sort_ms:.4f}, zero-fill {zero_ms:.4f}), plain "
            f"{plain_ms:.4f} ms  [{card}]")
        if tag == "pixel":
            # one index_add_ of the 4N weighted tap rows, formed outside the
            # timed region, into a zeroed map: the same sum with the
            # weighting and the zero-fill left out
            flat4 = torch.cat([(ids.long() + hw * torch.arange(
                3, device=dev)[:, None] + off).reshape(-1)
                for off in (0, dx, dy, dy + dx)])
            rows4 = torch.cat([(g * w4[..., t:t + 1]).reshape(-1, c)
                               for t in range(4)])
            acc = torch.zeros((3 * hw, c), device=dev)
            lib_ms = time_ms(lambda: acc.index_add_(0, flat4, rows4))
            del flat4, rows4, acc
            entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms,
                         **bound(nbytes(ids, g, w4, got), 8 * g.numel()))
            log(f"[3 kernels] K3 library yardstick: one index_add_ of the "
                f"pre-weighted tap rows {lib_ms:.4f} ms; bound "
                f"{entry['bound_ms']:.4f} ms ({entry['bound_by']})  [{card}]")
        else:
            entry.update(paint_ms=ms, paint_plain_ms=plain_ms,
                         paint_bound_ms=bound(nbytes(ids, g, w4, got),
                                              8 * g.numel())["bound_ms"],
                         max_abs_err=max(entry["max_abs_err"], err))
    return entry


def check_t7_scatter(card: str) -> dict:
    """K3 with taps +0..+3 (dx=1, dy=2) at the shape of the TPU scatter
    probe tools/probe_stream_scatter.py (131,072 rows of 384 channels into a
    4,104-row window) against an index_add_ oracle of its formula
    window[id + t] += (0.25 + 0.1 t) row, for 1 and 4 taps."""
    from transhuman_tpu_torch.kernels import scatter

    dev = torch.device("cuda")
    n, c, window = 131072, 384, 4104
    gen = torch.Generator(dev).manual_seed(7)
    ids = torch.randint(0, 4096, (1, n), device=dev, generator=gen,
                        dtype=torch.int32)
    rows = torch.randn((1, n, c), device=dev, generator=gen)
    out = {}
    for taps in (1, 4):
        wt = torch.tensor([0.25 + 0.1 * t if t < taps else 0.0
                           for t in range(4)], device=dev)
        w4 = wt.expand(1, n, 4).contiguous()
        def oracle():
            acc = torch.zeros((window, c), device=dev)
            for t in range(taps):
                acc.index_add_(0, ids[0].long() + t,
                               (0.25 + 0.1 * t) * rows[0])
            return acc

        got = scatter.dfeat_scatter_cuda(ids, rows, w4, window, 1, 2)
        want = oracle()
        torch.cuda.synchronize()
        err = float((got[0] - want).abs().max())
        scale = float(want.abs().max())
        # ~32 rows per window texel per tap, summed in two orders
        check(err <= 1e-4 + 1e-5 * scale,
              f"T7 via K3, {taps} taps: max err {err} (max {scale})")
        ms = time_ms(lambda: scatter.dfeat_scatter_cuda(ids, rows, w4, window,
                                                        1, 2))
        plain_ms = time_ms(oracle)
        # the library call: one index_add_ per tap of rows scaled outside
        # the timed region, into a zeroed window: one call for one tap
        flat = torch.cat([ids[0].long() + t for t in range(taps)])
        scaled = torch.cat([(0.25 + 0.1 * t) * rows[0] for t in range(taps)])
        acc = torch.zeros((window, c), device=dev)
        lib_ms = time_ms(lambda: acc.index_add_(0, flat, scaled))
        out[f"taps{taps}"] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "library_ms": lib_ms,
                              **bound(nbytes(ids, rows, w4, got),
                                      2 * taps * rows.numel())}
        log(f"[3 kernels] T7 by K3 (dx=1, dy=2), {taps} tap(s), N={n}, "
            f"C={c}, window {window}: max err {err:.3g} of max {scale:.3g}; "
            f"wrapper {ms:.4f} ms, oracle {plain_ms:.4f} ms, one index_add_ "
            f"of the scaled rows {lib_ms:.4f} ms, bound "
            f"{out[f'taps{taps}']['bound_ms']:.4f} ms  [{card}]")
    return out


def serve_request_maps(dev):
    """The full-width model's maps for one 512x512 request (target view 1
    of the synthetic scene): (pixel map (3, 512, 512, 384), holder map
    (3, 512, 512, 192), uv (3, N_CHUNK, 2) of N_CHUNK consecutive cull
    survivors from the middle of the request, uv (3, 6890, 2) of the
    painted vertices, image size)."""
    from transhuman_tpu_torch.data.ray_sampling import sample_eval_rays
    from transhuman_tpu_torch.geometry.rays import world_bounds
    from transhuman_tpu_torch.render.pipeline import to_smpl
    from transhuman_tpu_torch.render.volume import sample_along_rays
    from transhuman_tpu_torch.testing import synthetic_setup

    model, pipe, frame, _, _ = synthetic_setup(image_hw=(512, 512),
                                               device=dev)
    er = sample_eval_rays(None, frame.K[1].numpy(), frame.R[1].numpy(),
                          frame.T[1].numpy().reshape(3, 1),
                          world_bounds(frame.verts_world.numpy(), False),
                          hw=(512, 512))
    frame, rays = frame.to(dev), er.rays.to(dev)
    with torch.no_grad():
        holder, pixel = model.encode_views(frame.images)
        pts, _ = sample_along_rays(rays.ray_o, rays.ray_d, rays.near,
                                   rays.far, pipe.n_samples)
        pts = pts.reshape(-1, 3)
        keep = torch.nonzero(pipe._cull(to_smpl(frame, pts),
                                        frame.tar_verts_smpl))[:, 0]
        mid = max(0, keep.numel() // 2 - N_CHUNK // 2)
        chunk = pts[keep[mid:mid + N_CHUNK]]
        return (pixel, holder, pipe.fetch_uv(frame, chunk),
                pipe.fetch_uv(frame, frame.verts_world), (512, 512))


def _unique_rows(ids, offsets) -> int:
    """Distinct source rows the taps of the non-negative ids touch, summed
    over the views: the bytes a gather must read at least once."""
    return sum(int(torch.unique(torch.cat([i[i >= 0] + o for o in offsets]))
                   .numel()) for i in ids)


def check_feature_gather(card: str) -> dict:
    """K4 against its plain version at the serve pixel shape (with and
    without masked ids) and the painting shape of one real request, against
    grid_sample (align_corners, border) on an NCHW copy of the same map,
    and in its 1-tap forms at the TPU gather probes' shape
    (tools/probe_block_gather.py: 262,144 rows of 384, 1,048,576 ids)."""
    import torch.nn.functional as F

    from transhuman_tpu_torch.kernels import build, gather
    from transhuman_tpu_torch.ops.sampling import _bilinear_w4, _sample_taps

    dev = torch.device("cuda")
    pixel, holder, uv_pix, uv_verts, image = serve_request_maps(dev)
    entry = {"name": "feature_gather", "route": "cuda",
             "source": "transhuman_tpu_torch/csrc/gather.cu",
             "replaces": "tools/profile_gather_ab.py:156"}
    for tag, fmap, uv in (("pixel", pixel, uv_pix),
                          ("paint", holder, uv_verts)):
        v, hf, wf, c = fmap.shape
        fx, fy, base, wx, wy, dx, dy = _sample_taps(fmap, uv, image)
        src = fmap.reshape(v, hf * wf, c)
        ids = base.to(torch.int32).contiguous()
        w4 = _bilinear_w4(wx, wy).contiguous()
        offs = (0, dx, dy, dy + dx)
        got = gather.feature_gather_cuda(src, ids, w4, offs)
        want = gather.feature_gather_plain(src, ids, w4, offs)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(src.abs().max())
        # fused multiply-adds against rounded products: a few ulps of |src|
        check(err <= 1e-6 * scale + 1e-7,
              f"K4 {tag}: max err {err} (max |src| {scale})")
        # the library call: grid_sample over an NCHW copy of the map, the
        # grid in its [-1, 1] coordinates; both prepared outside the timing
        nchw = fmap.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([fx / (wf - 1) * 2 - 1, fy / (hf - 1) * 2 - 1],
                           dim=-1)[:, None].contiguous()
        gs = F.grid_sample(nchw, grid, mode="bilinear",
                           padding_mode="border", align_corners=True)
        gs_err = float((gs[:, :, 0].permute(0, 2, 1) - got).abs().max())
        # grid_sample rounds the coordinate through [-1, 1]: ~W 2^-24
        # ~ 3e-5 texel, times a feature step of at most 2 max|src|
        check(gs_err <= 2e-4 * scale,
              f"K4 {tag} vs grid_sample: max err {gs_err} (max {scale})")
        ms = time_ms(lambda: gather.feature_gather_cuda(src, ids, w4, offs))
        # the launch alone, without the wrapper's checks (a reduction and a
        # host sync for the id range)
        raw = torch.empty_like(got)
        lib, stream = build.library(), torch.cuda.current_stream().cuda_stream
        launch_ms = time_ms(lambda: lib.thp_feature_gather(
            src.data_ptr(), ids.data_ptr(), w4.data_ptr(), raw.data_ptr(), v,
            ids.shape[1], c, hf * wf, 4, *offs, stream))
        check(torch.equal(raw, got), f"K4 {tag}: the bare launch differs")
        plain_ms = time_ms(lambda: gather.feature_gather_plain(src, ids, w4,
                                                               offs))
        lib_ms = time_ms(lambda: F.grid_sample(
            nchw, grid, mode="bilinear", padding_mode="border",
            align_corners=True))
        rows = _unique_rows(ids, offs)
        b = bound(rows * c * 4 + nbytes(ids, w4, got), 8 * got.numel())
        log(f"[3 kernels] K4 feature_gather {tag}: V={v}, N={ids.shape[1]}, "
            f"C={c}, {hf}x{wf} map, {rows} distinct tap rows: max err "
            f"{err:.3g}, vs grid_sample {gs_err:.3g} (max |src| "
            f"{scale:.3g}); wrapper {ms:.4f} ms (launch alone "
            f"{launch_ms:.4f}), plain {plain_ms:.4f} ms, "
            f"grid_sample {lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})  [{card}]")
        del nchw, grid, gs
        if tag == "pixel":
            entry.update(max_abs_err=max(err, gs_err), ms=ms,
                         launch_ms=launch_ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **b)
            masked = ids.clone()
            masked[:, ::7] = -1
            got = gather.feature_gather_cuda(src, masked, w4, offs)
            want = gather.feature_gather_plain(src, masked, w4, offs)
            torch.cuda.synchronize()
            m_err = float((got - want).abs().max())
            check(m_err <= 1e-6 * scale + 1e-7 and not got[:, ::7].any(),
                  f"K4 masked ids: max err {m_err}, or a masked row not 0")
            log(f"[3 kernels] K4 with every 7th id -1: max err {m_err:.3g},"
                f" masked rows zero  [{card}]")
        else:
            entry.update(paint_ms=ms, paint_launch_ms=launch_ms,
                         paint_plain_ms=plain_ms,
                         paint_library_ms=lib_ms,
                         paint_bound_ms=b["bound_ms"],
                         max_abs_err=max(entry["max_abs_err"], err, gs_err))
    del pixel, holder

    # the TPU gather probes' 1-tap forms: weighted (block_gather) and
    # plain rows (make_block_gather, gather_a/b/c, attempt)
    gen = torch.Generator(dev).manual_seed(8)
    src = torch.randn((1, 262144, 384), device=dev, generator=gen)
    ids = torch.randint(0, 262144, (1, 1048576), device=dev, generator=gen,
                        dtype=torch.int32)
    for form, w in (("weighted", torch.rand((1, ids.shape[1], 1), device=dev,
                                            generator=gen)),
                    ("rows", torch.ones((1, ids.shape[1], 1), device=dev))):
        got = gather.feature_gather_cuda(src, ids, w, (0,))
        want = gather.feature_gather_plain(src, ids, w, (0,))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err == 0.0, f"K4 1-tap {form}: max err {err}")
        ms = time_ms(lambda: gather.feature_gather_cuda(src, ids, w, (0,)),
                     iters=10)
        plain_ms = time_ms(lambda: gather.feature_gather_plain(src, ids, w,
                                                               (0,)), iters=10)
        lib = ""
        if form == "rows":
            lib_ms = time_ms(lambda: src[0].index_select(0, ids[0]), iters=10)
            lib = f", index_select {lib_ms:.4f} ms"
            entry["rows_library_ms"] = lib_ms
        b = bound(_unique_rows(ids, (0,)) * 384 * 4 + nbytes(ids, w, got),
                  2 * got.numel())
        entry[f"{form}_ms"] = ms
        entry[f"{form}_bound_ms"] = b["bound_ms"]
        log(f"[3 kernels] K4 1-tap {form}: 1,048,576 ids into 262,144 rows "
            f"of 384: max err {err:.3g}; kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms{lib}, bound {b['bound_ms']:.4f} ms  [{card}]")
    return entry


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


def _unstable_rays(pipe, frame, rays):
    """(R,) bool numpy: the ray has a sample within 1e-5 of the cull
    threshold or a kept sample at a kNN near-tie; there the card's kernels
    and the CPU's plain versions may legitimately decide differently.
    frame and rays on the pipeline's device."""
    from transhuman_tpu_torch.render.pipeline import to_smpl
    from transhuman_tpu_torch.render.volume import sample_along_rays

    with torch.no_grad():
        centers = pipe.prologue(frame).centers
        pts, _ = sample_along_rays(rays.ray_o, rays.ray_d, rays.near,
                                   rays.far, pipe.n_samples)
        p = to_smpl(frame, pts.reshape(-1, 3))
        d = min_dist64(p, frame.tar_verts_smpl)
        bad = (d - pipe.cull_distance).abs() < 1e-5
        kept = d < pipe.cull_distance
        bad[kept] |= knn_near_ties(p[kept], centers, pipe.model.knn_k)
    return bad.reshape(-1, pipe.n_samples).any(dim=1).cpu().numpy()


def _unstable_pixels(svc, req):
    """(H, W) bool: the pixels of _unstable_rays for a render request."""
    from transhuman_tpu_torch.data.ray_sampling import sample_eval_rays
    from transhuman_tpu_torch.geometry.rays import world_bounds
    from transhuman_tpu_torch.serve import parse_render_request

    pipe = svc.pipe
    frame, (tK, tR, tT), (H, W) = parse_render_request(req, svc.cfg,
                                                       svc.smpl)
    er = sample_eval_rays(None, tK, tR, tT.reshape(3, 1),
                          world_bounds(frame.verts_world.numpy(), False),
                          hw=(H, W))
    bad_rays = _unstable_rays(pipe, frame.to(pipe.device),
                              er.rays.to(pipe.device))
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
    for name in ("min_excess2", "dparf", "feature_gather"):
        check(counts[name] > 0, f"serve: kernel {name} was not launched")
    check(counts["dfeat_scatter"] == 0, "serve: a backward kernel ran")
    return counts


def _grads_and_update(state, p0):
    return ({n: p.grad.detach().cpu() for n, p in
             state.model.named_parameters() if p.grad is not None},
            {n: p.detach().cpu() - p0[n] for n, p in
             state.model.named_parameters()})


def phase_train_parity(card: str):
    """One train step at 64x64 (full-width model, 2 patches of 10x10 rays x
    64 samples, jitter off) on the card and on the CPU from the same
    seeded weights and sample."""
    from transhuman_tpu_torch.cli.train import build_trainer
    from transhuman_tpu_torch.config import Config

    cfg = Config().merge_opts(["H", "128", "W", "128", "perturb", "0",
                               "patch.N_patches", "2", "patch.size", "10"])
    runs = {}
    for dev in ("cuda", "cpu"):
        state, step_fn, data, _ = build_trainer(cfg, torch.device(dev))
        p0 = {n: p.detach().cpu().clone()
              for n, p in state.model.named_parameters()}
        stats = step_fn(state, data.get_train_sample(0).to(dev), 0)
        runs[dev] = (stats, p0, *_grads_and_update(state, p0))
    (sg, p0g, gg, dg), (sc, p0c, gc, dc) = runs["cuda"], runs["cpu"]
    check(all(torch.equal(p0g[n], p0c[n]) for n in p0c),
          "train parity: the two runs start from different weights")
    lerr = abs(sg["loss"] - sc["loss"]) / sc["loss"]
    # float32 on both; sums in other orders, K2/K3 vs the plain versions
    check(lerr <= 1e-4, f"train parity: loss {sg['loss']} vs {sc['loss']}")
    check(set(gg) == set(gc) == set(p0c) - UNREAD_PARAMS,
          "train parity: the parameters with a gradient differ")
    # per leaf, relative to its norm, with a floor of 1e-5 of the largest
    # leaf's norm: some leaves' gradients vanish in exact arithmetic (the
    # pixel keys' bias: a constant shift of every key under the softmax over
    # the keys) and hold float32 noise that differs between the two devices
    gmax = max(float(gc[n].norm()) for n in gc)
    rel = sorted(((float((gg[n] - gc[n]).norm())
                   / (1e-3 * float(gc[n].norm()) + 1e-5 * gmax), n)
                  for n in gc), reverse=True)
    gerr = max(float((gg[n] - gc[n]).norm() / gc[n].norm()) for n in gc
               if float(gc[n].norm()) > 1e-5 * gmax)
    check(rel[0][0] <= 1.0, f"train parity: gradients differ beyond "
          f"tolerance: {rel[:3]} (error / tolerance, leaf)")
    lr = sc["lr"]
    worst_tight = worst = 0.0
    for n in gc:
        d = (dg[n] - dc[n]).abs()
        slack = 2 * lr * 1e-3 + 2 * torch.finfo(torch.float32).eps * (
            p0c[n].abs() + 1)
        # Adam's first update is -lr g / (|g| + 1e-8): +-lr wherever the
        # sign of g is sure; elsewhere anywhere in [-lr, lr]
        sure = (gc[n].abs() > 1e-6) & ((gg[n] - gc[n]).abs()
                                       < 0.5 * gc[n].abs())
        worst_tight = max(worst_tight, float((d - slack)[sure].max()
                                             if sure.any() else 0.0))
        worst = max(worst, float((d - slack).max()))
    check(worst_tight <= 0.01 * lr and worst <= 2 * lr,
          f"train parity: updates differ by {worst_tight} (sure sign) / "
          f"{worst} (all) at lr {lr}")
    log(f"[6 train parity] 64x64 full-width step, CUDA vs CPU: loss "
        f"{sg['loss']:.7g} vs {sc['loss']:.7g} (rel {lerr:.3g}); max "
        f"gradient err {gerr:.3g} of its leaf's norm (leaves above the "
        f"floor); worst error/tolerance {rel[0][0]:.3g} ({rel[0][1]}); "
        f"update err beyond rounding "
        f"{worst_tight:.3g} where the sign is sure, {worst:.3g} anywhere, "
        f"lr {lr:.4g}  [{card}]")


def phase_train(card: str, path: str):
    """The train entry point at full width for TRAIN_STEPS steps, counters
    reset just before; then its checkpoint (written to path, which phase 9
    evaluates) served at 64x64."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.models.network import TransHumanNet
    from transhuman_tpu_torch.serve import RenderService
    from transhuman_tpu_torch.testing import init_weights, synthetic_scene
    from transhuman_tpu_torch.weights import load_checkpoint_file

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, records = train_cli.main(["--device", "cuda", "--steps",
                                     str(TRAIN_STEPS), "--out", path])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(r["loss"]) for r in records),
          "train: a loss is not finite")
    cfg = Config()
    init = init_weights(TransHumanNet.from_config(cfg),
                        torch.Generator().manual_seed(cfg.seed))
    init = dict(init.named_parameters())
    for n, p in state.model.named_parameters():
        if n in UNREAD_PARAMS:
            continue
        check(p.grad is not None, f"train: {n} got no gradient")
        check(bool(torch.isfinite(p.grad).all()),
              f"train: {n} has a non-finite gradient")
        check(not torch.equal(p.detach().cpu(), init[n].detach()),
              f"train: {n} did not move")
    check(counts["dparf"] >= TRAIN_STEPS and
          counts["dfeat_scatter"] >= 2 * TRAIN_STEPS and
          counts["feature_gather"] >= 2 * TRAIN_STEPS,
          f"train: K2 / K3 / K4 not launched on every step: {counts}")
    # the checkpoint serves
    scfg = Config().merge_opts(["H", "128", "W", "128"])
    model, pipe, smpl, _ = build_runtime(scfg, "cuda")
    load_checkpoint_file(model, path)
    frame, _, _ = synthetic_scene(image_hw=(64, 64))
    out = RenderService(scfg, pipe, smpl).render(_request(frame, 1, 64))
    check(all(np.isfinite(v).all() for v in out.values()),
          "train: the trained checkpoint renders non-finite values")
    times = [r["step_s"] * 1e3 for r in records]
    for r in records:
        log(f"[7 train] step {r['step']}: loss {r['loss']:.6f}, lr "
            f"{r['lr']:.4g}, {r['step_s'] * 1e3:.1f} ms (data "
            f"{r['data_s'] * 1e3:.1f} ms)  [{card}]")
    log(f"[7 train] full width, 3 views 512x512, 2400 rays x 64 samples: "
        f"median step {float(np.median(times[1:])):.1f} ms over steps "
        f"1-{len(times) - 1}; launches {counts}; peak device memory "
        f"{peak:.3f} GiB; checkpoint served at 64x64  [{card}]")
    return counts


def phase_eval_parity(card: str):
    """evaluate_frames over 2 frames of the synthetic scene at 64x64 with
    the full-width model, on the card and on the CPU (plain versions), the
    same seeded weights: per-frame rgb and metrics."""
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.cli.run import evaluate_frames
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset
    from transhuman_tpu_torch.evals.evaluator import Evaluator
    from transhuman_tpu_torch.testing import init_weights

    cfg = Config().merge_opts(["H", "128", "W", "128",
                               "test.frame_interval", "4"])
    data = SyntheticDataset(cfg, "test", image_hw=(64, 64))
    runs = {}
    for dev in ("cuda", "cpu"):
        model, pipe, _, _ = build_runtime(cfg, torch.device(dev),
                                          smpl=data.smpl)
        init_weights(model, torch.Generator().manual_seed(cfg.seed))
        ev = Evaluator(tempfile.mkdtemp(prefix="thp_smoke_"),
                       save_images=False)
        frames = []

        def keep(item, out):
            frames.append((item.frame_index, out["rgb_map"], ev.psnr[-1],
                           ev.ssim[-1]))
            return {}

        try:
            evaluate_frames(cfg, pipe, data, ev, keep, tag=f"{dev} ")
        finally:
            shutil.rmtree(ev.result_dir, ignore_errors=True)
        runs[dev] = (frames, pipe)
    (fg, pipe_g), (fc, _) = runs["cuda"], runs["cpu"]
    check(len(fg) == len(fc) == 2, f"eval parity: {len(fg)} / {len(fc)} "
          "frames, want 2")
    for (i, rgb_g, psnr_g, ssim_g), (_, rgb_c, psnr_c, ssim_c) in zip(fg, fc):
        item = data.get_eval_item(i)
        bad = _unstable_rays(pipe_g, item.frame.to("cuda"),
                             item.eval_rays.rays.to("cuda"))
        err = float(np.abs(rgb_g - rgb_c)[~bad].max())
        d_psnr, d_ssim = abs(psnr_g - psnr_c), abs(ssim_g - ssim_c)
        # phase 4's rgb limit, 2e-3 off cull/kNN near-ties.  Near-ties are
        # counted among the rays compared (those in the body box), where
        # the synthetic body puts 86 of 799 (10.8%); fewer than 15% may be
        # excluded.  PSNR and SSIM take every ray: 2e-3 on each colour moves
        # an MSE of ~0.1 by <= 2e-3 * 2 * 0.3 (the mean |error|) + 4e-6,
        # ~0.05 dB; SSIM's windows move by the same order, so 2e-3
        check(bad.mean() < 0.15,
              f"eval parity f{i}: {int(bad.sum())} of {bad.size} rays at a "
              "near-tie, 15% or more")
        check(err <= 2e-3, f"eval parity f{i}: max |d rgb| {err} > 2e-3")
        check(d_psnr <= 0.05 and d_ssim <= 2e-3,
              f"eval parity f{i}: |d psnr| {d_psnr}, |d ssim| {d_ssim}")
        log(f"[8 eval parity] 64x64 full-width frame {i}, CUDA vs CPU: max "
            f"|d rgb| {err:.3g} over {int((~bad).sum())} rays "
            f"({int(bad.sum())} of {bad.size}, {100 * bad.mean():.1f}%, at a "
            f"near-tie excluded); psnr {psnr_g:.6f} "
            f"vs {psnr_c:.6f}, ssim {ssim_g:.6f} vs {ssim_c:.6f}  [{card}]")


def phase_eval(card: str, ckpt: str, tmp: str):
    """The run entry point at full width on the train phase's checkpoint:
    --type evaluate over EVAL_FRAMES frames at 512x512 (counters reset just
    before, read just after), then --type visualize over 2 frames; the
    files they write are checked."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset

    res = os.path.join(tmp, "result")
    opts = ["result_dir", res, "test.frame_interval",
            str(8 // EVAL_FRAMES)]
    cfg = Config().merge_opts(opts)
    data = SyntheticDataset(cfg, "test", image_hw=(512, 512))
    ray_ms = []
    for i in range(3):
        t0 = time.perf_counter()
        n_rays = data.get_eval_item(i).eval_rays.pix_idx.size
        ray_ms.append((time.perf_counter() - t0) * 1e3)
    stamps, render_ms = [], []

    def stamp(item, out):
        stamps.append(time.perf_counter())
        return {}

    # each frame's render, synchronised on both sides (render_frame syncs
    # on every chunk's compaction anyway)
    dispatch = run_cli.FrameRenderer.dispatch

    def timed_dispatch(self, frame, eval_rays):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dispatch(self, frame, eval_rays)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t) * 1e3)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    run_cli.FrameRenderer.dispatch = timed_dispatch
    t0 = time.perf_counter()
    try:
        summary = run_cli.main(["--type", "evaluate", "--device", "cuda",
                                "--weights", ckpt, *opts], dataset=data,
                               per_frame=stamp)
    finally:
        run_cli.FrameRenderer.dispatch = dispatch
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(stamps) == EVAL_FRAMES, f"evaluate: {len(stamps)} frames")
    check(np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"]),
          f"evaluate: summary {summary}")
    for name in ("min_excess2", "dparf", "feature_gather"):
        check(counts[name] > 0, f"evaluate: kernel {name} was not launched")
    check(counts["dfeat_scatter"] == 0, "evaluate: a backward kernel ran")
    out_dir = os.path.join(res, "epoch_-1", "debug")
    files = {os.path.relpath(os.path.join(d, f), out_dir)
             for d, _, fs in os.walk(out_dir) for f in fs}
    want = ({"summary.txt"} | {f"{m}.npy" for m in
                               ("mse", "psnr", "ssim", "lpips")}
            | {f"synthetic/{k}/frame{i}_view0{s}.png"
               for i in range(0, 8, 8 // EVAL_FRAMES)
               for k, s in (("pred", ""), ("gt", "_gt"))})
    check(want <= files, f"evaluate: missing {sorted(want - files)}")
    with open(os.path.join(out_dir, "summary.txt")) as f:
        text = f.read()
    check("lpips: n/a" in text and "ssim(data_range=1.0)" in text,
          f"evaluate: summary.txt {text!r}")
    # between two frames' metrics lie one render and one frame's host
    # work; after the last render only the host work is left
    cadence = np.diff(stamps)[:-1] * 1e3
    log(f"[9 evaluate] full width, {EVAL_FRAMES} frames of 512x512 "
        f"({n_rays} rays x 64 samples each): psnr "
        f"{summary['psnr']:.4f}, ssim {summary['ssim']:.4f}; render "
        f"{', '.join(f'{x:.1f}' for x in render_ms)} ms per frame; "
        f"frame to frame in the loop "
        f"{', '.join(f'{x:.1f}' for x in cadence)} ms; whole entry point "
        f"{wall:.1f} s (model build and the first frame included); host "
        f"eval rays {', '.join(f'{x:.1f}' for x in ray_ms)} ms per frame; "
        f"launches {counts}; peak device memory {peak:.3f} GiB; "
        f"{len(files)} files written  [{card}]")

    gather_ab(card, cfg, data, ckpt)

    vis_data = SyntheticDataset(cfg, "test", n_frames=2,
                                image_hw=(512, 512))
    paths = run_cli.main(["--type", "visualize", "--device", "cuda",
                          "--weights", ckpt, *opts], dataset=vis_data)
    check(len(paths) == 2, f"visualize: {len(paths)} frames")
    for path in paths:
        with open(path, "rb") as f:
            head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n"
              and head[16:24] == (512).to_bytes(4, "big") * 2,
              f"visualize: {path} is not a 512x512 PNG")
    log(f"[9 visualize] {len(paths)} frames written: "
        f"{', '.join(os.path.relpath(p, res) for p in paths)}  [{card}]")
    return counts


def gather_ab(card: str, cfg, data, ckpt: str):
    """One 512x512 eval frame rendered with the sampling forward through K4
    and through its plain twin on the card, in turns (plain, K4, K4, plain),
    synchronised: what K4 moves end to end.  Outside the counted run."""
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.kernels import gather
    from transhuman_tpu_torch.weights import load_checkpoint_file

    model, pipe, _, _ = build_runtime(cfg, torch.device("cuda"),
                                      smpl=data.smpl)
    load_checkpoint_file(model, ckpt)
    item = data.get_eval_item(0)
    frame, rays = item.frame.to("cuda"), item.eval_rays.rays.to("cuda")
    kernel = gather.feature_gather

    def plain(src, ids, w, offsets):
        return gather.feature_gather_plain(src, ids, w, offsets)

    def render(fn):
        gather.feature_gather = fn
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.render_frame(frame, rays)
            torch.cuda.synchronize()
            return (time.perf_counter() - t) * 1e3, out["rgb_map"]
        finally:
            gather.feature_gather = kernel

    render(kernel)  # warm-up
    times = {"plain": [], "K4": []}
    for tag, fn in (("plain", plain), ("K4", kernel), ("K4", kernel),
                    ("plain", plain)):
        ms, rgb = render(fn)
        times[tag].append(ms)
        if tag == "plain":
            rgb_plain = rgb
        else:
            rgb_k4 = rgb
    err = float((rgb_plain - rgb_k4).abs().max())
    check(err <= 2e-3, f"gather A/B: the two renders differ by {err}")
    log(f"[9 evaluate] one 512x512 frame, render ms with the forward gather "
        f"plain {times['plain'][0]:.1f}, K4 {times['K4'][0]:.1f}, K4 "
        f"{times['K4'][1]:.1f}, plain {times['plain'][1]:.1f} (in that "
        f"order); max |d rgb| {err:.3g}  [{card}]")
    del model, pipe


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
    serve_counts = phase_serve(card)
    phase_train_parity(card)
    tmp = tempfile.mkdtemp(prefix="thp_smoke_")
    try:
        ckpt = os.path.join(tmp, "latest.pth")
        train_counts = phase_train(card, ckpt)
        phase_eval_parity(card)
        eval_counts = phase_eval(card, ckpt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    by_path = {"serve": serve_counts, "train": train_counts,
               "eval": eval_counts}
    for k in kernels:
        # launches: the count of this slice's path, evaluate, for the render
        # kernels; K3 runs on the train path only
        name = k["name"]
        k["launches"] = (train_counts if name == "dfeat_scatter"
                         else eval_counts)[name]
        k["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
