#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's serving, training, evaluation and
mesh reconstruction paths (one NVIDIA GPU).

Run from the repository root: ``python3 chip_smoke.py``.  Phases, in order;
any failure ends the run with a non-zero exit:

1. device: a CUDA card, its name and power limit (nvidia-smi), TF32 off,
   bf16 products accumulated in float32;
2. build: the CUDA kernels from transhuman_tpu_torch/csrc with nvcc, one
   process per source, all started together, and the host C++ libraries
   of transhuman_tpu_torch/native with g++ beside them;
3. kernels: K1 (cull) and K2 (DPaRF) against their plain PyTorch versions
   on the card at the render path's shapes, K2 timed also at the train
   shape (every point of a train batch), K2's token gradient against
   autograd through the plain version, K3 (the feature-fetch backward)
   against its plain version and a zero-fill + index_add_ at both train
   shapes with the ids of a real train batch, and two calls for the same
   bits, and, with taps +0..+3, against the index_add_ oracle of the TPU
   scatter probe (tools/probe_stream_scatter.py); K4 (the forward feature
   fetch) in its sampling form (uv in) against its plain twin, against its
   id form (bits) and against grid_sample at the serve pixel and painting
   shapes of a real request, the whole sample_feature_map forward, the id
   form with masked ids, and its 1-tap forms at the TPU gather probes'
   shape; all timed, each beside its bound (bytes over 3.35 TB/s or FP32
   operations over 67 TFLOP/s);
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
   they write are checked;
10. reconstruction parity: extract_mesh at 0.04 m voxels on the card and on
   the CPU with the same full-width weights: sigma off cull/kNN near-ties
   within 1e-4, beside what that bound reads with a fetch half a pixel off
   and with one neighbour fewer bound (both must exceed it), and both
   meshes at an iso-level no sigma lies near;
11. reconstruction and light_stage: the sigma pass's host syncs counted (at
   most the compaction's one), K1 over the whole 0.005 m grid (121 x 361 x
   121 points) in one launch against its plain version and timed beside
   its bound; then the run entry point at full width on phase 7's
   checkpoint, one mesh at that grid with the launch counters reset just
   before and read just after, the sigma pass, the marching and the PLY
   write timed apart; then the mesh voxelized;
12. bf16 parity (compute_dtype bfloat16): phases 4, 6 and 8 in bf16, card
   against CPU at the stated bf16 bounds, each also nearer the CPU's bf16,
   on average, than the CPU's float32 result of phases 4, 6 and 8 is;
13. bf16 at full width: the serve (3 requests), train (5 steps), evaluate
   (4 frames) and reconstruction entry points in bf16, each with the launch
   counters reset just before and read just after (the bf16 forms of K2,
   K4 and K3 launched, their float32 forms not), each timed, with its peak
   memory.

Phase 3 also holds the bf16 forms of K2, K4 and K3 against their float32
forms on the widened inputs, cast once (bit for bit), and against their
plain twins, timed beside their bf16 bounds.

Then the config files, LPIPS and the train loop's lifecycle, with seeded
random stand-ins for the user's LPIPS and ResNet-18 npz files:

a. LPIPS at full VGG16 widths on the card against the CPU (the distance
   within 1e-4 relative; the input gradient within 1e-4 of its norm at
   the 6 x 20 x 20 train patches, and at phase 9's eval crop as near the
   float64 gradient as the CPU's float32 is), timed;
b. the train entry point from --cfg_file configs/train_or_eval.yaml at full
   width with LPIPS and the pretrained encoder, in bf16 (as the file says)
   and in float32: 2 epochs of 3 steps, counters reset just before and read
   just after, latest.pth / 0.pth / 1.pth written, lpips_loss in every
   step, the encoder's first convolution the npz's before the first step,
   1.pth the trained state bit for bit, a second call resuming at epoch 2
   with the step and lr carried, then --test;
c. the run entry point from the files on b's checkpoint directory:
   --type evaluate (train_or_eval.yaml) with and without the LPIPS column,
   --type visualize (performance.yaml, 2 frames), --type reconstruction
   (reconstruction.yaml), each with the counters reset and read;
d. phase 6 and 12's train parity with LPIPS in the loss (2 patches of
   16 x 16), within their bounds.

Then the ZJU-MoCap loader, on humans this script lays out in a temporary
directory in the reference's layout (23 cameras, D non-zero on most,
frames hard-linked to the committed 1024x1024 fixture JPEGs, masks from the
synthetic body's projection, visibility files for half the cameras):

e. the port's JPEG/PNG codec, built with g++, on each committed fixture:
   its bytes against the sha256 of cv2's or imageio's decode in
   tests/fixtures/torch_zju/digests.json; each decode timed;
f. the train entry point from configs/train_or_eval.yaml with dataset zju
   (CoreView_377, the catalog's 10 frames) in bf16 and float32, and with
   dataset synthetic in bf16, counters reset and read around each: every
   step's data_s (the wait on the prefetch queue) and sample_s (the host
   sample), the step medians; one sample's host ms by stage; one step with
   patch.use_patch_sampling False and one with rot_ratio 1.0;
g. the run entry point with dataset zju (CoreView_387, 2 frames) on f's
   bf16 checkpoint: --type evaluate (train_or_eval.yaml; get_eval_item's
   host ms, the loop's wait for it, frame to frame, the metrics files),
   visualize (performance.yaml), reconstruction (reconstruction.yaml), each
   with its counters; then a ZJU eval item at 64x64 on the card against
   the CPU within phase 8's bounds;
i. visibility from depth maps (depth_map True, depth_vizmap True): depth
   maps z-buffered from the synthetic body for g's CoreView_387 and f's
   CoreView_377; each 64x64 eval item's visibility masks on the card
   against the CPU (equal off a 1e-5 m near-tie band; the visible fraction
   and the band's count printed), the item's frames within phase 8's
   bounds; then at full width --type evaluate, --type visualize and one
   train step (train.cull True), counters reset and read around each: K1,
   K2 and K4 launched on each, K3 in the step.

Every visualize run (phases 9, c, g, i) also writes one MJPG/AVI per
human, parsed here: one JPEG frame per PNG.  Phase 11 also times the C++
marching the command took against the numpy route on the same cube (the
same sorted vertex set within 1e-6 grid units, the same triangle count),
runs the command once more on the numpy route, and renders a 4-frame mesh
video of its PLY (tools/render_mesh_video), timed.

The last three lines are {"kernels": [...]}, the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.
Imports only torch, numpy and the port.
"""

from __future__ import annotations

import dataclasses
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
RECON_VOXEL = 0.005  # Config.voxel_size: 121 x 361 x 121 grid points
RECON_PARITY_VOXEL = 0.04  # ~12k grid points, decoded on the CPU too
# max |d sigma| of the card against the CPU at that grid: the CPU test's
# bound against the JAX package.  Not relative to sigma: the init's sigma is
# its constant density bias of 10 give or take 0.8, and a bound on that
# scale would pass a fetch or binding that moves sigma by 3% of its spread
RECON_SIGMA_TOL = 1e-4
# the card's published peaks (H100 SXM data sheet): the least time a kernel
# could take is the larger of its bytes over the memory rate and its FP32
# operations over the FP32 rate
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# the train forward never reads TransHE's token-masking weight (nor does the
# JAX package's): it gets no gradient and does not move
UNREAD_PARAMS = {"ViT.mask_token"}
# bf16 parity, card against CPU (both bf16, the same weights), set before
# the first card run: two bf16 implementations round differently where
# their float32 sums (cuBLAS/cuDNN and the CPU's) straddle a rounding
# boundary.  On the CPU the port's bf16 64x64 full-width render differs from
# the JAX package's bf16 by up to 2.8e-3 rgb, 8.3e-4 acc, 2.0e-3 depth,
# where bf16 differs from float32 by 6.0e-3 / 1.4e-3 / 3.5e-3; the bounds
# are ~3.5x the first.  What tells bf16 from float32 is the mean check: the
# card's bf16 must lie nearer the CPU's bf16, on average, than the CPU's
# float32 does (_closer).
BF16_RGB_TOL, BF16_DEPTH_TOL = 1e-2, 2e-2
BF16_PSNR_TOL = 0.1  # dB: what 1e-2 per colour allows an MSE of ~0.1
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_TOL = 0.25  # of the largest leaf's norm, per leaf
COMPUTE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def forms(dtype: str) -> dict:
    """The launch counters of the K2, K4 and K3 forms a path in the compute
    dtype runs (K1 is float32 in both)."""
    if dtype == "bfloat16":
        return {"dparf": "dparf_bf16", "fetch": "feature_sample_bf16",
                "scatter": "dfeat_scatter_bf16"}
    return {"dparf": "dparf", "fetch": "feature_gather",
            "scatter": "dfeat_scatter"}


def check_launches(what: str, counts: dict, want: dict):
    """Each kernel in want launched at least want[name] times; every other
    kernel (the other dtype's forms included) not at all."""
    for name, n in counts.items():
        if name in want:
            check(n >= want[name], f"{what}: kernel {name} launched {n} "
                  f"times, want >= {want[name]} ({counts})")
        else:
            check(n == 0, f"{what}: kernel {name} ran ({counts})")


def _closer(what: str, got, want, other):
    """mean |got - want| < mean |want - other|: the card's bf16 lies nearer
    the CPU's bf16 than the CPU's float32 does."""
    err = float(np.abs(got - want).mean())
    gap = float(np.abs(want - other).mean())
    check(err < gap, f"{what}: mean |card - CPU| {err:.3g} is not below "
          f"mean |CPU bf16 - CPU float32| {gap:.3g}")
    return err, gap


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


def avi_frames(path: str) -> list:
    """The JPEG payloads of an MJPG/AVI file, in order, after checking its
    RIFF size, the avih and strh frame counts and that idx1 lists every
    frame at its offset from the movi fourcc."""
    import struct

    with open(path, "rb") as f:
        buf = f.read()
    check(buf[:4] == b"RIFF" and buf[8:12] == b"AVI "
          and struct.unpack("<I", buf[4:8])[0] == len(buf) - 8,
          f"{path}: not a RIFF AVI of its own length")
    chunks, off = {}, 12
    while off + 8 <= len(buf):
        fcc, size = buf[off:off + 4], struct.unpack("<I", buf[off + 4:
                                                            off + 8])[0]
        key = buf[off + 8:off + 12] if fcc == b"LIST" else fcc
        chunks[key] = (off + 8, size)
        off += 8 + size + (size & 1)
    check(off == len(buf) and {b"hdrl", b"movi", b"idx1"} <= set(chunks),
          f"{path}: chunks {sorted(chunks)} end at {off} of {len(buf)}")
    movi, msize = chunks[b"movi"]
    frames, pos = [], movi + 4
    while pos < movi + msize:
        n = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
        check(buf[pos:pos + 4] == b"00dc", f"{path}: a chunk in movi is "
              f"{buf[pos:pos + 4]!r}")
        frames.append((pos - movi, buf[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    istart, isize = chunks[b"idx1"]
    idx = [struct.unpack("<4sIII", buf[istart + 16 * i:istart + 16 * i + 16])
           for i in range(isize // 16)]
    hdrl = chunks[b"hdrl"][0] + 4
    total = struct.unpack("<I", buf[hdrl + 8 + 16:hdrl + 8 + 20])[0]
    check(total == len(idx) == len(frames)
          and all(e[2] == o and e[3] == len(j)
                  for e, (o, j) in zip(idx, frames))
          and all(j[:2] == b"\xff\xd8" and j[-2:] == b"\xff\xd9"
                  for _, j in frames),
          f"{path}: avih {total}, idx1 {len(idx)}, movi {len(frames)} "
          "frames, or an entry that is not its frame's JPEG")
    return [j for _, j in frames]


def check_videos(what: str, png_paths) -> dict:
    """Each human's <perform>/<human>.avi beside its PNG frames: one JPEG
    frame per PNG, each decoding (the port's decoder) to the PNG's size.
    Returns {avi path: (frames, bytes)}."""
    from transhuman_tpu_torch.data.image_io import decode_jpeg

    out = {}
    for d in sorted({os.path.dirname(p) for p in png_paths}):
        path = d + ".avi"
        check(os.path.isfile(path), f"{what}: no {path}")
        pngs = [f for f in os.listdir(d) if f.endswith(".png")]
        jpgs = avi_frames(path)
        with open(os.path.join(d, pngs[0]), "rb") as f:
            head = f.read(24)
        w, h = (int.from_bytes(head[16:20], "big"),
                int.from_bytes(head[20:24], "big"))
        check(len(jpgs) == len(pngs) > 0
              and decode_jpeg(jpgs[-1]).shape == (h, w, 3),
              f"{what}: {path} holds {len(jpgs)} frames for {len(pngs)} "
              f"PNGs of {w}x{h}")
        out[path] = (len(jpgs), os.path.getsize(path))
    return out


def timed_videos(stages: list):
    """A context that times viz.video.frames_to_video (the visualize entry
    point's video assembly), appending (seconds, frames) to stages."""
    import contextlib

    from transhuman_tpu_torch.viz import video

    fn = video.frames_to_video

    def wrapper(frame_dir, out_path, fps=30):
        t = time.perf_counter()
        path = fn(frame_dir, out_path, fps)
        n = sum(f.endswith(".png") for f in os.listdir(frame_dir))
        stages.append((time.perf_counter() - t, n))
        return path

    @contextlib.contextmanager
    def ctx():
        video.frames_to_video = wrapper
        try:
            yield
        finally:
            video.frames_to_video = fn

    return ctx()


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
    # full float32 products and convolutions; bf16 products accumulated in
    # float32, as XLA does (the entry points' configure_device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
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
    """The CUDA kernels (nvcc, one process per source) and, beside them on
    threads, the host C++ libraries (g++, one process per library), so
    that no later phase's timing holds a build."""
    from concurrent.futures import ThreadPoolExecutor

    from transhuman_tpu_torch.kernels import build
    from transhuman_tpu_torch.native import build as native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(native.LIBRARIES)) as pool:
        hosts = [pool.submit(native.build, name)
                 for name in native.LIBRARIES]
        res = build.build()
        for h in hosts:
            h.result()
    for name in native.LIBRARIES:
        native.library(name)
    for line in res.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    build.library()
    log(f"[2 build] nvcc built {res.path} in {res.seconds:.2f} s; g++ built "
        f"{', '.join(sorted(native.LIBRARIES))} beside it; "
        f"{time.perf_counter() - t0:.2f} s in all")


def phase_kernels(card: str):
    from transhuman_tpu_torch.kernels import cull, dparf
    from transhuman_tpu_torch.tools.kernel_ab import phase3_inputs

    dev = torch.device("cuda")
    # body-scale sample points (vertices jittered across the 0.1 m shell),
    # the clusters pooled from that pose, random tokens
    pts, verts, centers, rot, tokens = phase3_inputs(dev, N_CHUNK)
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
    # the least work of d^2 - b per (point, vertex) pair is the expanded
    # form's 3 multiply-adds and a min, 7 operations (|p|^2 and |r|^2 - b
    # once per point and vertex); no single PyTorch call takes a min over a
    # distance matrix
    results.append({
        "name": "min_excess2", "route": "cuda",
        "source": "transhuman_tpu_torch/csrc/cull.cu",
        "replaces": "transhuman_tpu/experiments/cull.py:50",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes(pts, verts, zeros, d2_k),
                7 * pts.shape[0] * verts.shape[0]),
        "library_ms": None,
    })

    # K2 -----------------------------------------------------------------
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

    # K2 at the train shape, its token gradient, and K3, on one full-width
    # train batch -------------------------------------------------------
    uv_pix, uv_verts, image, binding = train_batch_projections(dev)
    results[-1].update(time_dparf_train(card, *binding, tokens, k))
    check_dparf_grad(card, *binding, k)
    k3 = check_dfeat_scatter(card, uv_pix, uv_verts, image)
    k3["t7"] = check_t7_scatter(card)
    results.append(k3)
    # K4 on one full-width request -----------------------------------------
    results.append(check_feature_gather(card))
    # the bf16 forms of K2, K4 and K3, at the same shapes ------------------
    results.extend(check_bf16_forms(card, pts, centers, rot, tokens, k,
                                    binding, uv_pix, uv_verts, image))
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

    cfg = Config().merge_opts(["dataset", "synthetic"])
    _, _, data, pipe = build_trainer(cfg, dev)
    smp = data.get_train_sample(0).to(dev)
    f = smp.frame
    pts, _, pts_mask, _ = pipe.train_points(smp.rays, fold_in(cfg.seed, 0),
                                            cfg.perturb > 0)
    pro = pipe.prologue(f)
    return (pipe.fetch_uv(f, pts, pts_mask), pipe.fetch_uv(f, f.verts_world),
            tuple(f.images.shape[1:3]),
            (to_smpl(f, pts).contiguous(), pro.centers, pro.rot))


def time_dparf_train(card: str, pts, centers, rot, tokens, k: int) -> dict:
    """K2 at the train step's shape: every sample point of one full-width
    train batch (6 patches of 20x20 rays x 64 samples, unculled)."""
    from transhuman_tpu_torch.kernels import dparf

    outs = dparf.dparf_cuda(pts, centers, rot, tokens, k)
    ms = time_ms(lambda: dparf.dparf_cuda(pts, centers, rot, tokens, k))
    plain_ms = time_ms(lambda: dparf.dparf_plain(pts, centers, rot, tokens,
                                                 k), iters=5)
    b = bound(nbytes(pts, centers, rot, tokens, *outs),
              8 * pts.shape[0] * centers.shape[0]
              + 2 * k * tokens.numel() // centers.shape[0] * pts.shape[0])
    log(f"[3 kernels] K2 dparf at the train shape, {pts.shape[0]} pts, "
        f"C={centers.shape[0]}, V=3, D=192, k={k}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})  [{card}]")
    return {"train_ms": ms, "train_plain_ms": plain_ms,
            "train_bound_ms": b["bound_ms"]}


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
    (3, 512, 512, 192) at 6,890 vertices; two calls give the same bits; the
    wrapper (sort, segment bookkeeping, one host sync, three kernels) timed
    beside the sort alone and one library call."""
    from transhuman_tpu_torch.kernels import scatter
    from transhuman_tpu_torch.kernels.gather import _bilinear_w4, _sample_taps

    entry = {"name": "dfeat_scatter", "route": "cuda",
             "source": "transhuman_tpu_torch/csrc/scatter.cu",
             "replaces": "transhuman_tpu/experiments/streamscatter.py:172"}
    for tag, uv, c in (("pixel", uv_pix, 384), ("paint", uv_verts, 192)):
        dev = uv.device
        _, _, base, wx, wy, dx, dy = _sample_taps((3, image[0], image[1], c),
                                                  uv, image)
        ids = base.to(torch.int32).contiguous()
        w4 = _bilinear_w4(wx, wy).contiguous()
        g = torch.randn((3, ids.shape[1], c), device=dev,
                        generator=torch.Generator(dev).manual_seed(6))
        hw = image[0] * image[1]
        got = scatter.dfeat_scatter_cuda(ids, g, w4, hw, dx, dy)
        want = scatter.dfeat_scatter_plain(ids, g, w4, hw, dx, dy)
        again = scatter.dfeat_scatter_cuda(ids, g, w4, hw, dx, dy)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        # float32 sums in another order (segments of sorted rows, then taps)
        check(err <= 1e-4 + 1e-5 * scale,
              f"K3 {tag}: max err {err} (max |d_feat| {scale})")
        check(torch.equal(got, again), f"K3 {tag}: two calls differ")
        del want, again
        per_texel = ids.numel() / sum(int(torch.unique(i).numel())
                                      for i in ids)
        longest = max(int(torch.unique(i, return_counts=True)[1].max())
                      for i in ids)
        ms = time_ms(lambda: scatter.dfeat_scatter_cuda(ids, g, w4, hw, dx,
                                                        dy))
        plain_ms = time_ms(lambda: scatter.dfeat_scatter_plain(ids, g, w4, hw,
                                                               dx, dy))
        sort_ms = time_ms(lambda: torch.sort(ids, dim=1, stable=True))
        # the library call: the whole function as one index_add_ of the 4N
        # tap rows (weighted outside the timed region) into a fresh zeroed
        # map, the zero-fill and the index_add_ timed together
        flat4 = torch.cat([(ids.long() + hw * torch.arange(
            3, device=dev)[:, None] + off).reshape(-1)
            for off in (0, dx, dy, dy + dx)])
        rows4 = torch.cat([(g * w4[..., t:t + 1]).reshape(-1, c)
                           for t in range(4)])
        lib_ms = time_ms(lambda: torch.zeros((3 * hw, c), device=dev)
                         .index_add_(0, flat4, rows4))
        del flat4, rows4
        b = bound(nbytes(ids, g, w4, got), 8 * g.numel())
        log(f"[3 kernels] K3 dfeat_scatter {tag}: V=3, N={ids.shape[1]}, "
            f"C={c}, {hw} texels, {per_texel:.2f} rows per touched texel, "
            f"longest run {longest}: max err {err:.3g} of max {scale:.3g}, "
            f"two calls bit-identical; wrapper {ms:.4f} ms (sort "
            f"{sort_ms:.4f}), plain {plain_ms:.4f} ms, zeros + index_add_ "
            f"{lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})  [{card}]")
        if tag == "pixel":
            entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, sort_ms=sort_ms, **b)
        else:
            entry.update(paint_ms=ms, paint_plain_ms=plain_ms,
                         paint_library_ms=lib_ms,
                         paint_bound_ms=b["bound_ms"],
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
        again = scatter.dfeat_scatter_cuda(ids, rows, w4, window, 1, 2)
        torch.cuda.synchronize()
        err = float((got[0] - want).abs().max())
        scale = float(want.abs().max())
        # ~32 rows per window texel per tap, summed in two orders
        check(err <= 1e-4 + 1e-5 * scale,
              f"T7 via K3, {taps} taps: max err {err} (max {scale})")
        check(torch.equal(got, again), f"T7 via K3, {taps} taps: two calls "
              "differ")
        ms = time_ms(lambda: scatter.dfeat_scatter_cuda(ids, rows, w4, window,
                                                        1, 2))
        plain_ms = time_ms(oracle)
        # the library call: one index_add_ per tap of rows scaled outside
        # the timed region, into a fresh zeroed window: one call for one tap
        flat = torch.cat([ids[0].long() + t for t in range(taps)])
        scaled = torch.cat([(0.25 + 0.1 * t) * rows[0] for t in range(taps)])
        lib_ms = time_ms(lambda: torch.zeros((window, c), device=dev)
                         .index_add_(0, flat, scaled))
        out[f"taps{taps}"] = {"max_abs_err": err, "ms": ms,
                              "plain_ms": plain_ms, "library_ms": lib_ms,
                              **bound(nbytes(ids, rows, w4, got),
                                      2 * taps * rows.numel())}
        log(f"[3 kernels] T7 by K3 (dx=1, dy=2), {taps} tap(s), N={n}, "
            f"C={c}, window {window}: max err {err:.3g} of max {scale:.3g}, "
            f"two calls bit-identical; wrapper {ms:.4f} ms, oracle "
            f"{plain_ms:.4f} ms, zeros + index_add_ of the scaled rows "
            f"{lib_ms:.4f} ms, bound {out[f'taps{taps}']['bound_ms']:.4f} ms"
            f"  [{card}]")
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
    """K4 at the serve pixel and painting shapes of one real request: the
    sampling form (uv in, one launch) against its plain twin, against the
    id form on _sample_taps' ids and weights (bits) and against grid_sample
    (align_corners, border) on an NCHW copy of the same map; the id form
    against its plain version (with masked ids too); the whole
    sample_feature_map forward, the wrappers and the bare launches timed,
    each beside its bound; then the 1-tap forms at the TPU gather probes'
    shape (tools/probe_block_gather.py: 262,144 rows of 384, 1,048,576
    ids)."""
    import torch.nn.functional as F

    from transhuman_tpu_torch.kernels import build, gather
    from transhuman_tpu_torch.kernels.gather import _bilinear_w4, _sample_taps
    from transhuman_tpu_torch.ops.sampling import sample_feature_map

    dev = torch.device("cuda")
    lib, stream = build.library(), torch.cuda.current_stream().cuda_stream
    pixel, holder, uv_pix, uv_verts, image = serve_request_maps(dev)
    entry = {"name": "feature_gather", "route": "cuda",
             "source": "transhuman_tpu_torch/csrc/gather.cu",
             "replaces": "tools/profile_gather_ab.py:156"}
    for tag, fmap, uv in (("pixel", pixel, uv_pix),
                          ("paint", holder, uv_verts)):
        v, hf, wf, c = fmap.shape
        n = uv.shape[1]
        fx, fy, base, wx, wy, dx, dy = _sample_taps(fmap.shape, uv, image)
        src = fmap.reshape(v, hf * wf, c)
        ids = base.to(torch.int32).contiguous()
        w4 = _bilinear_w4(wx, wy).contiguous()
        offs = (0, dx, dy, dy + dx)
        got = gather.feature_sample_cuda(fmap, uv, image)
        by_ids = gather.feature_gather_cuda(src, ids, w4, offs)
        want = gather.feature_sample_plain(fmap, uv, image)
        torch.cuda.synchronize()
        check(torch.equal(got, by_ids),
              f"K4 {tag}: the sampling form differs from the id form on "
              "_sample_taps' taps")
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
        raw = torch.empty_like(got)
        with torch.no_grad():
            path_ms = time_ms(lambda: sample_feature_map(fmap, uv, image))
        t = {
            "ms": time_ms(lambda: gather.feature_sample_cuda(fmap, uv,
                                                             image)),
            "launch_ms": time_ms(lambda: lib.thp_feature_sample(
                fmap.data_ptr(), uv.data_ptr(), raw.data_ptr(), v, n, c, hf,
                wf, wf / image[1], hf / image[0], stream)),
            "ids_ms": time_ms(lambda: gather.feature_gather_cuda(src, ids, w4,
                                                                 offs)),
            "ids_launch_ms": time_ms(lambda: lib.thp_feature_gather(
                src.data_ptr(), ids.data_ptr(), w4.data_ptr(),
                raw.data_ptr(), v, n, c, hf * wf, 4, *offs, stream)),
            "plain_ms": time_ms(lambda: gather.feature_sample_plain(
                fmap, uv, image)),
            "library_ms": time_ms(lambda: F.grid_sample(
                nchw, grid, mode="bilinear", padding_mode="border",
                align_corners=True)),
        }
        check(torch.equal(raw, got), f"K4 {tag}: the bare launches differ")
        rows = _unique_rows(ids, offs)
        b = bound(rows * c * 4 + nbytes(uv, got), 8 * got.numel())
        b_ids = bound(rows * c * 4 + nbytes(ids, w4, got), 8 * got.numel())
        log(f"[3 kernels] K4 sampling form {tag}: V={v}, N={n}, C={c}, "
            f"{hf}x{wf} map, {rows} distinct tap rows: bit-identical to the "
            f"id form; max err {err:.3g}, vs grid_sample {gs_err:.3g} (max "
            f"|src| {scale:.3g}); sample_feature_map forward "
            f"{path_ms:.4f} ms, wrapper {t['ms']:.4f} ms, launch "
            f"{t['launch_ms']:.4f}; id form wrapper "
            f"{t['ids_ms']:.4f}, launch {t['ids_launch_ms']:.4f} (bound "
            f"{b_ids['bound_ms']:.4f}); plain {t['plain_ms']:.4f} ms, "
            f"grid_sample {t['library_ms']:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
        del nchw, grid, gs
        if tag == "pixel":
            entry.update(max_abs_err=max(err, gs_err), path_ms=path_ms, **t,
                         ids_bound_ms=b_ids["bound_ms"], **b)
            masked = ids.clone()
            masked[:, ::7] = -1
            got = gather.feature_gather_cuda(src, masked, w4, offs)
            want = gather.feature_gather_plain(src, masked, w4, offs)
            torch.cuda.synchronize()
            m_err = float((got - want).abs().max())
            check(m_err <= 1e-6 * scale + 1e-7 and not got[:, ::7].any(),
                  f"K4 masked ids: max err {m_err}, or a masked row not 0")
            log(f"[3 kernels] K4 id form with every 7th id -1: max err "
                f"{m_err:.3g}, masked rows zero  [{card}]")
        else:
            entry.update({f"paint_{k}": x for k, x in t.items()},
                         paint_path_ms=path_ms,
                         paint_bound_ms=b["bound_ms"],
                         max_abs_err=max(entry["max_abs_err"], err, gs_err))
    del pixel, holder

    # the TPU gather probes' 1-tap forms: weighted (block_gather) and
    # plain rows (make_block_gather, gather_a/b/c, attempt)
    gen = torch.Generator(dev).manual_seed(8)
    src = torch.randn((1, 262144, 384), device=dev, generator=gen)
    ids = torch.randint(0, 262144, (1, 1048576), device=dev, generator=gen,
                        dtype=torch.int32)
    raw = torch.empty((1, ids.shape[1], 384), device=dev)
    for form, w in (("weighted", torch.rand((1, ids.shape[1], 1), device=dev,
                                            generator=gen)),
                    ("rows", torch.ones((1, ids.shape[1], 1), device=dev))):
        got = gather.feature_gather_cuda(src, ids, w, (0,))
        want = gather.feature_gather_plain(src, ids, w, (0,))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(err == 0.0, f"K4 1-tap {form}: max err {err}")
        del want
        ms = time_ms(lambda: gather.feature_gather_cuda(src, ids, w, (0,)),
                     iters=10)
        launch_ms = time_ms(lambda: lib.thp_feature_gather(
            src.data_ptr(), ids.data_ptr(), w.data_ptr(), raw.data_ptr(), 1,
            ids.shape[1], 384, src.shape[1], 1, 0, 0, 0, 0, stream),
            iters=10)
        check(torch.equal(raw, got), f"K4 1-tap {form}: the bare launch "
              "differs")
        plain_ms = time_ms(lambda: gather.feature_gather_plain(src, ids, w,
                                                               (0,)), iters=10)
        lib_txt = ""
        if form == "rows":
            lib_ms = time_ms(lambda: src[0].index_select(0, ids[0]), iters=10)
            lib_txt = f", index_select {lib_ms:.4f} ms"
            entry["rows_library_ms"] = lib_ms
        b = bound(_unique_rows(ids, (0,)) * 384 * 4 + nbytes(ids, w, got),
                  2 * got.numel())
        entry[f"{form}_ms"] = ms
        entry[f"{form}_launch_ms"] = launch_ms
        entry[f"{form}_plain_ms"] = plain_ms
        entry[f"{form}_bound_ms"] = b["bound_ms"]
        log(f"[3 kernels] K4 1-tap {form}: 1,048,576 ids into 262,144 rows "
            f"of 384: max err {err:.3g}; wrapper {ms:.4f} ms, launch "
            f"{launch_ms:.4f} ms, plain {plain_ms:.4f} ms{lib_txt}, bound "
            f"{b['bound_ms']:.4f} ms  [{card}]")
    return entry


def check_bf16_forms(card: str, pts, centers, rot, tokens, k: int,
                     binding, uv_pix, uv_verts, image) -> list:
    """The bf16 forms of K2 (bf16 tokens), K4's sampling form (a bf16 map)
    and K3 (bf16 cotangent rows, a bf16 map), each equal bit for bit to its
    float32 form on the widened inputs cast once, and against its plain
    twin within one unit of bf16's last place of the largest value; timed
    beside its bound (the bf16 bytes), its plain twin and the library call.
    K2 at the render chunk and the train shape, K4 at the serve pixel and
    painting shapes of a real request, K3 at both train shapes."""
    import torch.nn.functional as F

    from transhuman_tpu_torch.kernels import build, dparf, gather, scatter
    from transhuman_tpu_torch.kernels.gather import _bilinear_w4, _sample_taps
    from transhuman_tpu_torch.ops.sampling import sample_feature_map

    bf16, eps = torch.bfloat16, 2.0**-7
    dev = pts.device
    out = []

    # K2: bf16 tokens, float32 points, centres and rotations
    tok16 = tokens.to(bf16)
    got = dparf.dparf_bf16_cuda(pts, centers, rot, tok16, k)
    want = dparf.dparf_cuda(pts, centers, rot, tok16.float(), k)
    plain = dparf.dparf_plain(pts, centers, rot, tok16, k)
    torch.cuda.synchronize()
    check(got[0].dtype == bf16 and torch.equal(got[0], want[0].to(bf16)),
          "K2 bf16: tok is not the float32 form's, cast")
    check(all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])),
          "K2 bf16: pe, dist, idx or w differ from the float32 form's")
    ok = ~knn_near_ties(pts, centers, k)
    scale = float(plain[0].float().abs().max())
    err = float((got[0].float() - plain[0].float())[:, ok].abs().max())
    # two float32 sums in other orders, each rounded to bf16 once
    check(err <= eps * scale, f"K2 bf16: tok max err {err} vs its plain "
          f"twin (max |tok| {scale}) off ties")
    ms = time_ms(lambda: dparf.dparf_bf16_cuda(pts, centers, rot, tok16, k))
    plain_ms = time_ms(lambda: dparf.dparf_plain(pts, centers, rot, tok16,
                                                 k))
    ops = (8 * pts.shape[0] * centers.shape[0]
           + 2 * k * tokens.numel() // centers.shape[0] * pts.shape[0])
    b = bound(nbytes(pts, centers, rot, tok16, *got), ops)
    tp = binding[0]
    got_t = dparf.dparf_bf16_cuda(*binding, tok16, k)
    train_ms = time_ms(lambda: dparf.dparf_bf16_cuda(*binding, tok16, k))
    b_t = bound(nbytes(*binding, tok16, *got_t),
                8 * tp.shape[0] * centers.shape[0]
                + 2 * k * tokens.numel() // centers.shape[0] * tp.shape[0])
    log(f"[3 kernels] K2 dparf bf16 tokens, {pts.shape[0]} pts, C=300, V=3, "
        f"D=192, k={k}: the float32 form's bits (tok cast once, pe/dist/idx/w "
        f"equal); tok err vs plain {err:.3g} of max {scale:.3g}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}); train shape {tp.shape[0]} pts {train_ms:.4f} ms,"
        f" bound {b_t['bound_ms']:.4f} ms  [{card}]")
    out.append({"name": "dparf_bf16", "route": "cuda",
                "source": "transhuman_tpu_torch/csrc/dparf.cu",
                "replaces": "transhuman_tpu/experiments/dparf.py:115",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
                "library_ms": None, "train_ms": train_ms,
                "train_bound_ms": b_t["bound_ms"]})
    del got, want, plain, got_t

    # K4's sampling form on the request's maps in bf16
    lib, stream = build.library(), torch.cuda.current_stream().cuda_stream
    pixel, holder, uv_p, uv_v, img = serve_request_maps(dev)
    entry = {"name": "feature_sample_bf16", "route": "cuda",
             "source": "transhuman_tpu_torch/csrc/gather.cu",
             "replaces": "tools/profile_gather_ab.py:156"}
    for tag, fmap, uv in (("pixel", pixel.to(bf16), uv_p),
                          ("paint", holder.to(bf16), uv_v)):
        v, hf, wf, c = fmap.shape
        n = uv.shape[1]
        fx, fy, base, _, _, dx, dy = _sample_taps(fmap.shape, uv, img)
        got = gather.feature_sample_bf16_cuda(fmap, uv, img)
        want = gather.feature_sample_cuda(fmap.float(), uv, img).to(bf16)
        plain = gather.feature_sample_plain(fmap, uv, img)
        torch.cuda.synchronize()
        check(got.dtype == bf16 and torch.equal(got, want),
              f"K4 bf16 {tag}: not the float32 form's rows, cast")
        scale = float(fmap.float().abs().max())
        err = float((got.float() - plain.float()).abs().max())
        # a fused and an unfused float32 lerp, each rounded to bf16 once
        check(err <= eps * scale, f"K4 bf16 {tag}: max err {err} vs its "
              f"plain twin (max |src| {scale})")
        # the library call: grid_sample over a bf16 NCHW copy, its grid in
        # bf16 too (grid_sample takes one dtype); prepared outside the timing
        nchw = fmap.permute(0, 3, 1, 2).contiguous()
        grid = torch.stack([fx / (wf - 1) * 2 - 1, fy / (hf - 1) * 2 - 1],
                           dim=-1)[:, None].to(bf16).contiguous()
        raw = torch.empty_like(got)
        with torch.no_grad():
            path_ms = time_ms(lambda: sample_feature_map(fmap, uv, img))
        t = {
            "ms": time_ms(lambda: gather.feature_sample_bf16_cuda(fmap, uv,
                                                                  img)),
            "launch_ms": time_ms(lambda: lib.thp_feature_sample_bf16(
                fmap.data_ptr(), uv.data_ptr(), raw.data_ptr(), v, n, c, hf,
                wf, wf / img[1], hf / img[0], stream)),
            "plain_ms": time_ms(lambda: gather.feature_sample_plain(
                fmap, uv, img)),
            "library_ms": time_ms(lambda: F.grid_sample(
                nchw, grid, mode="bilinear", padding_mode="border",
                align_corners=True)),
        }
        check(torch.equal(raw, got), f"K4 bf16 {tag}: the bare launches "
              "differ")
        rows = _unique_rows(base, (0, dx, dy, dy + dx))
        b = bound(rows * c * 2 + nbytes(uv, got), 8 * got.numel())
        log(f"[3 kernels] K4 sampling form bf16 {tag}: V={v}, N={n}, C={c}, "
            f"{hf}x{wf} map, {rows} distinct tap rows: the float32 form's "
            f"bits cast; max err vs plain {err:.3g} (max |src| {scale:.3g}); "
            f"sample_feature_map forward {path_ms:.4f} ms, wrapper "
            f"{t['ms']:.4f} ms, launch {t['launch_ms']:.4f}; plain "
            f"{t['plain_ms']:.4f} ms, grid_sample (bf16) "
            f"{t['library_ms']:.4f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})  [{card}]")
        del nchw, grid
        if tag == "pixel":
            entry.update(max_abs_err=err, path_ms=path_ms, **t, **b)
        else:
            entry.update({f"paint_{key}": x for key, x in t.items()},
                         paint_path_ms=path_ms, paint_bound_ms=b["bound_ms"],
                         max_abs_err=max(entry["max_abs_err"], err))
    out.append(entry)
    del pixel, holder

    # K3: bf16 cotangent rows at both train shapes
    entry = {"name": "dfeat_scatter_bf16", "route": "cuda",
             "source": "transhuman_tpu_torch/csrc/scatter.cu",
             "replaces": "transhuman_tpu/experiments/streamscatter.py:172"}
    for tag, uv, c in (("pixel", uv_pix, 384), ("paint", uv_verts, 192)):
        _, _, base, wx, wy, dx, dy = _sample_taps((3, image[0], image[1], c),
                                                  uv, image)
        ids = base.to(torch.int32).contiguous()
        w4 = _bilinear_w4(wx, wy).contiguous()
        g = torch.randn((3, ids.shape[1], c), device=dev,
                        generator=torch.Generator(dev).manual_seed(6)
                        ).to(bf16)
        hw = image[0] * image[1]
        got = scatter.dfeat_scatter_bf16_cuda(ids, g, w4, hw, dx, dy)
        again = scatter.dfeat_scatter_bf16_cuda(ids, g, w4, hw, dx, dy)
        want = scatter.dfeat_scatter_cuda(ids, g.float(), w4, hw, dx,
                                          dy).to(bf16)
        torch.cuda.synchronize()
        check(got.dtype == bf16 and torch.equal(got, want),
              f"K3 bf16 {tag}: not the float32 form's map, cast")
        check(torch.equal(got, again), f"K3 bf16 {tag}: two calls differ")
        del want, again
        plain = scatter.dfeat_scatter_plain(ids, g, w4, hw, dx, dy)
        scale = float(plain.float().abs().max())
        err = float((got.float() - plain.float()).abs().max())
        del plain
        # float32 sums in two orders, each rounded to bf16 once
        check(err <= eps * scale + 1e-4, f"K3 bf16 {tag}: max err {err} vs "
              f"its plain twin (max |d_feat| {scale})")
        ms = time_ms(lambda: scatter.dfeat_scatter_bf16_cuda(ids, g, w4, hw,
                                                             dx, dy))
        plain_ms = time_ms(lambda: scatter.dfeat_scatter_plain(
            ids, g, w4, hw, dx, dy))
        # the library call: a fresh float32 zeros map, one index_add_ of the
        # 4N pre-weighted rows and one cast to bf16, timed together
        flat4 = torch.cat([(ids.long() + hw * torch.arange(
            3, device=dev)[:, None] + off).reshape(-1)
            for off in (0, dx, dy, dy + dx)])
        rows4 = torch.cat([(g.float() * w4[..., t:t + 1]).reshape(-1, c)
                           for t in range(4)])
        lib_ms = time_ms(lambda: torch.zeros((3 * hw, c), device=dev)
                         .index_add_(0, flat4, rows4).to(bf16))
        del flat4, rows4
        b = bound(nbytes(ids, g, w4, got), 8 * g.numel())
        log(f"[3 kernels] K3 dfeat_scatter bf16 {tag}: V=3, N={ids.shape[1]},"
            f" C={c}, {hw} texels: the float32 form's bits cast, two calls "
            f"bit-identical; max err vs plain {err:.3g} of max {scale:.3g}; "
            f"wrapper {ms:.4f} ms, plain {plain_ms:.4f} ms, zeros + "
            f"index_add_ + cast {lib_ms:.4f} ms, bound {b['bound_ms']:.4f} ms"
            f" ({b['bound_by']})  [{card}]")
        if tag == "pixel":
            entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=lib_ms, **b)
        else:
            entry.update(paint_ms=ms, paint_plain_ms=plain_ms,
                         paint_library_ms=lib_ms,
                         paint_bound_ms=b["bound_ms"],
                         max_abs_err=max(entry["max_abs_err"], err))
        del got
    out.append(entry)
    return out


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


def min_reach64(pts, refs, radii, block: int = 4096):
    """min over refs of (|p - r| - radius_r) per point, in float64: < 0
    where the per-vertex radii cull keeps the point."""
    p, r, rad = pts.double(), refs.double(), radii.double()
    out = torch.empty(p.shape[0], dtype=torch.float64, device=p.device)
    for s in range(0, p.shape[0], block):
        out[s:s + block] = (torch.cdist(p[s:s + block], r)
                            - rad[None]).min(dim=1).values
    return out


def _unstable_points(pipe, frame, pts_world):
    """(N,) bool tensor: the point lies within 1e-5 m of the cull threshold
    (cull_distance, or its vertex radius under the radii cull), or is kept
    at a kNN near-tie; there the card's kernels and the CPU's plain
    versions may legitimately decide differently.  frame and points on the
    pipeline's device."""
    from transhuman_tpu_torch.render.pipeline import to_smpl

    with torch.no_grad():
        centers = pipe.prologue(frame).centers
        p = to_smpl(frame, pts_world)
        if pipe.vertex_radii is None:
            d = min_dist64(p, frame.tar_verts_smpl) - pipe.cull_distance
        else:
            d = min_reach64(p, frame.tar_verts_smpl, pipe.vertex_radii)
        bad = d.abs() < 1e-5
        kept = d < 0
        bad[kept] |= knn_near_ties(p[kept], centers, pipe.model.knn_k)
    return bad


def _unstable_rays(pipe, frame, rays):
    """(R,) bool numpy: the ray has a sample of _unstable_points.  frame and
    rays on the pipeline's device."""
    from transhuman_tpu_torch.render.volume import sample_along_rays

    with torch.no_grad():
        pts, _ = sample_along_rays(rays.ray_o, rays.ray_d, rays.near,
                                   rays.far, pipe.n_samples)
    bad = _unstable_points(pipe, frame, pts.reshape(-1, 3))
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


def phase_parity(card: str, dtype: str = "float32", ref=None, radii=None):
    """One 64x64 request through RenderService on the card and on the CPU
    (plain versions), the same full-width weights, in the compute dtype;
    in bf16 also held nearer the CPU's bf16 than ref (the CPU's float32
    render, this phase's float32 result) is.  With radii ((6890,) numpy)
    both cull with those per-vertex radii (phase h2).  Returns the CPU
    render."""
    import copy

    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.render.pipeline import RenderPipeline
    from transhuman_tpu_torch.serve import RenderService
    from transhuman_tpu_torch.testing import synthetic_setup

    hw = 64
    cfg = Config().merge_opts(["H", str(2 * hw), "W", str(2 * hw),
                               "compute_dtype", dtype])
    model, pipe, frame, smpl, cluster = synthetic_setup(
        image_hw=(hw, hw), device="cuda", compute_dtype=COMPUTE[dtype])
    pipe.vertex_radii = radii
    svc_gpu = RenderService(cfg, pipe, smpl)
    model_cpu = copy.deepcopy(model).cpu()
    pipe_cpu = RenderPipeline(model_cpu, cluster, smpl.v_template,
                              n_samples=pipe.n_samples,
                              chunk_rays=pipe.chunk_rays, device="cpu",
                              vertex_radii=radii)
    svc_cpu = RenderService(cfg, pipe_cpu, smpl)
    req = _request(frame, 1, hw)
    kernels.reset_launch_counts()
    out_g = svc_gpu.render(req)
    k1 = kernels.launch_counts()["min_excess2"]
    check(k1 >= 1, f"parity: K1 launched {k1} times")
    out_c = svc_cpu.render(req)
    skip = _unstable_pixels(svc_gpu, req)
    ok = ~skip
    errs = {k: float(np.abs(out_g[k] - out_c[k])[ok].max())
            for k in ("rgb", "acc", "depth")}
    check(skip.mean() < 0.05, f"parity: {int(skip.sum())} unstable pixels")
    check(float(out_c["acc"].max()) > 0.5, "parity: the frame is empty")
    if dtype == "float32":
        check(errs["rgb"] <= 2e-3 and errs["acc"] <= 2e-3,
              f"parity: rgb/acc CUDA vs CPU {errs} > 2e-3")
        check(errs["depth"] <= 1e-2,
              f"parity: depth CUDA vs CPU {errs} > 1e-2")
        label, extra = "4 parity", ""
        if radii is not None:
            label = "h2 parity, cull_radii"
            extra = (f"; survivors card {pipe.last_frame_stats['survivors']}"
                     f", CPU {pipe_cpu.last_frame_stats['survivors']} of "
                     f"{pipe.last_frame_stats['points']}")
    else:
        check(errs["rgb"] <= BF16_RGB_TOL and errs["acc"] <= BF16_RGB_TOL
              and errs["depth"] <= BF16_DEPTH_TOL,
              f"bf16 parity: CUDA vs CPU {errs} beyond {BF16_RGB_TOL} "
              f"(rgb, acc) / {BF16_DEPTH_TOL} (depth)")
        means = {k: _closer(f"bf16 parity {k}", out_g[k][ok], out_c[k][ok],
                            ref[k][ok]) for k in ("rgb", "acc", "depth")}
        label = "12 bf16 parity"
        extra = "; mean |card - CPU| vs mean |CPU bf16 - CPU f32|: " + (
            ", ".join(f"{k} {a:.3g} vs {b:.3g}" for k, (a, b) in
                      means.items()))
    log(f"[{label}] {hw}x{hw} full-width render in {dtype}, CUDA vs CPU: "
        f"max |d rgb| {errs['rgb']:.3g}, |d acc| {errs['acc']:.3g}, "
        f"|d depth| {errs['depth']:.3g} over {int(ok.sum())} pixels "
        f"({int(skip.sum())} at a cull/kNN near-tie excluded){extra}  "
        f"[{card}]")
    return out_c


def phase_serve(card: str, dtype: str = "float32"):
    """Three 512x512 requests through HTTP to the full-width service in the
    compute dtype, the launch counters reset just before and read just
    after."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.serve import RenderServer, RenderService
    from transhuman_tpu_torch.testing import synthetic_setup

    hw = 512
    label = "5 serve" if dtype == "float32" else "13 bf16 serve"
    cfg = Config().merge_opts(["compute_dtype", dtype])  # 512x512 renders
    model, pipe, frame, smpl, _ = synthetic_setup(
        image_hw=(hw, hw), device="cuda", compute_dtype=COMPUTE[dtype])
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
                f"[{label}] request {i}: {hw}x{hw}, latency {lat:.1f} ms, "
                f"{st['points']} points, survivor fraction "
                f"{st['survivors'] / max(st['points'], 1):.4f}  [{card}]")
    finally:
        server.shutdown()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for line in lines:
        log(line)
    log(f"[{label}] launches {counts}; peak device memory {peak:.3f} GiB  "
        f"[{card}]")
    f = forms(dtype)
    check_launches(f"serve ({dtype})", counts,
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    return counts


def _grads_and_update(state, p0):
    return ({n: p.grad.detach().cpu() for n, p in
             state.model.named_parameters() if p.grad is not None},
            {n: p.detach().cpu() - p0[n] for n, p in
             state.model.named_parameters()})


def _parity_cfg(dtype: str = "float32", lpips: str = "", extra=()):
    """The config of phase 6's 64x64 full-width step (see
    phase_train_parity)."""
    from transhuman_tpu_torch.config import Config

    return Config().merge_opts(["H", "128", "W", "128", "perturb", "0",
                                "patch.N_patches", "2", "patch.size",
                                "16" if lpips else "10",
                                "compute_dtype", dtype, "dataset",
                                "synthetic", "lpips_weights", lpips, *extra])


def _parity_step(cfg, dev: str):
    """One step of cfg's seeded model on train.batch_size samples on dev:
    (stats, initial parameters, gradients, update), on the CPU."""
    from transhuman_tpu_torch.cli.train import build_trainer

    state, step_fn, data, _ = build_trainer(cfg, torch.device(dev))
    p0 = {n: p.detach().cpu().clone()
          for n, p in state.model.named_parameters()}
    batch = [data.get_train_sample(i).to(dev)
             for i in range(cfg.train.batch_size)]
    stats = step_fn(state, batch, 0)
    return (stats, p0, *_grads_and_update(state, p0))


def phase_train_parity(card: str, dtype: str = "float32", ref=None,
                       lpips: str = "", extra=(), card_out=None):
    """One train step at 64x64 (full-width model, 2 patches of 10x10 rays x
    64 samples, jitter off) on the card and on the CPU from the same
    seeded weights and sample, in the compute dtype; in bf16 also against
    ref (the CPU's float32 step, this phase's float32 result).  With lpips
    (an LPIPS npz) the loss adds 0.1 x LPIPS over 2 patches of 16x16 (a
    side VGG16's pools need).  extra: more config overrides (phase h2:
    train.batch_size, train.accum_steps, train.cull, remat); the step takes
    train.batch_size samples.  Returns the CPU step's (stats, gradients,
    update); card_out, a dict, receives the card's."""
    cfg = _parity_cfg(dtype, lpips, extra)
    tag = " with LPIPS" if lpips else ""
    if extra:
        tag += " with " + " ".join(extra)
    runs = {dev: _parity_step(cfg, dev) for dev in ("cuda", "cpu")}
    if card_out is not None:
        card_out.update(zip(("stats", "p0", "grads", "update"), runs["cuda"]))
    (sg, p0g, gg, dg), (sc, p0c, gc, dc) = runs["cuda"], runs["cpu"]
    check(all(torch.equal(p0g[n], p0c[n]) for n in p0c),
          "train parity: the two runs start from different weights")
    check(all(g.dtype == torch.float32 for g in list(gg.values())
              + list(gc.values())), "train parity: a gradient is not float32")
    lerr = abs(sg["loss"] - sc["loss"]) / sc["loss"]
    check(set(gg) == set(gc) == set(p0c) - UNREAD_PARAMS,
          "train parity: the parameters with a gradient differ")
    gmax = max(float(gc[n].norm()) for n in gc)
    lr = sc["lr"]
    if lpips:
        lp_err = abs(sg["lpips_loss"] - sc["lpips_loss"]) / sc["lpips_loss"]
        check(sc["lpips_loss"] > 0 and lp_err <= (
            BF16_LOSS_RTOL if dtype == "bfloat16" else 1e-4),
            f"train parity{tag}: lpips_loss {sg['lpips_loss']} vs "
            f"{sc['lpips_loss']}")
        tag += f" (lpips_loss {sg['lpips_loss']:.7g} vs " \
               f"{sc['lpips_loss']:.7g}, rel {lp_err:.3g})"
    if dtype == "bfloat16":
        check(lerr <= BF16_LOSS_RTOL, f"bf16 train parity: loss {sg['loss']}"
              f" vs {sc['loss']} (CPU float32 {ref[0]['loss']})")
        worst = max((float((gg[n] - gc[n]).norm()) / gmax, n) for n in gc)
        check(worst[0] <= BF16_GRAD_TOL, f"bf16 train parity: a gradient "
              f"leaf differs by {worst} of the largest leaf's norm")
        names = sorted(gc)
        g_card, g_cpu, g_ref = (torch.cat([d[n].ravel() for n in names])
                                .numpy() for d in (gg, gc, ref[1]))
        gm = _closer("bf16 train parity: gradients", g_card, g_cpu, g_ref)
        # Adam's first update is -lr g / (|g| + 1e-8): the card must agree
        # with the CPU's bf16 step on its sign at least as often as the
        # CPU's float32 step does
        flips = flips_ref = total = 0
        for n in gc:
            sure = gc[n].abs() > 1e-6
            flips += int((dg[n].sign() != dc[n].sign())[sure].sum())
            flips_ref += int((ref[2][n].sign() != dc[n].sign())[sure].sum())
            total += int(sure.sum())
        check(flips <= flips_ref, f"bf16 train parity: {flips} update signs "
              f"differ from the CPU's bf16 step, the CPU's float32 step "
              f"{flips_ref} (of {total})")
        log(f"[{'h2' if extra else 'd' if lpips else '12'} bf16 train "
            f"parity] 64x64 full-width "
            f"step in bf16{tag}, CUDA vs CPU: loss {sg['loss']:.7g} vs {sc['loss']:.7g} (rel "
            f"{lerr:.3g}; CPU float32 {ref[0]['loss']:.7g}); worst gradient "
            f"leaf {worst[0]:.3g} of the largest leaf's norm ({worst[1]}); "
            f"mean |d grad| {gm[0]:.3g} vs CPU bf16 - float32 {gm[1]:.3g}; "
            f"update signs differing {flips} vs {flips_ref} of {total}  "
            f"[{card}]")
        return sc, gc, dc
    # float32 on both; sums in other orders, K2/K3 vs the plain versions
    check(lerr <= 1e-4, f"train parity: loss {sg['loss']} vs {sc['loss']}")
    # per leaf, relative to its norm, with a floor of 1e-5 of the largest
    # leaf's norm: some leaves' gradients vanish in exact arithmetic (the
    # pixel keys' bias: a constant shift of every key under the softmax over
    # the keys) and hold float32 noise that differs between the two devices
    rel = sorted(((float((gg[n] - gc[n]).norm())
                   / (1e-3 * float(gc[n].norm()) + 1e-5 * gmax), n)
                  for n in gc), reverse=True)
    gerr = max(float((gg[n] - gc[n]).norm() / gc[n].norm()) for n in gc
               if float(gc[n].norm()) > 1e-5 * gmax)
    check(rel[0][0] <= 1.0, f"train parity: gradients differ beyond "
          f"tolerance: {rel[:3]} (error / tolerance, leaf)")
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
    log(f"[{'h2' if extra else 'd' if lpips else '6'} train parity] 64x64 "
        f"full-width step"
        f"{tag}, CUDA vs CPU: loss {sg['loss']:.7g} vs {sc['loss']:.7g} (rel {lerr:.3g}); max "
        f"gradient err {gerr:.3g} of its leaf's norm (leaves above the "
        f"floor); worst error/tolerance {rel[0][0]:.3g} ({rel[0][1]}); "
        f"update err beyond rounding "
        f"{worst_tight:.3g} where the sign is sure, {worst:.3g} anywhere, "
        f"lr {lr:.4g}  [{card}]")
    return sc, gc, dc


def phase_train(card: str, path: str, dtype: str = "float32"):
    """The train entry point at full width for TRAIN_STEPS steps in the
    compute dtype, counters reset just before; then its checkpoint (written
    to path, which the evaluate and reconstruction phases read) served at
    64x64."""
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
    tmp = os.path.dirname(path)
    state, records = train_cli.main([
        "--device", "cuda", "--steps", str(TRAIN_STEPS), "--out", path,
        "compute_dtype", dtype, "dataset", "synthetic",
        "trained_model_dir", os.path.join(tmp, f"tm_{dtype}"),
        "record_dir", os.path.join(tmp, f"rec_{dtype}")])
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
    f = forms(dtype)
    check_launches(f"train ({dtype}): K2 / K3 / K4 on every step", counts,
                   {f["dparf"]: TRAIN_STEPS, f["scatter"]: 2 * TRAIN_STEPS,
                    f["fetch"]: 2 * TRAIN_STEPS})
    check(state.model.compute_dtype == COMPUTE[dtype],
          f"train: the model computes in {state.model.compute_dtype}")
    # the checkpoint serves
    scfg = Config().merge_opts(["H", "128", "W", "128",
                                "compute_dtype", dtype])
    model, pipe, smpl, _ = build_runtime(scfg, "cuda")
    load_checkpoint_file(model, path)
    frame, _, _ = synthetic_scene(image_hw=(64, 64))
    out = RenderService(scfg, pipe, smpl).render(_request(frame, 1, 64))
    check(all(np.isfinite(v).all() for v in out.values()),
          "train: the trained checkpoint renders non-finite values")
    times = [r["step_s"] * 1e3 for r in records]
    label = "7 train" if dtype == "float32" else "13 bf16 train"
    for r in records:
        log(f"[{label}] step {r['step']}: loss {r['loss']:.6f}, lr "
            f"{r['lr']:.4g}, {r['step_s'] * 1e3:.1f} ms (data "
            f"{r['data_s'] * 1e3:.1f} ms)  [{card}]")
    log(f"[{label}] full width in {dtype}, 3 views 512x512, 2400 rays x 64 "
        f"samples: "
        f"median step {float(np.median(times[1:])):.1f} ms over steps "
        f"1-{len(times) - 1}; launches {counts}; peak device memory "
        f"{peak:.3f} GiB; checkpoint served at 64x64  [{card}]")
    return counts


def phase_eval_parity(card: str, dtype: str = "float32", ref=None,
                      cfg=None, data=None, label=None):
    """evaluate_frames over 2 frames of the synthetic scene at 64x64 with
    the full-width model in the compute dtype, on the card and on the CPU
    (plain versions), the same seeded weights: per-frame rgb and metrics;
    in bf16 also against ref (the CPU's float32 frames, this phase's
    float32 result).  cfg and data (2 frames) replace the synthetic scene's
    (phase g: a ZJU eval item).  Returns the CPU frames."""
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.cli.run import evaluate_frames
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset
    from transhuman_tpu_torch.evals.evaluator import Evaluator
    from transhuman_tpu_torch.testing import init_weights

    if data is None:
        cfg = Config().merge_opts(["H", "128", "W", "128",
                                   "test.frame_interval", "4",
                                   "compute_dtype", dtype])
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
    bf16 = dtype == "bfloat16"
    rgb_tol, psnr_tol, ssim_tol = ((BF16_RGB_TOL, BF16_PSNR_TOL, 5e-3)
                                   if bf16 else (2e-3, 0.05, 2e-3))
    label = label or ("12 bf16 eval parity" if bf16 else "8 eval parity")
    order = [int(x) for x in data.frame_sampler_indices()]
    for j, ((i, rgb_g, psnr_g, ssim_g), (_, rgb_c, psnr_c, ssim_c)) in \
            enumerate(zip(fg, fc)):
        item = data.get_eval_item(order[j])
        bad = _unstable_rays(pipe_g, item.frame.to("cuda"),
                             item.eval_rays.rays.to("cuda"))
        err = float(np.abs(rgb_g - rgb_c)[~bad].max())
        d_psnr, d_ssim = abs(psnr_g - psnr_c), abs(ssim_g - ssim_c)
        # phase 4's rgb limit, 2e-3 off cull/kNN near-ties.  Near-ties are
        # counted among the rays compared (those in the body box), where
        # the synthetic body puts 86 of 799 (10.8%); fewer than 15% may be
        # excluded.  PSNR and SSIM take every ray: 2e-3 on each colour moves
        # an MSE of ~0.1 by <= 2e-3 * 2 * 0.3 (the mean |error|) + 4e-6,
        # ~0.05 dB; SSIM's windows move by the same order, so 2e-3 (in bf16
        # the limits of phase 12's render, and SSIM 5e-3)
        check(bad.mean() < 0.15,
              f"eval parity f{i}: {int(bad.sum())} of {bad.size} rays at a "
              "near-tie, 15% or more")
        check(err <= rgb_tol, f"eval parity f{i}: max |d rgb| {err} > "
              f"{rgb_tol}")
        check(d_psnr <= psnr_tol and d_ssim <= ssim_tol,
              f"eval parity f{i}: |d psnr| {d_psnr}, |d ssim| {d_ssim}")
        extra = ""
        if bf16:
            a, b = _closer(f"bf16 eval parity f{i}", rgb_g[~bad], rgb_c[~bad],
                           ref[j][1][~bad])
            extra = f"; mean |d rgb| {a:.3g} vs CPU bf16 - float32 {b:.3g}"
        log(f"[{label}] 64x64 full-width frame {i} in {dtype}, CUDA vs CPU: "
            f"max |d rgb| {err:.3g} over {int((~bad).sum())} rays "
            f"({int(bad.sum())} of {bad.size}, {100 * bad.mean():.1f}%, at a "
            f"near-tie excluded); psnr {psnr_g:.6f} "
            f"vs {psnr_c:.6f}, ssim {ssim_g:.6f} vs {ssim_c:.6f}{extra}  "
            f"[{card}]")
    return fc


def phase_eval(card: str, ckpt: str, tmp: str, dtype: str = "float32"):
    """The run entry point at full width on the train phase's checkpoint,
    in the compute dtype: --type evaluate over EVAL_FRAMES frames at
    512x512 (counters reset just before, read just after); in float32 then
    the gather A/B and --type visualize over 2 frames; the files they write
    are checked."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset

    res = os.path.join(tmp, f"result_{dtype}")
    opts = ["result_dir", res, "test.frame_interval",
            str(8 // EVAL_FRAMES), "compute_dtype", dtype]
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
    f = forms(dtype)
    check_launches(f"evaluate ({dtype})", counts,
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
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
    label = "9 evaluate" if dtype == "float32" else "13 bf16 evaluate"
    log(f"[{label}] full width in {dtype}, {EVAL_FRAMES} frames of 512x512 "
        f"({n_rays} rays x 64 samples each): psnr "
        f"{summary['psnr']:.4f}, ssim {summary['ssim']:.4f}; render "
        f"{', '.join(f'{x:.1f}' for x in render_ms)} ms per frame; "
        f"frame to frame in the loop "
        f"{', '.join(f'{x:.1f}' for x in cadence)} ms; whole entry point "
        f"{wall:.1f} s (model build and the first frame included); host "
        f"eval rays {', '.join(f'{x:.1f}' for x in ray_ms)} ms per frame; "
        f"launches {counts}; peak device memory {peak:.3f} GiB; "
        f"{len(files)} files written  [{card}]")
    if dtype != "float32":
        return counts

    gather_ab(card, cfg, data, ckpt)

    vis_data = SyntheticDataset(cfg, "test", n_frames=2,
                                image_hw=(512, 512))
    assembly = []
    with timed_videos(assembly):
        paths = run_cli.main(["--type", "visualize", "--device", "cuda",
                              "--weights", ckpt, *opts], dataset=vis_data)
    check(len(paths) == 2, f"visualize: {len(paths)} frames")
    for path in paths:
        with open(path, "rb") as f:
            head = f.read(24)
        check(head[:8] == b"\x89PNG\r\n\x1a\n"
              and head[16:24] == (512).to_bytes(4, "big") * 2,
              f"visualize: {path} is not a 512x512 PNG")
    videos = check_videos("visualize", paths)
    (sec, n), = assembly
    log(f"[9 visualize] {len(paths)} frames written: "
        f"{', '.join(os.path.relpath(p, res) for p in paths)}; videos "
        f"{ {os.path.relpath(k, res): v for k, v in videos.items()} } "
        f"(frames, bytes); AVI assembly {sec:.3f} s for {n} frames, "
        f"{sec / n:.4f} s a frame  [{card}]")
    return counts


def gather_ab(card: str, cfg, data, ckpt: str):
    """One 512x512 eval frame rendered with the sampling forward through K4
    and through its plain twin on the card, in turns (plain, K4, K4, plain),
    synchronised: what K4 moves end to end.  Every fetch of a K4 render
    must be a launch of the sampling form, and a plain render must launch
    none.  Outside the counted run."""
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.kernels import gather
    from transhuman_tpu_torch.weights import load_checkpoint_file

    model, pipe, _, _ = build_runtime(cfg, torch.device("cuda"),
                                      smpl=data.smpl)
    load_checkpoint_file(model, ckpt)
    item = data.get_eval_item(0)
    frame, rays = item.frame.to("cuda"), item.eval_rays.rays.to("cuda")
    kernel, sample_cuda = gather.feature_sample, gather.feature_sample_cuda
    calls = []

    def counted(*args, **kwargs):
        calls.append(1)
        return sample_cuda(*args, **kwargs)

    def render(fn):
        gather.feature_sample, gather.feature_sample_cuda = fn, counted
        calls.clear()
        n0 = gather.feature_gather_cuda.launches
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = pipe.render_frame(frame, rays)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        finally:
            gather.feature_sample, gather.feature_sample_cuda = (kernel,
                                                                 sample_cuda)
        launched = gather.feature_gather_cuda.launches - n0
        if fn is kernel:
            check(len(calls) > 0 and launched == len(calls),
                  f"gather A/B: a K4 render made {launched} K4 launches, "
                  f"{len(calls)} of the sampling form")
        else:
            check(launched == 0 and not calls,
                  f"gather A/B: a plain render launched K4 {launched} times")
        return ms, out["rgb_map"], launched

    render(kernel)  # warm-up
    times = {"plain": [], "K4": []}
    for tag, fn in (("plain", gather.feature_sample_plain), ("K4", kernel),
                    ("K4", kernel), ("plain", gather.feature_sample_plain)):
        ms, rgb, launched = render(fn)
        times[tag].append(ms)
        if tag == "plain":
            rgb_plain = rgb
        else:
            rgb_k4, k4_launches = rgb, launched
    err = float((rgb_plain - rgb_k4).abs().max())
    check(err <= 2e-3, f"gather A/B: the two renders differ by {err}")
    log(f"[9 evaluate] one 512x512 frame, render ms with the forward fetch "
        f"plain {times['plain'][0]:.1f}, K4 {times['K4'][0]:.1f}, K4 "
        f"{times['K4'][1]:.1f}, plain {times['plain'][1]:.1f} (in that "
        f"order); {k4_launches} sampling-form launches per K4 render, none "
        f"plain; max |d rgb| {err:.3g}  [{card}]")
    del model, pipe


def _clear_threshold(sig_a, sig_b, target: float, margin: float = 1e-3):
    """An iso-level near target that lies farther than margin from every
    sigma of both grids and between no point's two sigmas: the two meshes'
    inside/outside decisions then agree everywhere."""
    lo = np.minimum(sig_a, sig_b).ravel() - margin
    hi = np.maximum(sig_a, sig_b).ravel() + margin
    order = np.argsort(lo)
    lo, hi = lo[order], np.maximum.accumulate(hi[order])
    # the free gaps between the merged forbidden intervals
    free = np.nonzero(lo[1:] > hi[:-1])[0]
    check(free.size > 0, "reconstruction parity: no free iso-level")
    mids = (lo[free + 1] + hi[free]) / 2
    return float(mids[np.argmin(np.abs(mids - target))])


def phase_recon_parity(card: str):
    """extract_mesh on the card and on the CPU (plain versions) with the
    same full-width weights, at RECON_PARITY_VOXEL: the sigma grids off
    cull/kNN near-ties, then both meshes at an iso-level no sigma is near."""
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset
    from transhuman_tpu_torch.mesh_ops.reconstruct import (
        extract_mesh,
        make_grid,
    )
    from transhuman_tpu_torch.testing import init_weights

    cfg = Config().merge_opts(["H", "128", "W", "128"])
    data = SyntheticDataset(cfg, "test", image_hw=(64, 64))
    frame, bounds, _ = data.get_mesh_item(0)
    vs = (RECON_PARITY_VOXEL,) * 3
    pipes, cubes = {}, {}
    for dev in ("cuda", "cpu"):
        model, pipe, _, _ = build_runtime(cfg, torch.device(dev),
                                          smpl=data.smpl)
        init_weights(model, torch.Generator().manual_seed(cfg.seed))
        pipes[dev] = pipe
        cubes[dev] = extract_mesh(pipe, frame, bounds, vs)[2]
    pad = 10
    sg, sc = (cubes[d][pad:-pad, pad:-pad, pad:-pad].ravel()
              for d in ("cuda", "cpu"))
    frame_d = frame.to("cuda")
    pts = torch.from_numpy(make_grid(bounds, vs).reshape(-1, 3)).cuda()
    bad = _unstable_points(pipes["cuda"], frame_d, pts).cpu().numpy()
    err = float(np.abs(sg - sc)[~bad].max())
    n_surv = int((sc != 0).sum())
    check(bad.mean() < 0.05, f"reconstruction parity: {int(bad.sum())} of "
          f"{bad.size} grid points at a near-tie, 5% or more")
    check(err <= RECON_SIGMA_TOL, f"reconstruction parity: max |d sigma| "
          f"{err} > {RECON_SIGMA_TOL}")
    check(n_surv > 0, "reconstruction parity: no grid point survives")
    # what the bound reads on a faulty fetch or binding: the card's sigma
    # with every projection half a pixel off (a texel-centre slip in the
    # fetch), and with one neighbour fewer bound
    K = frame_d.K.clone()
    K[:, 0, 2] += 0.5
    knn_k, fault_err = pipes["cuda"].model.knn_k, {}
    faults = {
        "fetch half a pixel off": (dataclasses.replace(frame_d, K=K), knn_k),
        f"binding of {knn_k - 1} of {knn_k} neighbours": (frame_d, knn_k - 1),
    }
    for name, (fr, k) in faults.items():
        pipes["cuda"].model.knn_k = k
        try:
            s = pipes["cuda"].render_sigma(fr, pts).cpu().numpy()
        finally:
            pipes["cuda"].model.knn_k = knn_k
        fault_err[name] = float(np.abs(s - sc)[~bad].max())
        check(fault_err[name] > RECON_SIGMA_TOL,
              f"reconstruction parity: a {name} reads max |d sigma| "
              f"{fault_err[name]}, within the bound {RECON_SIGMA_TOL}")
    th = _clear_threshold(sg, sc, float(np.median(sc[sc != 0])))
    meshes = {d: extract_mesh(pipes[d], frame, bounds, vs, mesh_th=th)
              for d in ("cuda", "cpu")}
    (vg, tg, _), (vc, tc, _) = meshes["cuda"], meshes["cpu"]
    check(len(tg) > 0, "reconstruction parity: the mesh is empty")
    check(vg.shape == vc.shape and tg.shape == tc.shape,
          f"reconstruction parity: meshes of {len(vg)} / {len(vc)} vertices "
          f"and {len(tg)} / {len(tc)} triangles")
    check(np.array_equal(tg, tc),
          "reconstruction parity: the triangles differ")
    v_err = float(np.abs(vg - vc).max())
    log(f"[10 reconstruction parity] full width, grid {sg.size} points at "
        f"{vs[0]} m: max |d sigma| {err:.3g} (bound {RECON_SIGMA_TOL}; "
        f"survivors' sigma {float(sc[sc != 0].min()):.4f} to "
        f"{float(sc.max()):.4f}) over {int((~bad).sum())} points "
        f"({int(bad.sum())}, {100 * bad.mean():.2f}%, at a cull/kNN "
        f"near-tie excluded), {n_surv} survivors; the bound reads "
        + ", ".join(f"{v:.3g} with a {k}" for k, v in fault_err.items())
        + f"; at iso-level {th:.6g}: {len(vg)} vertices, "
        f"{len(tg)} triangles on both, the same triangles, max |d vertex| "
        f"{v_err:.3g} m  [{card}]")


def phase_reconstruction(card: str, ckpt: str, tmp: str,
                         dtype: str = "float32"):
    """The run entry point at full width on the train phase's checkpoint,
    in the compute dtype: --type reconstruction at voxel_size RECON_VOXEL
    over the synthetic body's box, with mesh_th a low quantile of a first
    sigma pass's survivors (a 5-step checkpoint's sigma does not reach the
    default 20), counters reset just before and read just after, the sigma
    pass, the marching and the PLY write timed apart; in float32 also K1
    over the whole grid and then --type light_stage on the written mesh."""
    import warnings

    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset
    from transhuman_tpu_torch.mesh_ops import ply, reconstruct
    from transhuman_tpu_torch.render.pipeline import RenderPipeline
    from transhuman_tpu_torch.tools import voxelize_mesh
    from transhuman_tpu_torch.weights import load_checkpoint_file

    res = os.path.join(tmp, f"result_{dtype}")
    vs = f"{RECON_VOXEL},{RECON_VOXEL},{RECON_VOXEL}"
    label = ("11 reconstruction" if dtype == "float32"
             else "13 bf16 reconstruction")
    cfg = Config().merge_opts(["voxel_size", vs, "compute_dtype", dtype])
    data = SyntheticDataset(cfg, "test", image_hw=(512, 512))
    frame, bounds, _ = data.get_mesh_item(0)
    grid = reconstruct.make_grid(bounds, cfg.voxel_size)
    model, pipe, _, _ = build_runtime(cfg, torch.device("cuda"),
                                      smpl=data.smpl)
    load_checkpoint_file(model, ckpt)
    pts = torch.from_numpy(grid.reshape(-1, 3)).cuda()
    frame_d = frame.to("cuda")
    pipe.render_sigma(frame_d, pts)  # warm-up
    # the host syncs of one sigma pass: the compaction's, not one a chunk
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t = time.perf_counter()
            sigma = pipe.render_sigma(frame_d, pts)
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t) * 1e3
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch's one-time notice that the debug mode is a prototype is not one
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    st = dict(pipe.last_frame_stats)
    n_chunks = -(-st["survivors"] // (pipe.chunk_rays * pipe.n_samples))
    check(syncs <= 1, f"reconstruction: {syncs} host syncs in a sigma pass "
          f"of {n_chunks} chunks, more than the compaction's one")
    sig = sigma.cpu().numpy()
    qs = (0.0, 0.001, 0.01, 0.5, 0.99, 1.0)
    qv = np.quantile(sig[sig != 0], qs)
    mesh_th = float(qv[1])
    check(sigma.dtype == torch.float32, f"reconstruction: sigma {sigma.dtype}")
    log(f"[{label}] grid {'x'.join(map(str, grid.shape[:3]))} = "
        f"{st['points']} points at {RECON_VOXEL} m, survivor fraction "
        f"{st['survivors'] / st['points']:.4f} ({n_chunks} chunks); sigma "
        f"pass {first_ms:.1f} ms with {syncs} host sync(s); survivors' sigma "
        f"quantiles {dict(zip(qs, (round(float(x), 4) for x in qv)))}; "
        f"mesh_th {mesh_th:.6g} (the 0.001 quantile)  [{card}]")
    k1_grid = None
    if dtype == "float32":
        k1_grid = check_cull_grid(card, frame_d, pts, pipe.cull_distance,
                                  st["survivors"])
    del model, pipe, sigma, pts, frame_d

    stages = {"sigma": [], "march": [], "ply": []}
    sig_fn = RenderPipeline.render_sigma
    march_fn, ply_fn = reconstruct.marching_tetrahedra, ply.save_ply
    marched = []  # the marching's (cube, iso-level) and its mesh

    def timed(key, fn, sync=False):
        def wrapper(*args, **kwargs):
            if sync:
                torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                torch.cuda.synchronize()
            stages[key].append((time.perf_counter() - t) * 1e3)
            if key == "march":
                marched.append((args, out))
            return out
        return wrapper

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    RenderPipeline.render_sigma = timed("sigma", sig_fn, sync=True)
    reconstruct.marching_tetrahedra = timed("march", march_fn)
    ply.save_ply = timed("ply", ply_fn)
    t0 = time.perf_counter()
    try:
        paths = run_cli.main(["--type", "reconstruction", "--device", "cuda",
                              "--weights", ckpt, "result_dir", res,
                              "voxel_size", vs, "mesh_th", repr(mesh_th),
                              "compute_dtype", dtype], dataset=data)
    finally:
        RenderPipeline.render_sigma = sig_fn
        reconstruct.marching_tetrahedra, ply.save_ply = march_fn, ply_fn
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(len(paths) == 1 and all(len(v) == 1 for v in stages.values()),
          f"reconstruction: {len(paths)} meshes, stages {stages}")
    verts, tris = ply.load_ply(paths[0])
    lo = bounds[0] - 10 * RECON_VOXEL - 1e-4
    hi = bounds[1] + 10 * RECON_VOXEL + 1e-4
    check(len(tris) > 0 and np.isfinite(verts).all()
          and int(tris.min()) >= 0 and int(tris.max()) < len(verts)
          and (verts >= lo).all() and (verts <= hi).all(),
          f"reconstruction: a bad mesh of {len(verts)} vertices, "
          f"{len(tris)} triangles")
    # one K1 launch over the grid; per chunk of survivors one K4 and one K2
    # launch; one more K4 launch for the painting fetch
    f = forms(dtype)
    want = dict.fromkeys(counts, 0)
    want.update({"min_excess2": 1, f["dparf"]: n_chunks,
                 f["fetch"]: n_chunks + 1})
    check(counts == want, f"reconstruction: launches {counts}, want {want}")
    size = os.path.getsize(paths[0]) / 2**20
    log(f"[{label}] cli.run --type reconstruction in {dtype}: sigma pass "
        f"{stages['sigma'][0]:.1f} ms, marching {stages['march'][0]:.1f} ms, "
        f"PLY write {stages['ply'][0]:.1f} ms ({size:.1f} MiB), whole "
        f"command {wall:.2f} s (model build included); {len(verts)} "
        f"vertices, {len(tris)} triangles; launches {counts}; peak device "
        f"memory {peak:.3f} GiB  [{card}]")
    if dtype != "float32":
        return counts, k1_grid
    check_marching_routes(card, marched[0], stages["march"][0], wall, ckpt,
                          res, vs, mesh_th, data)
    mesh_video(card, paths[0], tmp)

    vox_fn, vox_ms = voxelize_mesh.voxelize, []

    def timed_vox(*args, **kwargs):
        t = time.perf_counter()
        out = vox_fn(*args, **kwargs)
        vox_ms.append((time.perf_counter() - t) * 1e3)
        return out

    voxelize_mesh.voxelize = timed_vox
    t0 = time.perf_counter()
    try:
        occ_path = run_cli.main(["--type", "light_stage", "--ply", paths[0],
                                 "voxel_size", vs])
    finally:
        voxelize_mesh.voxelize = vox_fn
    wall = time.perf_counter() - t0
    d = np.load(occ_path, allow_pickle=True).item()
    occ = d["occupancy"]
    check(d["voxel"] == RECON_VOXEL and occ.any(),
          f"light_stage: voxel {d['voxel']}, {int(occ.sum())} cells filled")
    check(not any(occ.take(i, axis=a).any() for a in range(3)
                  for i in (0, -1)), "light_stage: a boundary cell is filled")
    log(f"[11 light_stage] cli.run --type light_stage at {RECON_VOXEL} m: "
        f"grid {'x'.join(map(str, occ.shape))}, {int(occ.sum())} cells "
        f"filled ({100 * occ.mean():.2f}%), no boundary cell; voxelize "
        f"(surface sampling and flood fill) {vox_ms[0]:.1f} ms, whole "
        f"command {wall:.2f} s  [{card}]")
    return counts, k1_grid


def check_marching_routes(card: str, marched, native_ms: float,
                          native_s: float, ckpt: str, res: str, vs: str,
                          mesh_th: float, data):
    """Phase 11's command once more with the numpy marching route, timed
    alone and as the whole command; its mesh against the C++ route's on the
    same cube: the same sorted vertex set within 1e-6 grid units, the same
    triangle count."""
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.mesh_ops import reconstruct

    (cube, th), (v_cc, t_cc) = marched
    march, rerun = reconstruct.marching_tetrahedra, []

    def numpy_route(cube2, th2):
        t = time.perf_counter()
        out = march(cube2, th2, use_native=False)
        rerun.append((cube2, (time.perf_counter() - t) * 1e3, out))
        return out

    reconstruct.marching_tetrahedra = numpy_route
    t0 = time.perf_counter()
    try:
        run_cli.main(["--type", "reconstruction", "--device", "cuda",
                      "--weights", ckpt, "result_dir", res, "voxel_size", vs,
                      "mesh_th", repr(mesh_th)], dataset=data)
    finally:
        reconstruct.marching_tetrahedra = march
    torch.cuda.synchronize()
    numpy_s = time.perf_counter() - t0
    (cube2, numpy_ms, (v_np, t_np)), = rerun
    same_cube = np.array_equal(cube2, cube)
    if not same_cube:  # the C++ route on the rerun's own cube
        v_cc, t_cc = march(cube2, th)

    def rows(v):
        return v[np.lexsort(v.T[::-1])]

    err = (float(np.abs(rows(v_cc) - rows(v_np)).max()) if len(v_cc)
           and len(v_cc) == len(v_np) else float("inf"))
    check(len(t_cc) == len(t_np) > 0 and err <= 1e-6,
          f"marching: C++ {len(v_cc)} vertices, {len(t_cc)} triangles; "
          f"numpy {len(v_np)}, {len(t_np)}; max |d vertex| {err}")
    log(f"[11 marching] cube {'x'.join(map(str, cube.shape))}: C++ route "
        f"{native_ms:.1f} ms, numpy route {numpy_ms:.1f} ms "
        f"({numpy_ms / native_ms:.1f}x); {len(v_cc)} vertices, {len(t_cc)} "
        f"triangles on both, sorted vertices within {err:.3g} grid units "
        f"(the rerun's sigma cube {'equal to' if same_cube else 'unlike'} "
        f"the first's); the reconstruction command {native_s:.2f} s on the "
        f"C++ route, {numpy_s:.2f} s on the numpy route  [{card}]")


def mesh_video(card: str, ply_path: str, tmp: str):
    """tools/render_mesh_video on phase 11's PLY, four frames along the
    spherical path of the laid-out ZJU cameras at 512x512: each frame
    rasterized (C++), written as PNG, and assembled into the AVI; timed."""
    from transhuman_tpu_torch.tools import render_mesh_video

    d = os.path.join(tmp, "mesh_video")
    os.makedirs(os.path.join(d, "ply"), exist_ok=True)
    for i in range(4):
        os.link(ply_path, os.path.join(d, "ply", f"frame{i}.ply"))
    np.save(os.path.join(d, "annots.npy"), {"cams": _zju_cameras(ZJU_CAMS),
                                            "ims": []})
    t0 = time.perf_counter()
    out = render_mesh_video.main([
        "--mesh_dir", os.path.join(d, "ply"), "--annots",
        os.path.join(d, "annots.npy"), "--render_views", "4",
        os.path.join(d, "out")])
    sec = time.perf_counter() - t0
    jpgs = avi_frames(out)
    lit = []
    for i in range(4):
        from transhuman_tpu_torch.data.image_io import read_png

        img = read_png(os.path.join(d, "out", f"mesh{i:04d}.png"))
        lit.append(float(img.any(-1).mean()))
    check(len(jpgs) == 4 and all(x > 0.01 for x in lit),
          f"mesh video: {len(jpgs)} AVI frames, lit fractions {lit}")
    log(f"[11 mesh video] tools/render_mesh_video, 4 frames of 512x512 "
        f"from the phase's PLY: {sec:.2f} s, {sec / 4:.3f} s a frame "
        f"(rasterize, PNG, AVI); lit fraction per frame "
        f"{', '.join(f'{x:.3f}' for x in lit)}; "
        f"{os.path.getsize(out)} bytes  [{card}]")


def check_cull_grid(card: str, frame, pts_world, cull_distance: float,
                    survivors: int) -> dict:
    """K1 at the shape the reconstruction path gives it, the whole grid in
    one launch, against its plain version run on the card in slabs, at
    phase 3's tolerance, and timed beside its bound.  frame and points on
    the card; survivors is what the sigma pass kept."""
    from transhuman_tpu_torch.kernels import cull
    from transhuman_tpu_torch.render.pipeline import to_smpl

    # the cull's inputs as render_sigma forms them
    pts = to_smpl(frame, pts_world).contiguous()
    verts = frame.tar_verts_smpl.contiguous()
    zeros = torch.zeros(verts.shape[0], device=pts.device)
    slab = 8 * N_CHUNK

    def plain():
        return torch.cat([cull.min_excess2_plain(pts[a:a + slab], verts, zeros)
                          for a in range(0, pts.shape[0], slab)])

    d2_k = cull.min_excess2_cuda(pts, verts, zeros)
    d2_p = plain()
    torch.cuda.synchronize()
    err = float((d2_k - d2_p).abs().max())
    check(err <= 1e-4, f"K1 at the grid: max |d2 kernel - plain| = {err} "
          "> 1e-4")
    mask_k = d2_k < cull_distance**2
    check(int(mask_k.sum()) == survivors, f"K1 at the grid: "
          f"{int(mask_k.sum())} survivors, the sigma pass kept {survivors}")
    diff = mask_k != (torch.sqrt(d2_p) < cull_distance)
    far = (min_dist64(pts[diff], verts) - cull_distance).abs() >= 1e-5
    check(not bool(far.any()), f"K1 at the grid: {int(far.sum())} cull "
          "decisions differ farther than 1e-5 from the threshold")
    ms = time_ms(lambda: cull.min_excess2_cuda(pts, verts, zeros), iters=5,
                 warmup=1)
    plain_ms = time_ms(plain, iters=1, warmup=0)
    b = bound(nbytes(pts, verts, zeros, d2_k),
              7 * pts.shape[0] * verts.shape[0])
    log(f"[11 reconstruction] K1 min_excess2 at the grid, {pts.shape[0]} pts "
        f"x {verts.shape[0]} verts in one launch: max|dd2| {err:.3g}, "
        f"{int(diff.sum())} threshold flips within 1e-5; kernel {ms:.4f} ms, "
        f"plain (slabs of {slab}) {plain_ms:.4f} ms, bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}


# ------------------------------------------ config files, LPIPS, lifecycle
CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")
CFG_EPOCHS, CFG_EP_ITER = 2, 3  # phase b: 2 epochs of 3 steps, then 1 more
LPIPS_RTOL = 1e-4  # card against CPU, the distance and its input gradient


def write_weight_files(tmp: str) -> dict:
    """Seeded random stand-ins for the user's converted files, in the JAX
    package's npz layouts: LPIPS (13 VGG16 convs HWIO at He scale, 5
    non-negative lin heads) and the ResNet-18 encoder (through
    tools/convert_resnet.convert from torchvision-layout arrays)."""
    from transhuman_tpu_torch.models.lpips import VGG16_STAGES
    from transhuman_tpu_torch.models.network import TransHumanNet
    from transhuman_tpu_torch.tools.convert_resnet import convert

    rng = np.random.default_rng(2024)
    lp, c_in = {}, 3
    for si, (n_convs, ch) in enumerate(VGG16_STAGES):
        for ci in range(n_convs):
            lp[f"conv{si}_{ci}_w"] = (rng.standard_normal(
                (3, 3, c_in, ch)) * np.sqrt(2.0 / (9 * c_in))).astype(
                np.float32)
            lp[f"conv{si}_{ci}_b"] = (rng.standard_normal(ch) * 0.01).astype(
                np.float32)
            c_in = ch
        lp[f"lin{si}"] = np.abs(rng.standard_normal(ch) * 0.1).astype(
            np.float32)
    net = TransHumanNet(embed_dim=192, vit_depth=1, vit_heads=3)
    sd = {n[len("encoder.model."):]: (rng.standard_normal(tuple(p.shape))
                                     * (0.05 if p.dim() == 4 else 1.0)
                                     + (1.0 if n.endswith("bn1.weight")
                                        else 0.0)).astype(np.float32)
          for n, p in net.named_parameters()
          if n.startswith("encoder.model.")}
    files = {"lpips": os.path.join(tmp, "lpips_vgg16.npz"),
             "resnet": os.path.join(tmp, "resnet18.npz")}
    np.savez(files["lpips"], **lp)
    np.savez(files["resnet"], **convert(sd))
    return files


def eval_crop_hw() -> tuple:
    """The bbox crop of phase 9's first 512x512 eval frame."""
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset
    from transhuman_tpu_torch.evals.evaluator import bounding_rect

    item = SyntheticDataset(Config(), "test",
                            image_hw=(512, 512)).get_eval_item(0)
    _, _, w, h = bounding_rect(item.eval_rays.mask_at_box.reshape(512, 512))
    return h, w


def phase_lpips(card: str, path: str) -> dict:
    """a. LPIPS at full VGG16 widths on the card against the CPU, the
    distance and its input gradient, at the train patches (6 x 20 x 20)
    and at phase 9's eval crop; each timed on the card.  The input
    gradient is also held against the CPU's in float64: at the eval crop
    every float32 implementation (the CPU's, cuDNN's, PyTorch's own CUDA
    convolution) lies ~5e-3 of its norm from float64 (measured on one H100),
    so there the card must lie as near float64 as the CPU's float32 does,
    within a factor 2."""
    from transhuman_tpu_torch.models.lpips import LPIPS

    cpu, gpu = LPIPS.from_npz(path), LPIPS.from_npz(path).cuda()
    ref = LPIPS.from_npz(path).double()
    rng = np.random.default_rng(7)
    out = {}
    for name, shape in (("train", (6, 20, 20, 3)),
                        ("eval", (1, *eval_crop_hw(), 3))):
        x = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
        y = torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
        xc = x.clone().requires_grad_(True)
        dc = cpu(xc, y)
        dc.sum().backward()
        x64 = x.double().requires_grad_(True)
        ref(x64, y.double()).sum().backward()
        g64 = x64.grad
        xg = x.cuda().requires_grad_(True)
        yg = y.cuda()
        dg = gpu(xg, yg)
        dg.sum().backward()
        rel = float(((dg.detach().cpu() - dc.detach()).abs()
                     / dc.detach().abs()).max())
        grel = float((xg.grad.cpu() - xc.grad).norm() / xc.grad.norm())
        g_card = float((xg.grad.cpu().double() - g64).norm() / g64.norm())
        g_cpu = float((xc.grad.double() - g64).norm() / g64.norm())
        check(rel <= LPIPS_RTOL, f"LPIPS {name} {shape}: card vs CPU "
              f"distance rel {rel:.3g} (limit {LPIPS_RTOL})")
        check(g_card <= max(2 * g_cpu, LPIPS_RTOL)
              and (name != "train" or grel <= LPIPS_RTOL),
              f"LPIPS {name} {shape}: input gradient card vs CPU {grel:.3g} "
              f"of its norm; against float64 card {g_card:.3g}, CPU float32 "
              f"{g_cpu:.3g}")
        with torch.no_grad():
            fwd = time_ms(lambda: gpu(xg, yg))

        def fwd_bwd():
            xg.grad = None
            gpu(xg, yg).sum().backward()

        both = time_ms(fwd_bwd)
        out[name] = {"shape": shape, "fwd_ms": fwd, "fwd_bwd_ms": both,
                     "rel": rel, "grad_rel": grel}
        log(f"[a LPIPS] {name} {tuple(shape)} f32: card vs CPU distance rel "
            f"{rel:.3g}, input gradient {grel:.3g} of its norm (against "
            f"float64: card {g_card:.3g}, CPU {g_cpu:.3g}); forward "
            f"{fwd:.4f} ms, forward + input backward {both:.4f} ms  [{card}]")
    return out


def phase_train_cfg(card: str, tmp: str, files: dict, dtype: str):
    """b. The train entry point from --cfg_file configs/train_or_eval.yaml
    at full width with LPIPS and the pretrained encoder, in dtype: epochs
    saved (latest.pth, 0.pth, 1.pth), lpips_loss in every step, the
    encoder's first convolution the npz's before the first step, the saved
    parameters the trained ones bit for bit; a second call with one more
    epoch resumes with the step and lr carried; then --test.  Returns
    (the first call's launch counts, its model directory)."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.train.schedule import (
        warmup_cosine_epoch_schedule,
    )

    root = os.path.join(tmp, f"cfg_{dtype}")
    mdir = os.path.join(root, "tm", "transhuman", "transhuman_tpu")
    opts = ["--device", "cuda", "--cfg_file",
            os.path.join(CONFIGS, "train_or_eval.yaml"), "dataset",
            "synthetic", "lpips_weights", files["lpips"], "encoder_weights",
            files["resnet"], "ep_iter", str(CFG_EP_ITER), "save_freq", "1",
            "compute_dtype", dtype, "trained_model_dir",
            os.path.join(root, "tm"), "record_dir", os.path.join(root, "rec"),
            "result_dir", os.path.join(root, "res")]
    with np.load(files["resnet"]) as z:
        want_conv1 = torch.from_numpy(np.ascontiguousarray(
            np.transpose(z["conv1/kernel"], (3, 2, 0, 1))))
    build, seen = train_cli.build_trainer, {}

    def checked(cfg, device, dataset=None, ckpt=None):
        out = build(cfg, device, dataset, ckpt)
        if ckpt is None:  # before the first step of the fresh run
            seen["conv1"] = torch.equal(
                out[0].model.encoder.model.conv1.weight.detach().cpu(),
                want_conv1)
        return out

    train_cli.build_trainer = checked
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        state, recs = train_cli.main(opts + ["train.epoch", str(CFG_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        state2, recs2 = train_cli.main(
            opts + ["train.epoch", str(CFG_EPOCHS + 1)])
    finally:
        train_cli.build_trainer = build
    n = CFG_EPOCHS * CFG_EP_ITER
    check(seen.get("conv1") is True, "train cfg: the encoder's first "
          "convolution is not the npz's before the first step")
    check([r["step"] for r in recs] == list(range(n)),
          f"train cfg: steps {[r['step'] for r in recs]}")
    check(all(np.isfinite(r["lpips_loss"]) and r["lpips_loss"] > 0
              for r in recs + recs2), "train cfg: an lpips_loss is not "
          "finite and above 0")
    check(state.model.compute_dtype == COMPUTE[dtype],
          f"train cfg: the model computes in {state.model.compute_dtype}")
    files_written = sorted(os.listdir(mdir))
    check({"latest.pth", "0.pth", "1.pth"} <= set(files_written),
          f"train cfg: {files_written}")
    f = forms(dtype)
    check_launches(f"train cfg ({dtype})", counts,
                   {f["dparf"]: n, f["scatter"]: 2 * n, f["fetch"]: 2 * n})
    blob = torch.load(os.path.join(mdir, "1.pth"), map_location="cpu",
                      weights_only=True)
    check(all(torch.equal(blob["net"][k], v.cpu()) for k, v in
              state.model.state_dict().items())
          and (blob["epoch"], blob["step"]) == (CFG_EPOCHS - 1, n),
          "train cfg: 1.pth is not the trained state")
    sch = warmup_cosine_epoch_schedule(7e-4, 1e-6, 300, 3000, CFG_EP_ITER)
    check([r["step"] for r in recs2] == list(range(n, n + CFG_EP_ITER))
          and state2.step == n + CFG_EP_ITER
          and abs(recs2[0]["lr"] - sch(n)) <= 1e-6 * sch(n),
          f"train cfg: the resumed run's steps "
          f"{[r['step'] for r in recs2]}, step {state2.step}, lr "
          f"{recs2[0]['lr']} (lr({n}) = {sch(n)})")
    t0 = time.perf_counter()
    val, summary = train_cli.main(["--test"] + opts)
    val_s = time.perf_counter() - t0
    check(np.isfinite(val["img_loss"]) and summary["lpips"] is not None
          and np.isfinite(summary["lpips"]),
          f"train cfg --test: {val} {summary}")
    step_ms = [r["step_s"] * 1e3 for r in recs]
    lp_losses = [r["lpips_loss"] for r in recs]
    saves = [r["save_s"] for r in recs + recs2 if "save_s" in r]
    log(f"[b train cfg] --cfg_file train_or_eval.yaml in {dtype}, full width "
        f"(3 views 512x512, 2400 rays x 64 samples) with LPIPS and the "
        f"pretrained encoder: {len(recs)} steps in {wall:.1f} s (build "
        f"included), median step {float(np.median(step_ms[1:])):.1f} ms over "
        f"steps 1-{len(recs) - 1} (steps "
        f"{', '.join(f'{x:.1f}' for x in step_ms)} ms), lpips_loss "
        f"{', '.join(f'{x:.5f}' for x in lp_losses)}; "
        f"peak device memory {peak:.3f} GiB; epoch saves "
        f"{', '.join(f'{s:.3f}' for s in saves)} s; files {files_written}; "
        f"resumed at epoch {CFG_EPOCHS} (step {recs2[0]['step']}, lr "
        f"{recs2[0]['lr']:.4g}); --test in {val_s:.1f} s: img_loss "
        f"{val['img_loss']:.5f}, psnr {summary['psnr']:.4f}, lpips "
        f"{summary['lpips']:.5f}; launches {counts}  [{card}]")
    return counts, os.path.join(root, "tm")


def phase_eval_cfg(card: str, tmp: str, model_root: str, files: dict):
    """c. The run entry point from the config files on phase b's bf16
    checkpoint directory (no --weights): --type evaluate from
    train_or_eval.yaml over EVAL_FRAMES frames with the LPIPS column and
    without it, --type visualize from performance.yaml (2 frames) and
    --type reconstruction from reconstruction.yaml (mesh_th 5, below the
    random model's sigma); counters reset just before each and read just
    after.  Returns {path: launch counts}."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset

    res = os.path.join(tmp, "cfg_result")
    common = ["--device", "cuda", "dataset", "synthetic",
              "trained_model_dir", model_root, "result_dir", res]
    f = forms("bfloat16")
    by_path, cadence = {}, {}
    for tag, lp in (("eval_cfg_bf16", files["lpips"]), ("eval_cfg_nolpips",
                                                         "")):
        stamps = []

        def stamp(item, out):
            stamps.append(time.perf_counter())
            return {}

        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        summary = run_cli.main(
            ["--type", "evaluate", "--cfg_file",
             os.path.join(CONFIGS, "train_or_eval.yaml"), *common,
             "lpips_weights", lp, "test.frame_interval",
             str(8 // EVAL_FRAMES)], per_frame=stamp)
        torch.cuda.synchronize()
        by_path[tag] = kernels.launch_counts()
        check(len(stamps) == EVAL_FRAMES, f"{tag}: {len(stamps)} frames")
        check_launches(tag, by_path[tag], {"min_excess2": 1, f["dparf"]: 1,
                                           f["fetch"]: 1})
        check((summary["lpips"] is not None and np.isfinite(summary["lpips"]))
              == bool(lp), f"{tag}: summary {summary}")
        cadence[tag] = np.diff(stamps)[:-1] * 1e3
        log(f"[c evaluate cfg] --cfg_file train_or_eval.yaml (bf16), "
            f"{EVAL_FRAMES} frames of 512x512 "
            f"{'with' if lp else 'without'} the LPIPS column: psnr "
            f"{summary['psnr']:.4f}, ssim {summary['ssim']:.4f}, lpips "
            f"{summary['lpips']}; frame to frame "
            f"{', '.join(f'{x:.1f}' for x in cadence[tag])} ms; launches "
            f"{by_path[tag]}  [{card}]")
    text = open(os.path.join(res, "epoch_-1", "debug", "summary.txt")).read()
    check("lpips: n/a" in text, "evaluate cfg: the run without weights "
          f"wrote {text!r}")
    pcfg = Config.from_yaml(os.path.join(CONFIGS, "performance.yaml"),
                            ["dataset", "synthetic"])
    vis_data = SyntheticDataset(pcfg, "test", n_frames=2, image_hw=(512, 512))
    kernels.reset_launch_counts()
    paths = run_cli.main(["--type", "visualize", "--cfg_file",
                          os.path.join(CONFIGS, "performance.yaml"),
                          *common], dataset=vis_data)
    torch.cuda.synchronize()
    by_path["visualize_cfg_bf16"] = kernels.launch_counts()
    check(len(paths) == 2 and all("perform" in p for p in paths),
          f"visualize cfg: {paths}")
    check_launches("visualize cfg", by_path["visualize_cfg_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    videos = check_videos("visualize cfg", paths)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    meshes = run_cli.main(["--type", "reconstruction", "--device", "cuda",
                           "--cfg_file",
                           os.path.join(CONFIGS, "reconstruction.yaml"),
                           *common[2:], "mesh_th", "5"])
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    by_path["reconstruction_cfg_bf16"] = kernels.launch_counts()
    from transhuman_tpu_torch.mesh_ops.ply import load_ply

    v, t = load_ply(meshes[0])
    check(len(meshes) == 1 and len(t) > 100 and "/mesh/" in meshes[0],
          f"reconstruction cfg: {meshes} ({len(t)} triangles)")
    check_launches("reconstruction cfg", by_path["reconstruction_cfg_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    log(f"[c visualize / reconstruction cfg] performance.yaml: "
        f"{len(paths)} frames ({', '.join(os.path.relpath(p, res) for p in paths)}), "
        f"videos {list(videos.values())} (frames, bytes); "
        f"reconstruction.yaml at 0.005 m, mesh_th 5: {len(v)} verts, "
        f"{len(t)} tris in {recon_s:.1f} s (build included)  [{card}]")
    return by_path


# ----------------------------------------------- ZJU-MoCap loader, codec
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "torch_zju")
ZJU_CAMS = 23  # cameras on set (the regular layout)
ZJU_TRAIN_STEPS = 12  # per dtype and dataset in phase f: past the loader's prefill
ZJU_EVAL_FRAMES = 2  # frames of CoreView_387 laid out for phase g


def phase_codec(card: str) -> dict:
    """e. Each committed fixture decoded by the port's codec (built in
    phase 2 with g++ from transhuman_tpu_torch/native), its bytes held
    against the sha256 of cv2's or imageio's decode recorded in
    digests.json; each decode timed on the host, median of 20; the event
    files' CRC32C, native against the Python table."""
    import hashlib

    from transhuman_tpu_torch.data import image_io

    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    out = {}
    for name, want in sorted(digests.items()):
        path = os.path.join(FIXTURES, name)
        read = image_io.imread_rgb if name.endswith(".jpg") else \
            image_io.read_png
        img = read(path)
        got = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
        check(got == want["sha256"] and list(img.shape) == want["shape"],
              f"codec: {name} decodes to {got[:12]}.. {img.shape}, want "
              f"{want['sha256'][:12]}.. {want['shape']} ({want['by']})")
        ms = []
        for _ in range(20):
            t = time.perf_counter()
            read(path)
            ms.append((time.perf_counter() - t) * 1e3)
        out[name] = float(np.median(ms))
    # the event files' CRC32C: the native library against the Python table
    from transhuman_tpu_torch.utils import tb_writer

    buf = np.random.default_rng(0).integers(0, 256, 16 << 20,
                                            np.uint8).tobytes()
    check(tb_writer.crc32c(buf[:1 << 20]) == tb_writer.crc32c_table(
        buf[:1 << 20]), "crc32c: the native library and the table differ")
    t = time.perf_counter()
    tb_writer.crc32c(buf)
    crc_native = len(buf) / 2**20 / (time.perf_counter() - t)
    t = time.perf_counter()
    tb_writer.crc32c_table(buf[:1 << 20])
    crc_table = 1.0 / (time.perf_counter() - t)
    log(f"[e crc32c] native {crc_native:.0f} MB/s over 16 MiB, the Python "
        f"table {crc_table:.2f} MB/s over 1 MiB (host)  [{card}]")
    log(f"[e codec] every fixture equals "
        f"{', '.join(sorted({d['by'] for d in digests.values()}))} bit for "
        f"bit; host ms per decode (median of 20): "
        + ", ".join(f"{k} {v:.2f}" for k, v in out.items()) + f"  [{card}]")
    return out


def _zju_cameras(n: int, hw=(1024, 1024)):
    """n cameras on a 3 m ring around the origin, facing it, ZJU-like
    intrinsics; D non-zero on three in four."""
    h, w = hw
    cams = {"K": [], "D": [], "R": [], "T": []}
    for c in range(n):
        th = 2 * np.pi * c / n
        R = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0],
                      [np.sin(th), 0, np.cos(th)]])
        pos = np.array([-3.0 * np.sin(th), 0.05, -3.0 * np.cos(th)])
        f = 1100.0 + 10 * (c % 5)
        cams["K"].append(np.array([[f, 0, w / 2 + c % 3], [0, f, h / 2 - 2],
                                   [0, 0, 1]]))
        cams["R"].append(R)
        cams["T"].append((-R @ pos).reshape(3, 1) * 1000.0)
        cams["D"].append(np.zeros((5, 1)) if c % 4 == 0 else np.array(
            [[-0.2 + 0.01 * (c % 7)], [0.1], [1e-3], [-1e-3], [0.02]]))
    return cams


def _mask_png(verts, K, R, T, hw) -> bytes:
    """8-bit grey PNG (0/255) of the body: the vertices' projection on a
    16-pixel grid, grown by one cell."""
    from transhuman_tpu_torch.data.imgproc import dilate
    from transhuman_tpu_torch.utils.png import encode_png

    h, w = hw
    cam = verts @ R.T + T.reshape(1, 3) / 1000.0
    uv = cam @ K.T
    uv = uv[:, :2] / uv[:, 2:]
    cells = np.zeros((h // 16, w // 16), np.uint8)
    ij = np.floor(uv / 16).astype(int)
    ok = (ij[:, 0] >= 0) & (ij[:, 0] < w // 16) & (ij[:, 1] >= 0) & (
        ij[:, 1] < h // 16)
    cells[ij[ok, 1], ij[ok, 0]] = 255
    cells = dilate(cells, 3)
    return encode_png(np.repeat(np.repeat(cells, 16, 0), 16, 1))


def write_zju_layout(root: str, human: str, frames, n_annots: int,
                     seed: int = 0):
    """A ZJU-MoCap human under root in the reference's layout: annots.npy
    (ZJU_CAMS cameras, n_annots frames listed), for each of ``frames`` the
    23 views hard-linked to the committed 1024x1024 fixture JPEGs, masks
    from the posed synthetic body's projection, new_vertices/new_params of
    SMPLModel.synthetic() posed, and visibility files for the first half of
    the cameras (the rest fall back to all ones)."""
    from transhuman_tpu_torch.geometry.smpl import SMPLModel, rodrigues

    rng = np.random.default_rng(seed)
    smpl = SMPLModel.synthetic()
    hdir = os.path.join(root, human)
    cams = _zju_cameras(ZJU_CAMS)
    jpegs = sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES)
                   if f.endswith(".jpg"))
    ims = [{"ims": [f"Camera_B{c + 1}/{f:06d}.jpg" for c in range(ZJU_CAMS)]}
           for f in range(n_annots)]
    for d in ("new_vertices", "new_params"):
        os.makedirs(os.path.join(hdir, d), exist_ok=True)
    for k, f in enumerate(frames):
        params = {"poses": (rng.standard_normal((1, 72)) * 0.05).astype(
                      np.float32),
                  "shapes": np.zeros((1, 10), np.float32),
                  "Rh": (rng.standard_normal((1, 3)) * 0.1).astype(
                      np.float32),
                  "Th": (rng.standard_normal((1, 3)) * 0.05).astype(
                      np.float32)}
        verts, _, _ = smpl(params["poses"].reshape(-1), np.zeros(10))
        Rh = rodrigues(params["Rh"].reshape(1, 3))[0]
        verts = verts @ Rh.T + params["Th"].reshape(1, 3)
        np.save(os.path.join(hdir, "new_vertices", f"{f}.npy"), verts)
        np.save(os.path.join(hdir, "new_params", f"{f}.npy"), params)
        for c in range(ZJU_CAMS):
            cdir = f"Camera_B{c + 1}"
            for sub in ("", "mask"):
                os.makedirs(os.path.join(hdir, sub, cdir), exist_ok=True)
            dst = os.path.join(hdir, cdir, f"{f:06d}.jpg")
            src = jpegs[(k + c) % len(jpegs)]
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)
            with open(os.path.join(hdir, "mask", cdir, f"{f:06d}.png"),
                      "wb") as fh:
                fh.write(_mask_png(verts, *(np.asarray(cams[x][c]) for x in
                                           ("K", "R", "T")), (1024, 1024)))
            if c < ZJU_CAMS // 2:
                vdir = os.path.join(root, "raster", human, "visibility", cdir)
                os.makedirs(vdir, exist_ok=True)
                np.save(os.path.join(vdir, f"{f:06d}.npy"),
                        (rng.random(smpl.v_template.shape[0]) > 0.4))
    np.save(os.path.join(hdir, "annots.npy"), {"cams": cams, "ims": ims})


def host_split(data, index: int) -> dict:
    """One train sample's host ms by stage, the stages of
    ZJUDataset.get_train_sample run one by one on its inputs (remap plans
    cached, as in steady state): decode (4 JPEGs and their masks),
    undistort+remap, resize, jitter, bound mask+hull, patch sampling."""
    from transhuman_tpu_torch.data import image_io, imgproc, ray_sampling
    from transhuman_tpu_torch.data.jitter import color_jitter
    from transhuman_tpu_torch.geometry import rays

    data.get_train_sample(index)  # the remap plans and ray grids cached
    _, human, frame_file, _ = data._frame_meta(index)
    cam = data.cam_inds[index]
    views = [cam] + data._pick_input_views(human, np.random.default_rng(
        index + data.epoch * data.cfg.seed))
    ms = dict.fromkeys(("decode", "undistort+remap", "resize", "jitter",
                        "bound mask+hull", "patch sampling"), 0.0)

    def timed(key, fn, *a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        ms[key] += (time.perf_counter() - t) * 1e3
        return out

    for v in views:
        cdir = data._cam_dir(human, v + 1)
        img = timed("decode", image_io.imread_rgb, os.path.join(
            data.data_root, human, cdir, frame_file))
        msk = timed("decode", data._load_mask, human, cdir, frame_file)
        img = np.multiply(img, np.float32(1 / 255), dtype=np.float32)
        plan = data._remap_plan(human, v, img.shape[:2])
        if plan is not None:
            img = timed("undistort+remap", imgproc.remap_linear, img, plan)
            msk = timed("undistort+remap", imgproc.remap_linear, msk, plan)
        hw = (img.shape[1] // 2, img.shape[0] // 2)
        img = timed("resize", imgproc.resize_area, img, hw)
        msk = timed("resize", imgproc.resize_nearest, msk, hw)
        img = timed("jitter", color_jitter, img, index)
    frame, target, _ = data._build_frame(index, np.random.default_rng(0),
                                         jitter=False, train=True)
    tgt_img, tgt_msk, K, R, T, bounds = target
    H, W = tgt_img.shape[:2]
    ro, rd = rays.get_rays_cached(H, W, K, R, T.reshape(3, 1))
    pose = np.concatenate([R, T.reshape(3, 1)], 1)
    timed("bound mask+hull", rays.get_bound_2d_mask, bounds, K, pose, H, W)
    timed("bound mask+hull", rays.get_near_far_hull, bounds,
          ro.reshape(-1, 3), rd.reshape(-1, 3), K, R, T.reshape(3, 1), H, W)
    timed("patch sampling", ray_sampling.sample_train_rays, tgt_img, tgt_msk,
          K, R, T.reshape(3, 1), bounds, np.random.default_rng(0),
          n_patches=data.cfg.patch.N_patches, patch_size=data.cfg.patch.size)
    # sample_train_rays forms the bound mask and hull itself: its own share
    ms["patch sampling"] = max(ms["patch sampling"] - ms["bound mask+hull"],
                               0.0)
    return ms


def phase_train_zju(card: str, tmp: str, files: dict) -> tuple:
    """f. The train entry point from --cfg_file configs/train_or_eval.yaml
    with dataset zju (as the file says; data_root and rasterize_root the
    laid-out CoreView_377: 23 cameras, the catalog's 10 frames, 1024x1024
    JPEGs, D non-zero on most cameras, visibility for half of them), LPIPS
    and the pretrained encoder, in bf16 and in float32, ZJU_TRAIN_STEPS
    steps each, counters reset just before and read just after; the same
    in bf16 with dataset synthetic, for the step medians in one call; the
    host split of one sample; then one step with use_patch_sampling False
    and one with rot_ratio 1.0.  Returns ({path: counts}, the zju root,
    the bf16 zju run's model root)."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.zju import ZJUDataset
    from transhuman_tpu_torch.geometry.smpl import SMPLModel

    root = os.path.join(tmp, "zju")
    t0 = time.perf_counter()
    write_zju_layout(root, "CoreView_377", range(0, 300, 30), 300)
    layout_s = time.perf_counter() - t0
    cfg_file = os.path.join(CONFIGS, "train_or_eval.yaml")

    def opts(tag, dataset="zju", dtype="bfloat16"):
        run = os.path.join(tmp, f"zju_train_{tag}")
        return ["--device", "cuda", "--cfg_file", cfg_file, "dataset",
                dataset, "data_root", root, "rasterize_root",
                os.path.join(root, "raster"), "lpips_weights",
                files["lpips"], "encoder_weights", files["resnet"],
                "ep_iter", str(ZJU_TRAIN_STEPS), "train.epoch", "1",
                "compute_dtype", dtype, "trained_model_dir",
                os.path.join(run, "tm"), "record_dir",
                os.path.join(run, "rec"), "result_dir",
                os.path.join(run, "res")]

    by_path, medians = {}, {}
    for tag, dataset, dtype in (("bf16", "zju", "bfloat16"),
                                ("synthetic_bf16", "synthetic", "bfloat16"),
                                ("f32", "zju", "float32")):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        _, recs = train_cli.main(opts(tag, dataset, dtype))
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        n = len(recs)
        check(n == ZJU_TRAIN_STEPS and all(
            np.isfinite(r["loss"]) and r["lpips_loss"] > 0 for r in recs),
            f"train {dataset} ({dtype}): {recs}")
        f = forms(dtype)
        check_launches(f"train {dataset} ({dtype})", counts,
                       {f["dparf"]: n, f["scatter"]: 2 * n, f["fetch"]: 2 * n})
        step = [r["step_s"] * 1e3 for r in recs]
        medians[tag] = float(np.median(step[1:]))
        if dataset == "zju":
            by_path["train_zju" + ("_bf16" if tag == "bf16" else "")] = counts
        log(f"[f train {dataset}] --cfg_file train_or_eval.yaml in {dtype}, "
            f"{n} steps: step ms {', '.join(f'{x:.1f}' for x in step)} "
            f"(median of steps 1-{n - 1} {medians[tag]:.1f}); data_s (the "
            f"step's wait on the prefetch queue) "
            f"{', '.join(f'{r['data_s'] * 1e3:.1f}' for r in recs)} ms; "
            f"sample_s (host ms per sample, in a loader thread) "
            f"{', '.join(f'{r['sample_s'] * 1e3:.1f}' for r in recs)}; "
            f"losses {', '.join(f'{r['loss']:.4f}' for r in recs)}; "
            f"launches {counts}  [{card}]")
    log(f"[f train medians] bf16 step median zju {medians['bf16']:.1f} ms "
        f"against synthetic {medians['synthetic_bf16']:.1f} ms (one call); "
        f"f32 zju {medians['f32']:.1f} ms; layout written in {layout_s:.1f} "
        f"s  [{card}]")

    cfg = Config.from_yaml(cfg_file, ["data_root", root, "rasterize_root",
                                      os.path.join(root, "raster")])
    data = ZJUDataset(cfg, "train", smpl=SMPLModel.synthetic())
    split = [host_split(data, i) for i in (0, 57, 131)]
    med = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    log(f"[f host split] one ZJU train sample (4 views of 1024x1024 to "
        f"512x512, jitter on), host ms by stage (median of 3 samples): "
        + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
        + f"; sum {sum(med.values()):.1f}  [{card}]")

    for tag, extra in (("nonpatch", ["patch.use_patch_sampling", "False"]),
                       ("rot", ["rot_ratio", "1.0"])):
        argv = opts(tag)
        argv[2:2] = ["--steps", "1"]
        kernels.reset_launch_counts()
        _, recs = train_cli.main(argv + extra)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        key = "img_loss" if tag == "nonpatch" else "mse_loss"
        check(len(recs) == 1 and np.isfinite(recs[0][key]),
              f"train zju {tag}: {recs}")
        f = forms("bfloat16")
        check_launches(f"train zju {tag}", counts,
                       {f["dparf"]: 1, f["scatter"]: 2, f["fetch"]: 2})
        log(f"[f train zju {' '.join(extra)}] one step: {key} "
            f"{recs[0][key]:.5f}, step {recs[0]['step_s'] * 1e3:.1f} ms, "
            f"sample {recs[0]['sample_s'] * 1e3:.1f} ms; launches {counts}  "
            f"[{card}]")
    return by_path, root, os.path.join(tmp, "zju_train_bf16", "tm")


def phase_eval_zju(card: str, tmp: str, model_root: str) -> dict:
    """g. The run entry point from the config files with dataset zju on a
    laid-out CoreView_387 (model_x_motion_x, ZJU_EVAL_FRAMES frames) and
    phase f's bf16 checkpoint: --type evaluate (train_or_eval.yaml: input
    views 0, 7, 15, targets 3, 5, 10, 12, 18, 20), --type visualize
    (performance.yaml) and --type reconstruction (reconstruction.yaml,
    mesh_th 5), counters reset just before each and read just after; the
    host ms of get_eval_item and the loop's wait for it; then one ZJU eval
    item at 64x64 on the card and the CPU within phase 8's bounds."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.zju import ZJUDataset
    from transhuman_tpu_torch.geometry.smpl import SMPLModel

    root = os.path.join(tmp, "zju_eval")
    write_zju_layout(root, "CoreView_387", range(ZJU_EVAL_FRAMES),
                     ZJU_EVAL_FRAMES, seed=1)
    res = os.path.join(tmp, "zju_result")
    common = ["--device", "cuda", "data_root", root, "rasterize_root",
              os.path.join(root, "raster"), "trained_model_dir", model_root,
              "result_dir", res]
    f = forms("bfloat16")
    by_path = {}

    cfg = Config.from_yaml(os.path.join(CONFIGS, "train_or_eval.yaml"),
                           common[2:])
    data = ZJUDataset(cfg, "test", smpl=SMPLModel.synthetic())
    idx = [int(i) for i in data.frame_sampler_indices()]
    item_ms = []
    for i in idx:
        t = time.perf_counter()
        data.get_eval_item(i)
        item_ms.append((time.perf_counter() - t) * 1e3)
    stamps, starts, render_ms = [], [], []

    def stamp(item, out):
        stamps.append(time.perf_counter())
        return {}

    dispatch = run_cli.FrameRenderer.dispatch

    def timed_dispatch(self, frame, eval_rays):
        torch.cuda.synchronize()
        t = time.perf_counter()
        starts.append(t)
        out = dispatch(self, frame, eval_rays)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t) * 1e3)
        return out

    kernels.reset_launch_counts()
    run_cli.FrameRenderer.dispatch = timed_dispatch
    try:
        summary = run_cli.main(["--type", "evaluate", "--cfg_file",
                                os.path.join(CONFIGS, "train_or_eval.yaml"),
                                *common], per_frame=stamp)
    finally:
        run_cli.FrameRenderer.dispatch = dispatch
    torch.cuda.synchronize()
    by_path["eval_zju_bf16"] = kernels.launch_counts()
    check(len(stamps) == len(idx) == 6, f"evaluate zju: {len(stamps)} "
          f"frames, {len(idx)} items")
    check(np.isfinite(summary["psnr"]), f"evaluate zju: {summary}")
    check_launches("evaluate zju", by_path["eval_zju_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    out_dir = os.path.join(res, "epoch_-1", "debug")
    written = sorted(os.path.relpath(os.path.join(d, x), out_dir)
                     for d, _, fs in os.walk(out_dir) for x in fs)
    check({"summary.txt", "psnr.npy", "ssim.npy", "mse.npy"}
          <= set(written), f"evaluate zju: files {written}")
    with open(os.path.join(out_dir, "summary.txt")) as fh:
        text = fh.read().strip().replace("\n", "; ")
    cadence = np.diff(stamps) * 1e3
    wait = [(s - p) * 1e3 for s, p in zip(starts[1:], stamps[:-1])]
    log(f"[g evaluate zju] train_or_eval.yaml (bf16), CoreView_387 frame 0, "
        f"6 targets of 512x512: get_eval_item host ms (serial, first cold) "
        f"{', '.join(f'{x:.1f}' for x in item_ms)}; render "
        f"{', '.join(f'{x:.1f}' for x in render_ms)} ms; frame to frame "
        f"{', '.join(f'{x:.1f}' for x in cadence)} ms; the loop's wait for "
        f"the next item {', '.join(f'{x:.1f}' for x in wait)} ms (the "
        f"loader hides the host work where this is ~0); summary.txt: {text}; "
        f"files {len(written)} ({', '.join(written[:6])}, ...); launches "
        f"{by_path['eval_zju_bf16']}  [{card}]")

    kernels.reset_launch_counts()
    paths = run_cli.main(["--type", "visualize", "--cfg_file",
                          os.path.join(CONFIGS, "performance.yaml"),
                          *common])
    torch.cuda.synchronize()
    by_path["visualize_zju_bf16"] = kernels.launch_counts()
    check(len(paths) == ZJU_EVAL_FRAMES, f"visualize zju: {paths}")
    check_launches("visualize zju", by_path["visualize_zju_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    videos = check_videos("visualize zju", paths)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    meshes = run_cli.main(["--type", "reconstruction", "--cfg_file",
                           os.path.join(CONFIGS, "reconstruction.yaml"),
                           *common, "mesh_th", "5"])
    torch.cuda.synchronize()
    recon_s = time.perf_counter() - t0
    by_path["reconstruction_zju_bf16"] = kernels.launch_counts()
    from transhuman_tpu_torch.mesh_ops.ply import load_ply

    v, t = load_ply(meshes[0])
    check(len(meshes) == 1 and len(t) > 100, f"reconstruction zju: {meshes}")
    check_launches("reconstruction zju", by_path["reconstruction_zju_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    log(f"[g visualize / reconstruction zju] performance.yaml: "
        f"{len(paths)} frames, videos {list(videos.values())} (frames, "
        f"bytes); reconstruction.yaml at 0.005 m: {len(v)} "
        f"verts, {len(t)} tris in {recon_s:.1f} s; launches visualize "
        f"{by_path['visualize_zju_bf16']}, reconstruction "
        f"{by_path['reconstruction_zju_bf16']}  [{card}]")

    # one ZJU eval item (two targets) at 64x64, card against CPU
    pcfg = Config().merge_opts(common[2:6] + [
        "ratio", "0.0625", "test.target_view", "3,10"])
    pdata = ZJUDataset(pcfg, "test", smpl=SMPLModel.synthetic())
    phase_eval_parity(card, "float32", cfg=pcfg, data=pdata,
                      label="g zju eval parity")
    return by_path


# ----------------------------------------------- visibility from depth maps
DEPTH_DET = 0.07  # m: depth_visibility's margin behind the surface
DEPTH_TIE = 1e-5  # m: |z - surface - margin| within it may flip either way


def zbuffer_depth(verts, K, R, T, hw, splat: int) -> np.ndarray:
    """(H, W) float32 camera depth of the nearest vertex, each splatted
    over a (2 splat + 1)^2 square at its projection; 0 where none lands."""
    cam = verts @ R.T + T.reshape(1, 3)
    pix = cam @ K.T
    uv = np.round(pix[:, :2] / pix[:, 2:]).astype(int)
    depth = np.zeros(hw, np.float32)
    order = np.argsort(-cam[:, 2])  # far first: the nearest is written last
    for dy in range(-splat, splat + 1):
        for dx in range(-splat, splat + 1):
            x, y = uv[order, 0] + dx, uv[order, 1] + dy
            ok = (x >= 0) & (x < hw[1]) & (y >= 0) & (y < hw[0])
            depth[y[ok], x[ok]] = cam[order[ok], 2]
    return depth


def write_depth_maps(root: str, human: str, droot: str, ratio: float,
                     splat: int) -> int:
    """The reference's depth maps of a laid-out human: for every frame in
    new_vertices and every camera, the posed body z-buffered at the render
    size (1024 x ratio) with the loader's K, saved as a torch tensor under
    droot/human/Camera_B<c>/<frame>.pt.  Returns the number written."""
    cams = np.load(os.path.join(root, human, "annots.npy"),
                   allow_pickle=True).item()["cams"]
    hw = (int(1024 * ratio),) * 2
    vdir = os.path.join(root, human, "new_vertices")
    n = 0
    for name in sorted(os.listdir(vdir)):
        verts = np.load(os.path.join(vdir, name)).astype(np.float64)
        for c in range(len(cams["K"])):
            K = np.array(cams["K"][c], np.float32).astype(np.float64)
            K[:2] *= ratio
            d = zbuffer_depth(verts, K, np.asarray(cams["R"][c], np.float64),
                              np.asarray(cams["T"][c], np.float64) / 1000.0,
                              hw, splat)
            path = os.path.join(droot, human, f"Camera_B{c + 1}",
                                f"{int(name[:-4]):06d}.pt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(torch.from_numpy(d), path)
            n += 1
    return n


def phase_depth(card: str, tmp: str, zju_root: str, model_root: str) -> dict:
    """i. Visibility from depth maps (depth_map True, depth_vizmap True):
    depth maps z-buffered from the synthetic body for phase g's laid-out
    CoreView_387 (at 64x64 and 512x512) and phase f's CoreView_377 (512);
    the visibility masks of each 64x64 eval item on the card against the
    CPU (equal off the near-tie band), then that item's frames within phase
    8's bounds; then at full width, counters reset just before each and
    read just after, --type evaluate (train_or_eval.yaml, 2 targets),
    --type visualize (performance.yaml; its AVI checked) on phase f's bf16
    checkpoint, and one train step (train.cull True): K1, K2 and K4
    launched on each, K3 in the step."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.zju import ZJUDataset
    from transhuman_tpu_torch.geometry.smpl import SMPLModel
    from transhuman_tpu_torch.ops.sampling import (
        depth_visibility,
        project_points,
        sample_half_pixel,
    )

    eval_root = os.path.join(tmp, "zju_eval")  # phase g's CoreView_387
    d64, d512 = os.path.join(tmp, "depth64"), os.path.join(tmp, "depth512")
    t0 = time.perf_counter()
    n = (write_depth_maps(eval_root, "CoreView_387", d64, 0.0625, 1)
         + write_depth_maps(eval_root, "CoreView_387", d512, 0.5, 3)
         + write_depth_maps(zju_root, "CoreView_377", d512, 0.5, 3))
    write_s = time.perf_counter() - t0
    depth = ["depth_map", "True", "depth_vizmap", "True"]

    # the masks, card against CPU, on the 64x64 items; then their frames
    pcfg = Config().merge_opts([
        "data_root", eval_root, "rasterize_root",
        os.path.join(eval_root, "raster"), "ratio", "0.0625",
        "test.target_view", "3,10", *depth, "depth_root", d64])
    pdata = ZJUDataset(pcfg, "test", smpl=SMPLModel.synthetic())
    fracs, band, changed = [], 0, 0
    for i in pdata.frame_sampler_indices():
        fr = pdata.get_eval_item(int(i)).frame
        args = (fr.depth_maps, fr.verts_world, fr.K, fr.R, fr.T)
        cpu = depth_visibility(*args)
        gpu = depth_visibility(*(a.cuda() for a in args)).cpu()
        uv, z = project_points(*(a.double() for a in args[1:]))
        surf = sample_half_pixel(fr.depth_maps[..., None].double(), uv,
                                 fr.depth_maps.shape[1:])[..., 0]
        tie = (z - surf - DEPTH_DET).abs() <= DEPTH_TIE
        check(torch.equal(cpu[~tie], gpu[~tie]),
              f"depth visibility: {int((cpu != gpu)[~tie].sum())} masks "
              "differ off the near-tie band, card against CPU")
        fracs.append(float(cpu.mean()))
        band += int(tie.sum())
        changed += int((cpu != fr.vizmaps).sum())
    check(0.05 < min(fracs) and max(fracs) < 0.95 and changed > 0,
          f"depth visibility: visible fractions {fracs}, {changed} vertex "
          "decisions unlike the rasterised vizmaps")
    log(f"[i depth visibility] {n} depth maps z-buffered in {write_s:.1f} s; "
        f"64x64 items ({len(fracs)}), 3 views x 6890 vertices each: visible "
        f"fraction {', '.join(f'{x:.4f}' for x in fracs)}; masks card = CPU "
        f"off the band; {band} vertex-views within {DEPTH_TIE} m of the "
        f"{DEPTH_DET} m margin; {changed} decisions differ from the "
        f"vizmaps  [{card}]")
    phase_eval_parity(card, "float32", cfg=pcfg, data=pdata,
                      label="i depth eval parity")

    # the prologue at full width (bf16, 3 views of 512x512): visibility
    # from the depth maps against the rasterised vizmaps, one frame
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.testing import init_weights

    cfg = Config.from_yaml(os.path.join(CONFIGS, "train_or_eval.yaml"), [
        "data_root", eval_root, "rasterize_root",
        os.path.join(eval_root, "raster"), *depth, "depth_root", d512])
    data = ZJUDataset(cfg, "test", smpl=SMPLModel.synthetic())
    model, pipe, _, _ = build_runtime(cfg, torch.device("cuda"),
                                      smpl=data.smpl)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    frame = data.get_eval_item(0).frame.to("cuda")
    plain = dataclasses.replace(frame, depth_maps=None)
    pro_ms = {}
    for tag, fr in (("vizmaps", plain), ("depth", frame)) * 2:
        pipe.prologue(fr)
        torch.cuda.synchronize()
        ms = []
        for _ in range(10):
            t = time.perf_counter()
            pipe.prologue(fr)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        pro_ms.setdefault(tag, []).append(float(np.median(ms)))
    del model, pipe, frame, plain
    log(f"[i depth prologue] bf16 full width, 3 views of 512x512, median "
        f"of 10 synchronised calls, in turns: vizmaps "
        f"{', '.join(f'{x:.3f}' for x in pro_ms['vizmaps'])} ms, depth "
        f"visibility {', '.join(f'{x:.3f}' for x in pro_ms['depth'])} ms  "
        f"[{card}]")

    # full width: evaluate, visualize, one train step
    f = forms("bfloat16")
    by_path = {}
    res = os.path.join(tmp, "depth_result")
    common = ["--device", "cuda", "data_root", eval_root, "rasterize_root",
              os.path.join(eval_root, "raster"), "trained_model_dir",
              model_root, "result_dir", res, *depth, "depth_root", d512]
    render_ms = []
    dispatch = run_cli.FrameRenderer.dispatch

    def timed_dispatch(self, frame, eval_rays):
        check(frame.depth_maps is not None
              and tuple(frame.depth_maps.shape) == (3, 512, 512),
              "evaluate depth: a frame without its 512x512 depth maps")
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = dispatch(self, frame, eval_rays)
        torch.cuda.synchronize()
        render_ms.append((time.perf_counter() - t) * 1e3)
        return out

    kernels.reset_launch_counts()
    run_cli.FrameRenderer.dispatch = timed_dispatch
    try:
        summary = run_cli.main(["--type", "evaluate", "--cfg_file",
                                os.path.join(CONFIGS, "train_or_eval.yaml"),
                                *common, "test.target_view", "3,10"])
    finally:
        run_cli.FrameRenderer.dispatch = dispatch
    torch.cuda.synchronize()
    by_path["eval_depth_bf16"] = kernels.launch_counts()
    check(len(render_ms) == 2 and np.isfinite(summary["psnr"]),
          f"evaluate depth: {len(render_ms)} frames, {summary}")
    check_launches("evaluate depth", by_path["eval_depth_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    kernels.reset_launch_counts()
    paths = run_cli.main(["--type", "visualize", "--cfg_file",
                          os.path.join(CONFIGS, "performance.yaml"),
                          *common])
    torch.cuda.synchronize()
    by_path["visualize_depth_bf16"] = kernels.launch_counts()
    check(len(paths) == ZJU_EVAL_FRAMES, f"visualize depth: {paths}")
    check_launches("visualize depth", by_path["visualize_depth_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    videos = check_videos("visualize depth", paths)
    run = os.path.join(tmp, "i_train")
    kernels.reset_launch_counts()
    _, recs = train_cli.main([
        "--device", "cuda", "--steps", "1", "--cfg_file",
        os.path.join(CONFIGS, "train_or_eval.yaml"), "data_root", zju_root,
        "rasterize_root", os.path.join(zju_root, "raster"), "ep_iter", "1",
        "train.epoch", "1", "train.cull", "True", *depth, "depth_root", d512,
        "trained_model_dir", os.path.join(run, "tm"), "record_dir",
        os.path.join(run, "rec"), "result_dir", os.path.join(run, "res")])
    torch.cuda.synchronize()
    by_path["train_depth_bf16"] = kernels.launch_counts()
    check(len(recs) == 1 and np.isfinite(recs[0]["loss"]),
          f"train depth: {recs}")
    check_launches("train depth", by_path["train_depth_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1,
                    f["scatter"]: 1})
    log(f"[i depth full width] bf16, depth_map + depth_vizmap: evaluate "
        f"(train_or_eval.yaml, 2 targets of 512x512) psnr "
        f"{summary['psnr']:.4f}, render "
        f"{', '.join(f'{x:.1f}' for x in render_ms)} ms; visualize "
        f"(performance.yaml) {len(paths)} frames, videos "
        f"{list(videos.values())} (frames, bytes); one train step with "
        f"train.cull: loss {recs[0]['loss']:.4f}, step "
        f"{recs[0]['step_s'] * 1e3:.1f} ms, sample "
        f"{recs[0]['sample_s'] * 1e3:.1f} ms; launches evaluate "
        f"{by_path['eval_depth_bf16']}, visualize "
        f"{by_path['visualize_depth_bf16']}, train "
        f"{by_path['train_depth_bf16']}  [{card}]")
    return by_path


# ------------------------------- batches, the train cull, remat, the radii
H_BATCH = 4  # train.batch_size of phase h3
H_STEPS = 3  # updates of each phase h3 run
H_TRAIN_POINTS = 153600  # one train sample's points: 2,400 rays x 64
H_RADII = (0.02, 0.1)  # m: the range of phase h's seeded per-vertex radii


def seeded_radii(seed: int = 10, n: int = 6890) -> np.ndarray:
    return np.random.default_rng(seed).uniform(*H_RADII, n).astype(
        np.float32)


def min_excess64(pts, refs, bias2, block: int = 4096):
    """min over refs of (|p - r|^2 - bias2_r) per point, in float64."""
    p, r, b = pts.double(), refs.double(), bias2.double()
    out = torch.empty(p.shape[0], dtype=torch.float64, device=p.device)
    for s in range(0, p.shape[0], block):
        out[s:s + block] = (torch.cdist(p[s:s + block], r) ** 2
                            - b[None]).min(dim=1).values
    return out


def phase_cull_bias(card: str) -> dict:
    """h1. K1's bias form, the per-vertex radii cull (bias2 = r^2, kept
    where < 0), against its plain twin on the card at a render chunk
    (32,768 points) and at one train sample's points (153,600), against
    6,890 vertices with radii drawn in [0.02, 0.1] m: the values within
    1e-6, the predicate equal on every point whose float64 excess is
    farther than 1e-6 from 0; timed beside its bound and beside the
    zero-bias form at the same shape."""
    from transhuman_tpu_torch.kernels import cull
    from transhuman_tpu_torch.tools.kernel_ab import phase3_inputs

    dev = torch.device("cuda")
    out = {}
    for name, n in (("render", N_CHUNK), ("train", H_TRAIN_POINTS)):
        pts, verts = phase3_inputs(dev, n)[:2]
        bias2 = torch.from_numpy(seeded_radii()).to(dev) ** 2
        zeros = torch.zeros_like(bias2)
        e_k = cull.min_excess2_cuda(pts, verts, bias2)
        e_p = cull.min_excess2_plain(pts, verts, bias2)
        e64 = min_excess64(pts, verts, bias2)
        torch.cuda.synchronize()
        err = float((e_k - e_p).abs().max())
        check(err <= 1e-6, f"K1 bias form ({name}): max |excess kernel - "
              f"plain| = {err} > 1e-6")
        sure = e64.abs() > 1e-6
        for what, e in (("plain", e_p < 0), ("float64", e64 < 0)):
            diff = int(((e_k < 0) != e)[sure].sum())
            check(diff == 0, f"K1 bias form ({name}): {diff} cull decisions "
                  f"differ from the {what} ones off |excess| <= 1e-6")
        ms = time_ms(lambda: cull.min_excess2_cuda(pts, verts, bias2))
        zero_ms = time_ms(lambda: cull.min_excess2_cuda(pts, verts, zeros))
        plain_ms = time_ms(lambda: cull.min_excess2_plain(pts, verts, bias2),
                           iters=5, warmup=1)
        b = bound(nbytes(pts, verts, bias2, e_k), 7 * n * verts.shape[0])
        keep = float((e_k < 0).float().mean())
        out[name] = {"points": n, "max_abs_err": err, "ms": ms,
                     "zero_bias_ms": zero_ms, "plain_ms": plain_ms, **b,
                     "survivors": keep, "near_ties": int((~sure).sum())}
        log(f"[h1 K1 bias form] {name}: {n} pts x {verts.shape[0]} verts, "
            f"radii in [{H_RADII[0]}, {H_RADII[1]}] m: max|d excess| "
            f"{err:.3g}, survivors {keep:.4f}, {int((~sure).sum())} points "
            f"within 1e-6 of 0 left out; kernel {ms:.4f} ms (zero bias "
            f"{zero_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})  [{card}]")
    return out


def phase_batch_parity(card: str, plain_step: dict):
    """h2. Card against CPU at 64x64 and full width: a train step at
    train.batch_size 2 with train.cull, the same with accum_steps 2 (no
    cull), each in float32 and bf16 at phases 6 and 12's bounds; a remat
    step at phase 6's bounds and its card gradients against plain_step's
    (phase 6's card step without remat) within 1e-6 of each leaf's norm;
    a serve render with per-vertex radii at phase 4's bounds.  A step's
    gradients on the card are not bit-reproducible (the library's
    backward kernels are not all deterministic), so the remat
    check's bound is 4x what a second step without remat differs by, or
    1e-6, whichever is larger."""
    for extra in (("train.batch_size", "2", "train.cull", "True"),
                  ("train.batch_size", "2", "train.accum_steps", "2")):
        ref = phase_train_parity(card, extra=extra)
        phase_train_parity(card, "bfloat16", ref, extra=extra)
    remat = {}
    phase_train_parity(card, extra=("remat", "True"), card_out=remat)
    g0, g1 = plain_step["grads"], remat["grads"]
    again = _parity_step(_parity_cfg(), "cuda")[2]
    check(g0.keys() == g1.keys() == again.keys(), "h2 remat: the leaves "
          "with a gradient differ")
    gmax = max(float(g.norm()) for g in g0.values())

    def worst(g):
        return max(float((g[n] - g0[n]).norm())
                   / (float(g0[n].norm()) + 1e-3 * gmax) for n in g0)

    noise, diff = worst(again), worst(g1)
    check(diff <= max(1e-6, 4 * noise), f"h2 remat: card gradients differ "
          f"from the card step without remat by {diff:.3g} of a leaf's norm,"
          f" a second step without remat by {noise:.3g}")
    log(f"[h2 remat] card step with remat against the card step without: "
        f"worst gradient leaf {diff:.3g} of its norm; a second step without "
        f"remat {noise:.3g}  [{card}]")
    phase_parity(card, radii=seeded_radii())


def _train_run(card: str, tmp: str, tag: str, dtype: str, extra=(),
               out=None):
    """One phase h3 run of the train entry point from train_or_eval.yaml
    with dataset synthetic at full width: (records, launch counts, peak
    GiB), counters and the peak reset just before."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import train as train_cli

    run = os.path.join(tmp, f"h3_{tag}")
    argv = ["--device", "cuda", "--steps", str(H_STEPS), "--cfg_file",
            os.path.join(CONFIGS, "train_or_eval.yaml"), "dataset",
            "synthetic", "ep_iter", str(H_STEPS), "train.epoch", "1",
            "compute_dtype", dtype, "trained_model_dir",
            os.path.join(run, "tm"), "record_dir", os.path.join(run, "rec"),
            *extra]
    if out:
        argv[2:2] = ["--out", out]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    _, recs = train_cli.main(argv)
    torch.cuda.synchronize()
    return recs, kernels.launch_counts(), \
        torch.cuda.max_memory_allocated() / 2**30


def phase_train_batches(card: str, tmp: str):
    """h3. The train entry point (--cfg_file configs/train_or_eval.yaml,
    dataset synthetic, full width) at train.batch_size 1, 2 and 4 in bf16,
    at 4 in float32, and at 4 in bf16 with accum_steps 2, with train.cull,
    with remat, and with all three: per run the step median, ms per
    sample, peak memory, survivor fraction and launches per step, held to
    K1 B per step under train.cull and 0 without, K2 and K4 B per step
    forward (twice with remat), K3 2B.  Returns ({path: counts}, the
    float32 batch-4 run's checkpoint)."""
    ckpt = os.path.join(tmp, "h3_b4.pth")
    runs = [("b1_bf16", "bfloat16", 1, ()), ("b2_bf16", "bfloat16", 2, ()),
            ("b4_bf16", "bfloat16", 4, ()), ("b4", "float32", 4, ()),
            ("b4_accum2_bf16", "bfloat16", 4, ("train.accum_steps", "2")),
            ("b4_cull_bf16", "bfloat16", 4, ("train.cull", "True")),
            ("b4_remat_bf16", "bfloat16", 4, ("remat", "True")),
            ("b4_all_bf16", "bfloat16", 4, ("train.accum_steps", "2",
                                            "train.cull", "True", "remat",
                                            "True"))]
    by_path = {}
    for tag, dtype, b, extra in runs:
        recs, counts, peak = _train_run(
            card, tmp, tag, dtype, ("train.batch_size", str(b), *extra),
            out=ckpt if tag == "b4" else None)
        n = len(recs)
        check(n == H_STEPS and all(np.isfinite(r["loss"]) for r in recs),
              f"h3 {tag}: {recs}")
        cull, remat = "train.cull" in extra, "remat" in extra
        f = forms(dtype)
        want = {f["dparf"]: (2 if remat else 1) * b * n,
                f["fetch"]: (3 if remat else 2) * b * n,
                f["scatter"]: 2 * b * n}
        if cull:
            want["min_excess2"] = b * n
            check(counts["min_excess2"] == b * n, f"h3 {tag}: K1 launched "
                  f"{counts['min_excess2']} times, want {b * n}")
        check_launches(f"h3 train {tag}", counts, want)
        step = [r["step_s"] * 1e3 for r in recs]
        med = float(np.median(step[1:]))
        surv = (f"; survivor fraction "
                f"{', '.join(f'{r['cull_survivors']:.4f}' for r in recs)}"
                if cull else "")
        by_path[f"train_{tag}"] = counts
        log(f"[h3 train] {tag}: train_or_eval.yaml, dataset synthetic, "
            f"{dtype}, train.batch_size {b} {' '.join(extra)}: step ms "
            f"{', '.join(f'{x:.1f}' for x in step)}, median of steps "
            f"1-{n - 1} {med:.1f} ({med / b:.1f} ms per sample); peak "
            f"device memory {peak:.3f} GiB{surv}; launches per step "
            f"{ {k: v / n for k, v in counts.items() if v} }  [{card}]")
    return by_path, ckpt


def phase_radii(card: str, tmp: str, ckpt: str) -> dict:
    """h4. tools/measure_vertex_radii on the card from phase h3's float32
    checkpoint (synthetic posed bodies, --frames 2): the npz and report;
    then one 512x512 serve request, beside the shell's survivors, and one
    frame through the evaluate entry point, with cull_radii set to that
    npz."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.serve import RenderService
    from transhuman_tpu_torch.testing import synthetic_scene
    from transhuman_tpu_torch.tools import measure_vertex_radii as tool
    from transhuman_tpu_torch.weights import load_checkpoint_file

    npz = os.path.join(tmp, "radii.npz")
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    radii, report = tool.main(["--out", npz, "--weights", ckpt, "--frames",
                               "2"])
    torch.cuda.synchronize()
    tool_s = time.perf_counter() - t0
    by_path = {"radii_tool": kernels.launch_counts()}
    check(radii.shape == (6890,) and radii.dtype == np.float32
          and np.isfinite(radii).all() and radii.min() >= 0.01
          and radii.max() <= 0.1, f"h4 radii: {report['radii']}")
    check(isinstance(report["certified"], bool)
          and len(report["image_deltas_vs_shell"]) == 2,
          f"h4 radii report: {report}")
    check_launches("h4 radii tool", by_path["radii_tool"],
                   {"min_excess2": 2 * 2 * report["rounds"], "dparf": 1,
                    "feature_gather": 1})
    log(f"[h4 radii tool] measure_vertex_radii --frames 2 on the h3 "
        f"checkpoint in {tool_s:.1f} s: certified {report['certified']}, "
        f"rounds {report['rounds']} (uncovered {report['uncovered_per_round']}"
        f"), radii {report['radii']}, mean reach / shell "
        f"{report['mean_reach_vs_shell']}, deltas vs shell "
        f"{report['image_deltas_vs_shell']}; launches "
        f"{by_path['radii_tool']}  [{card}]")

    cfg = Config().merge_opts(["cull_radii", npz])
    model, pipe, smpl, _ = build_runtime(cfg, "cuda")
    load_checkpoint_file(model, ckpt)
    frame, _, _ = synthetic_scene(image_hw=(512, 512))
    req = _request(frame, 1, 512)
    svc = RenderService(cfg, pipe, smpl)
    svc.warmup(512, 512)
    shell = RenderService(cfg, pipe.clone(vertex_radii=None), smpl)
    shell.warmup(512, 512)
    res = {}
    for name, s in (("radii", svc), ("shell", shell)):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        out = s.render(req)
        ms = (time.perf_counter() - t0) * 1e3
        st = s.pipe.last_frame_stats
        res[name] = (ms, st["survivors"] / st["points"],
                     kernels.launch_counts(), out)
        check(all(np.isfinite(v).all() for v in out.values()),
              f"h4 serve ({name}): non-finite output")
    by_path["serve_radii"] = res["radii"][2]
    check_launches("h4 serve with cull_radii", res["radii"][2],
                   {"min_excess2": 1, "dparf": 1, "feature_gather": 1})
    check(res["radii"][1] <= res["shell"][1] + 1e-9, "h4 serve: the radii "
          "keep more points than the shell")
    rgb_d = float(np.abs(res["radii"][3]["rgb"] - res["shell"][3]["rgb"])
                  .max())
    log(f"[h4 serve cull_radii] one 512x512 request: {res['radii'][0]:.1f} ms"
        f", survivor fraction {res['radii'][1]:.4f} against the shell's "
        f"{res['shell'][1]:.4f} ({res['shell'][0]:.1f} ms); max |d rgb| vs "
        f"the shell {rgb_d:.3g}; launches {res['radii'][2]}  [{card}]")

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    summary = run_cli.main(["--type", "evaluate", "--device", "cuda",
                            "--weights", ckpt, "dataset", "synthetic",
                            "cull_radii", npz, "result_dir",
                            os.path.join(tmp, "h4_res")])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    by_path["eval_radii"] = kernels.launch_counts()
    check(np.isfinite(summary["psnr"]), f"h4 evaluate: {summary}")
    check_launches("h4 evaluate with cull_radii", by_path["eval_radii"],
                   {"min_excess2": 1, "dparf": 1, "feature_gather": 1})
    log(f"[h4 evaluate cull_radii] the default FrameSampler's frame (1 of "
        f"the synthetic 8 at test.frame_interval 30), 512x512, in "
        f"{eval_s:.1f} s (the command): psnr {summary['psnr']:.4f}, ssim "
        f"{summary['ssim']:.4f}; launches {by_path['eval_radii']}  [{card}]")
    return by_path


def phase_train_zju_batch(card: str, tmp: str, root: str,
                          files: dict) -> dict:
    """h5. dataset zju (phase f's laid-out CoreView_377) at
    train.batch_size 2 for 3 bf16 steps from train_or_eval.yaml with LPIPS
    and the pretrained encoder: the loader delivers batches, and K2, K4 and
    K3 launch per sample."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import train as train_cli

    run = os.path.join(tmp, "h5")
    kernels.reset_launch_counts()
    _, recs = train_cli.main([
        "--device", "cuda", "--steps", "3", "--cfg_file",
        os.path.join(CONFIGS, "train_or_eval.yaml"), "data_root", root,
        "rasterize_root", os.path.join(root, "raster"), "lpips_weights",
        files["lpips"], "encoder_weights", files["resnet"], "ep_iter", "3",
        "train.epoch", "1", "train.batch_size", "2", "trained_model_dir",
        os.path.join(run, "tm"), "record_dir", os.path.join(run, "rec"),
        "result_dir", os.path.join(run, "res")])
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    n = len(recs)
    check(n == 3 and all(np.isfinite(r["loss"]) and r["lpips_loss"] > 0
                         for r in recs), f"h5 train zju batch 2: {recs}")
    f = forms("bfloat16")
    check_launches("h5 train zju batch 2", counts,
                   {f["dparf"]: 2 * n, f["fetch"]: 4 * n,
                    f["scatter"]: 4 * n})
    log(f"[h5 train zju] dataset zju, train.batch_size 2, bf16, {n} steps: "
        f"step ms {', '.join(f'{r['step_s'] * 1e3:.1f}' for r in recs)}; "
        f"data_s {', '.join(f'{r['data_s'] * 1e3:.1f}' for r in recs)} ms; "
        f"sample_s (host ms per batch of 2) "
        f"{', '.join(f'{r['sample_s'] * 1e3:.1f}' for r in recs)}; losses "
        f"{', '.join(f'{r['loss']:.4f}' for r in recs)}; launches {counts}"
        f"  [{card}]")
    return {"train_zju_b2_bf16": counts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing ran", file=sys.stderr)
        return 2
    import transhuman_tpu_torch  # noqa: F401 — fails outside the repo

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    render32 = phase_parity(card)
    serve_counts = phase_serve(card)
    card6 = {}
    step32 = phase_train_parity(card, card_out=card6)
    tmp = tempfile.mkdtemp(prefix="thp_smoke_")
    try:
        ckpt = os.path.join(tmp, "latest.pth")
        train_counts = phase_train(card, ckpt)
        eval32 = phase_eval_parity(card)
        eval_counts = phase_eval(card, ckpt, tmp)
        phase_recon_parity(card)
        recon_counts, k1_grid = phase_reconstruction(card, ckpt, tmp)
        # bf16: parity against the CPU, then every path at full width
        phase_parity(card, "bfloat16", render32)
        phase_train_parity(card, "bfloat16", step32)
        phase_eval_parity(card, "bfloat16", eval32)
        by_path = {"serve": serve_counts, "train": train_counts,
                   "eval": eval_counts, "reconstruction": recon_counts}
        ckpt16 = os.path.join(tmp, "latest_bf16.pth")
        by_path["serve_bf16"] = phase_serve(card, "bfloat16")
        by_path["train_bf16"] = phase_train(card, ckpt16, "bfloat16")
        by_path["eval_bf16"] = phase_eval(card, ckpt16, tmp, "bfloat16")
        by_path["reconstruction_bf16"] = phase_reconstruction(
            card, ckpt16, tmp, "bfloat16")[0]
        # the config files, LPIPS and the train loop's lifecycle
        files = write_weight_files(tmp)
        phase_lpips(card, files["lpips"])
        by_path["train_cfg_bf16"], model_root = phase_train_cfg(
            card, tmp, files, "bfloat16")
        by_path["train_cfg"] = phase_train_cfg(card, tmp, files,
                                               "float32")[0]
        by_path.update(phase_eval_cfg(card, tmp, model_root, files))
        lp32 = phase_train_parity(card, lpips=files["lpips"])
        phase_train_parity(card, "bfloat16", lp32, lpips=files["lpips"])
        # the ZJU-MoCap loader: its codec, then train, evaluate, visualize
        # and reconstruction on laid-out humans
        phase_codec(card)
        zju_paths, zju_root, zju_models = phase_train_zju(card, tmp, files)
        by_path.update(zju_paths)
        by_path.update(phase_eval_zju(card, tmp, zju_models))
        # visibility from depth maps on phase g's and f's laid-out humans
        by_path.update(phase_depth(card, tmp, zju_root, zju_models))
        # batches, the train cull, remat and the per-vertex radii cull
        k1_bias = phase_cull_bias(card)
        phase_batch_parity(card, card6)
        h3_paths, ckpt_b4 = phase_train_batches(card, tmp)
        by_path.update(h3_paths)
        by_path.update(phase_radii(card, tmp, ckpt_b4))
        by_path.update(phase_train_zju_batch(card, tmp, zju_root, files))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k in kernels:
        # launches: the count of this slice's path, reconstruction in the
        # kernel's dtype (bf16 for the bf16 forms), for the render kernels;
        # K3 runs on the train path only
        name = k["name"]
        path = ("train" if name.startswith("dfeat_scatter")
                else "reconstruction")
        if name.endswith("_bf16"):
            path += "_bf16"
        k["launches"] = by_path[path][name]
        k["launches_by_path"] = {p: c[name] for p, c in by_path.items()}
        if name == "min_excess2":
            # K1's one launch on this path covers the whole grid: its numbers
            # are that shape's, and phase 3's, at one render chunk, stay
            # beside them as chunk_*; the bias form's (phase h1) beside them
            for key, v in k1_grid.items():
                k[f"chunk_{key}"], k[key] = k[key], v
            k["bias_form"] = k1_bias
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
