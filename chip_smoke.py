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

e. the port's image readers, the codec built with g++, on each committed
   fixture of tests/fixtures/torch_zju (baseline JPEGs, masks),
   torch_zju_codings (progressive, truncated progressive, CMYK, YCCK and
   EXIF-6 JPEGs, a 16-bit RGBA PNG frame, an Adam7 mask) and
   torch_zju_formats (RLE8 and 5-6-5 BMPs, ASCII and 16-bit PPMs, a PFM, a
   Sun raster, LZW, Deflate and big-endian tiled planar TIFFs, interlaced
   and transparent GIFs, run-length and flat Radiance HDRs, lossless,
   lossy, lossy-with-alpha and animated WebPs, a 1024x1024 q90 lossy
   WebP, JPEG 2000 files of Pillow and tests/_torch_formats.py's
   j2k_random, 1024x1024 lossless (5/3) and lossy (9/7) JP2s): its bytes
   against the sha256 of cv2's or imageio's decode in the folder's
   digests.json; each decode timed, and that of 1024x1024 BMP, PPM, Sun
   raster, TIFF, GIF, Radiance HDR and lossless WebP frames formed here;
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
   K2 and K4 launched on each, K3 in the step;
m. image codings: humans laid out with Adam7 masks whose 1024x1024 views
   are the committed progressive JPEG, an EXIF-3 splice of it and a PNG
   frame of its decode: the train entry point (train_or_eval.yaml) for 2
   bf16 steps on the JPEG views, then --type evaluate on its checkpoint
   over one frame of PNG frames, counters reset and read around each
   (K2, K4 and K3 in the steps, K1, K2 and K4 in the evaluation), finite
   losses and metrics, and each coding read by the loader.

Then data parallelism across processes, each command ``python -m
torch.distributed.run --standalone --nproc_per_node N -m
transhuman_tpu_torch.cli.{train,run}`` with a timeout, every rank printing
its own step times, gradient all-reduce and kernel launches (two ranks
sharing the one card over gloo measure the wiring, not scaling):

j1. the train entry point over 2 ranks (gloo) at full width, one sample a
   rank: one float32 step against this process's step on both samples
   (phase 6's bounds), then 4 bf16 steps with train.cull, K1, K2, K4 and
   K3 launched on each rank; j2. one rank over NCCL, 2 bf16 steps and its
   saves; j3. the run entry point over 2 ranks on j1's checkpoint:
   evaluate 3 frames (2 + 1) against one process (phase 8's per-frame
   bounds), visualize into one AVI assembled once, reconstruct 2 frames at
   0.005 m, one per rank, each PLY the one-process one.

Then ray-sharded inference (``mesh_axis_rays``) and the remaining tools:

k1. make_sharded_render on a full-width 512x512 request over [cuda:0,
   cuda:1], or [cuda:0, cuda:0] on one card (which measures the wiring,
   not the scaling), against one device's render_frame with the same
   weights: the maps within 1e-6 (rgb, acc) and 1e-5 (depth), the
   survivors equal, and the launches exactly as the code predicts (K1 one
   a 512-ray chunk, K2 one a chunk with survivors, K4 that plus one
   painting fetch a share); the render ms at R = 1 and 2 in turns;
k2. with two cards or more the run entry point's --type evaluate with
   mesh_axis_rays 2, its metric files those of mesh_axis_rays 1; on one
   card its refusal with the counts, then evaluate_frames over two shares
   of the card against one device, per-frame PSNR and SSIM within 1e-9;
k3. tools/doctor over phase g's laid-out human with phase 7's checkpoint:
   exit 0, the card, nvcc, g++ and both build rows PASS;
k4. tools/validate_official over a laid-out CoreView_377 and CoreView_387
   with a random official-layout .pth at full width: all four protocols
   on the card, the report written, each protocol's PSNR and SSIM those of
   a direct --type evaluate with the same argv;
k5. tools/make_kmeans on a stand-in SMPL pickle: its file loads back
   through ClusterSpec.load_reference_dict with the same assignment.

Then the model axis (``mesh_axis_model``, parallel/tp.py and pp.py):

l0. K2 and its bf16 form at the token widths of TransHE small and base
   (D = 384 and 768) against their plain twins at phase 3's tolerances,
   timed beside their bounds;
l1. the train entry point over 2 ranks sharing the card (gloo) at
   mesh_axis_model 2 with TransHE small (384, 6 heads, depth 12; base's
   positional code is NaN in both packages, see L_VARIANT): one float32
   step against this process's one-process step (phase 6's bounds), each
   rank's TransHE shards the saved file's cut; then 2 bf16 steps with
   train.cull, each rank's TransHE and moment bytes (the sharded leaves
   at half), step ms, the model axis's all-reduce count (4 x depth) and
   ms, and K1, K2, K4 and K3 launches;
l2. the pipelined TransHE base (3 x 300 x 768, depth 12, a stored table)
   over 2 gloo ranks on the card (this script as ``--pp-worker DIR`` under
   torchrun), 2 stages in 3 microbatches, against the unpipelined module
   (output within 1e-5, gradients within 2e-6), both timed.

Then the frame formats beside JPEG and PNG, mesh_axis_rays under torchrun
and the examples:

n1. CoreView_377 laid out with 1024x1024 BMP, PPM, Sun raster, TIFF, GIF,
   Radiance HDR, lossless and lossy WebP and lossless and lossy JP2
   frames: the train entry point
   (train_or_eval.yaml, float32) for 2 steps under torchrun (1 rank) at
   mesh_axis_rays 2, its losses those of the same run here at
   mesh_axis_rays 1 (phase 6's bound), K2, K4 and K3 launched; then --type
   evaluate on its checkpoint over a frame whose input and target views
   take the ten codings: finite metrics, K1, K2 and K4 launched, each
   format read;
n2. examples/torch_minimal_render.py and torch_minimal_train.py on the
   card: exit 0, a 32x32 PNG, finite losses.

Every visualize run (phases 9, c, g, i, j3) also writes one MJPG/AVI per
human, parsed here: one JPEG frame per PNG.  Phase 11 also times the C++
marching the command took against the numpy route on the same cube (the
same sorted vertex set within 1e-6 grid units, the same triangle count),
runs the command once more on the numpy route, and renders a 4-frame mesh
video of its PLY (tools/render_mesh_video), timed.

The last three lines are {"kernels": [...]}, the card's name and power
limit as nvidia-smi prints them, and {"ok": true, "device": {...}}.
Imports only torch, numpy, the port and the numpy image writers of
tests/_torch_formats.py.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import re
import shutil
import signal
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


def f32_step_gaps(what: str, gg, gc, dg, dc, p0, lr):
    """Phase 6's float32 bounds on a step g against a reference step c
    from the same weights p0 (gradients gg/gc and updates dg/dc by name):
    each gradient leaf within 1e-3 of its norm plus 1e-5 of the largest
    leaf's, Adam's first update within 0.01 lr where the gradient's sign is
    sure and 2 lr anywhere.  Returns ((error / tolerance, leaf) worst
    first, the largest relative leaf error above the floor, the update
    errors beyond rounding where sure and anywhere)."""
    gmax = max(float(gc[n].norm()) for n in gc)
    # per leaf, relative to its norm, with a floor of 1e-5 of the largest
    # leaf's norm: some leaves' gradients vanish in exact arithmetic (the
    # pixel keys' bias: a constant shift of every key under the softmax over
    # the keys) and hold float32 noise that differs between the two devices
    rel = sorted(((float((gg[n] - gc[n]).norm())
                   / (1e-3 * float(gc[n].norm()) + 1e-5 * gmax), n)
                  for n in gc), reverse=True)
    gerr = max(float((gg[n] - gc[n]).norm() / gc[n].norm()) for n in gc
               if float(gc[n].norm()) > 1e-5 * gmax)
    check(rel[0][0] <= 1.0, f"{what}: gradients differ beyond "
          f"tolerance: {rel[:3]} (error / tolerance, leaf)")
    worst_tight = worst = 0.0
    for n in gc:
        d = (dg[n] - dc[n]).abs()
        slack = 2 * lr * 1e-3 + 2 * torch.finfo(torch.float32).eps * (
            p0[n].abs() + 1)
        # Adam's first update is -lr g / (|g| + 1e-8): +-lr wherever the
        # sign of g is sure; elsewhere anywhere in [-lr, lr]
        sure = (gc[n].abs() > 1e-6) & ((gg[n] - gc[n]).abs()
                                       < 0.5 * gc[n].abs())
        worst_tight = max(worst_tight, float((d - slack)[sure].max()
                                             if sure.any() else 0.0))
        worst = max(worst, float((d - slack).max()))
    check(worst_tight <= 0.01 * lr and worst <= 2 * lr,
          f"{what}: updates differ by {worst_tight} (sure sign) / "
          f"{worst} (all) at lr {lr}")
    return rel, gerr, worst_tight, worst


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
    rel, gerr, worst_tight, worst = f32_step_gaps("train parity", gg, gc, dg,
                                                  dc, p0c, lr)
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

    def checked(cfg, device, dataset=None, ckpt=None, mesh=None):
        out = build(cfg, device, dataset, ckpt, mesh)
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
# progressive, truncated, CMYK, YCCK and EXIF-oriented JPEGs, a 16-bit RGBA
# PNG frame and an Adam7 mask (tests/test_torch_codings.py makes them)
CODINGS = os.path.join(os.path.dirname(FIXTURES), "torch_zju_codings")
ZJU_CAMS = 23  # cameras on set (the regular layout)
ZJU_TRAIN_STEPS = 12  # per dtype and dataset in phase f: past the loader's prefill
ZJU_EVAL_FRAMES = 2  # frames of CoreView_387 laid out for phase g
HOST_SPLIT_SAMPLES = (0, 57, 131)  # train samples of the host splits
HOST_SPLITS = {}  # phase f's median host split of a JPEG sample


def phase_codec(card: str) -> dict:
    """e. Each committed fixture of tests/fixtures/torch_zju,
    torch_zju_codings and torch_zju_formats decoded by the port's codec
    (built in phase 2 with g++ from transhuman_tpu_torch/native) as the
    loader reads it (a frame by imread_rgb, a mask by read_png), its bytes
    held against the sha256 of cv2's or imageio's decode recorded in the
    folder's digests.json; each decode timed on the host (_decode_ms), and
    so the decode of 1024x1024 BMP, PPM, Sun raster, TIFF (Deflate: RGB,
    CMYK, CIELab, BigTIFF), GIF, Radiance HDR and lossless WebP
    frames formed here and of the committed q90 lossy WebP, lossless and
    lossy JP2s and YCbCr 4:2:0 JPEG-TIFF (format_frames); the event files'
    CRC32C, native against the Python table."""
    import hashlib

    from transhuman_tpu_torch.data import image_io

    out, by = {}, set()
    for folder, n in ((FIXTURES, 5), (CODINGS, 8), (FORMATS, 40)):
        with open(os.path.join(folder, "digests.json")) as f:
            digests = json.load(f)
        check(len(digests) == n,
              f"codec: {folder} lists {len(digests)} fixtures")
        for name, want in sorted(digests.items()):
            path = os.path.join(folder, name)
            read = image_io.read_png if name.startswith("mask") else \
                image_io.imread_rgb
            img = read(path)
            got = hashlib.sha256(np.ascontiguousarray(img).tobytes()
                                 ).hexdigest()
            check(got == want["sha256"] and list(img.shape) == want["shape"],
                  f"codec: {name} decodes to {got[:12]}.. {img.shape}, want "
                  f"{want['sha256'][:12]}.. {want['shape']} ({want['by']})")
            out[name] = _decode_ms(read, path)
            by.add(want["by"])
    # the other formats at the loader's size: 1024x1024 frames formed here
    # (the committed ones, timed above, not again)
    src_dir = tempfile.mkdtemp(prefix="thp_formats_")
    try:
        for kind, path in format_frames(src_dir).items():
            name = os.path.basename(path)
            out[f"1024_{kind}"] = out[name] if os.path.dirname(
                path) == FORMATS else _decode_ms(image_io.imread_rgb, path)
    finally:
        shutil.rmtree(src_dir, ignore_errors=True)
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
    log(f"[e codec] every fixture ({len(out)}) equals "
        f"{', '.join(sorted(by))} bit for bit; host ms per decode (median "
        f"of 20): " + ", ".join(f"{k} {v:.2f}" for k, v in out.items())
        + f"; progressive 1024x1024 q95 4:2:0 against the sequential one "
        f"{out['cv2_prog_q95_420.jpg'] / out['cv2_q95_420.jpg']:.2f}x; "
        f"1024x1024 24-bit BMP, P6, 24-bit Sun raster, Deflate TIFF, GIF, "
        f"RLE HDR, lossless WebP, q90 lossy WebP, lossless (5/3) JP2, "
        f"lossy (9/7) JP2, YCbCr 4:2:0 JPEG-TIFF, Deflate CMYK TIFF, Deflate "
        f"CIELab TIFF, Deflate BigTIFF against the sequential JPEG "
        + ", ".join(f"{out[f'1024_{k}'] / out['cv2_q95_420.jpg']:.2f}x"
                    for k in ("bmp", "ppm", "sun", "tiff", "gif", "hdr",
                              "webp_lossless", "webp_lossy", "jp2_lossless",
                              "jp2_lossy", "tiff_jpeg", "tiff_cmyk",
                              "tiff_cielab", "bigtiff"))
        + f"  [{card}]")
    return out


def _decode_ms(read, path) -> float:
    """Host ms of read(path), median of 20 (of 5 where one decode takes
    50 ms or more: the 1024x1024 JPEG 2000 frames)."""
    t = time.perf_counter()
    read(path)
    first = time.perf_counter() - t
    ms = []
    for _ in range(20 if first < 0.05 else 5):
        t = time.perf_counter()
        read(path)
        ms.append((time.perf_counter() - t) * 1e3)
    return float(np.median(ms))


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


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))  # x0, y0, dx, dy


def adam7_png(grey: np.ndarray) -> bytes:
    """An 8-bit grey PNG of grey, Adam7-interlaced: its seven passes in
    turn, each row under the Sub filter."""
    import struct
    import zlib

    h, w = grey.shape
    raw = []
    for x0, y0, dx, dy in ADAM7:
        sub = grey[y0::dy, x0::dx].astype(np.int16)
        if sub.size:
            d = np.diff(sub, axis=1, prepend=0).astype(np.uint8)
            raw.append(np.concatenate([np.ones((len(d), 1), np.uint8), d],
                                      1).tobytes())

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 1))
            + chunk(b"IDAT", zlib.compress(b"".join(raw), 6))
            + chunk(b"IEND", b""))


def _mask_png(verts, K, R, T, hw, adam7: bool = False) -> bytes:
    """8-bit grey PNG (0/255) of the body: the vertices' projection on a
    16-pixel grid, grown by one cell; Adam7-interlaced with adam7."""
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
    mask = np.repeat(np.repeat(cells, 16, 0), 16, 1)
    return adam7_png(mask) if adam7 else encode_png(mask)


def fixture_jpegs() -> list:
    """The three committed 1024x1024 baseline JPEGs."""
    return sorted(os.path.join(FIXTURES, f) for f in os.listdir(FIXTURES)
                  if f.endswith(".jpg"))


def write_zju_layout(root: str, human: str, frames, n_annots: int,
                     seed: int = 0, sources=None, adam7: bool = False):
    """A ZJU-MoCap human under root in the reference's layout: annots.npy
    (ZJU_CAMS cameras, n_annots frames listed), for each of ``frames`` the
    23 views hard-linked to 1024x1024 image files, masks from the posed
    synthetic body's projection (Adam7-interlaced with adam7),
    new_vertices/new_params of SMPLModel.synthetic() posed, and visibility
    files for the first half of the cameras (the rest fall back to all
    ones).  sources: lists of files; the k-th frame's views cycle through
    sources[k % len(sources)] and take its first file's extension, cut to
    3 letters (an input view reads the target's file name); by default the
    committed fixture JPEGs."""
    from transhuman_tpu_torch.geometry.smpl import SMPLModel, rodrigues

    rng = np.random.default_rng(seed)
    smpl = SMPLModel.synthetic()
    hdir = os.path.join(root, human)
    cams = _zju_cameras(ZJU_CAMS)
    sources = sources or [fixture_jpegs()]
    # the loader reads a frame's index from its name less 4 characters, as
    # the reference does: a longer extension (.webp) is cut to 3 letters
    # (readers decode by content)
    ext = {f: os.path.splitext(sources[k % len(sources)][0])[1][:4]
           for k, f in enumerate(frames)}
    ims = [{"ims": [f"Camera_B{c + 1}/{f:06d}{ext.get(f, '.jpg')}"
                    for c in range(ZJU_CAMS)]} for f in range(n_annots)]
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
            dst = os.path.join(hdir, cdir, f"{f:06d}{ext[f]}")
            views = sources[k % len(sources)]
            src = views[(k + c) % len(views)]
            try:
                os.link(src, dst)
            except OSError:
                shutil.copyfile(src, dst)
            with open(os.path.join(hdir, "mask", cdir, f"{f:06d}.png"),
                      "wb") as fh:
                fh.write(_mask_png(verts, *(np.asarray(cams[x][c]) for x in
                                           ("K", "R", "T")), (1024, 1024),
                                   adam7))
            if c < ZJU_CAMS // 2:
                vdir = os.path.join(root, "raster", human, "visibility", cdir)
                os.makedirs(vdir, exist_ok=True)
                np.save(os.path.join(vdir, f"{f:06d}.npy"),
                        (rng.random(smpl.v_template.shape[0]) > 0.4))
    np.save(os.path.join(hdir, "annots.npy"), {"cams": cams, "ims": ims})


def host_split(data, index: int) -> dict:
    """One train sample's host ms by stage, the stages of
    ZJUDataset.get_train_sample run one by one on its inputs (remap plans
    cached, as in steady state): decode (4 frames and their masks),
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
    write_zju_layout(root, "CoreView_377", range(0, 300, 30), 300,
                     sources=[fixture_jpegs()])
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
    split = [host_split(data, i) for i in HOST_SPLIT_SAMPLES]
    med = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    HOST_SPLITS["jpeg"] = med
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
                     ZJU_EVAL_FRAMES, seed=1, sources=[fixture_jpegs()])
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


def phase_codings(card: str, tmp: str, files: dict) -> dict:
    """m. The ZJU loader on image codings beyond baseline JPEG, through the
    entry points, on humans laid out at 1024x1024 with Adam7 masks whose
    views are the committed progressive JPEG (cv2, q95, 4:2:0), an EXIF-3
    splice of it (decoded turned 180 degrees, as cv2 turns it) and a PNG
    frame of its decode written here with utils/png.py's encode_png: the
    train entry point (train_or_eval.yaml, CoreView_377 of progressive and
    EXIF-3 views) for 2 bf16 steps, then --type evaluate (CoreView_387
    frame 0 of PNG frames) on its checkpoint, counters reset just before
    and read just after each: finite losses and metrics, K2, K3 and K4
    launched in the steps, K1, K2 and K4 in the evaluation, and every
    coding read by the loader (the loader's two readers wrapped to tell
    them)."""
    import threading

    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.data import image_io, zju
    from transhuman_tpu_torch.utils.png import encode_png

    t0 = time.perf_counter()
    src = os.path.join(tmp, "codings_src")
    os.makedirs(src, exist_ok=True)
    prog = os.path.join(CODINGS, "cv2_prog_q95_420.jpg")
    with open(prog, "rb") as fh:
        data = fh.read()
    # APP1: Exif, a little-endian TIFF whose IFD0 holds orientation 3
    app1 = (b"Exif\0\0II*\0\x08\0\0\0\x01\0\x12\x01\x03\0\x01\0\0\0"
            b"\x03\0\0\0\0\0\0\0")
    exif3 = os.path.join(src, "prog_exif3.jpg")
    with open(exif3, "wb") as fh:
        fh.write(data[:2] + b"\xff\xe1" + (len(app1) + 2).to_bytes(2, "big")
                 + app1 + data[2:])
    rgb = image_io.imread_rgb(prog)
    png = os.path.join(src, "frame.png")
    with open(png, "wb") as fh:
        fh.write(encode_png(rgb))
    check(np.array_equal(image_io.imread_rgb(exif3), rgb[::-1, ::-1])
          and np.array_equal(image_io.imread_rgb(png), rgb),
          "codings: the EXIF-3 splice or the PNG frame does not read back")
    root = os.path.join(tmp, "zju_codings")
    write_zju_layout(root, "CoreView_377", range(0, 300, 30), 300, seed=2,
                     sources=[[prog, exif3]], adam7=True)
    write_zju_layout(root, "CoreView_387", range(ZJU_EVAL_FRAMES),
                     ZJU_EVAL_FRAMES, seed=3, sources=[[png]], adam7=True)
    layout_s = time.perf_counter() - t0

    seen, lock = {}, threading.Lock()
    read_frame, read_mask = zju.imread_rgb, zju.read_mask_png

    def count(kind):
        with lock:
            seen[kind] = seen.get(kind, 0) + 1

    def frame(path):
        out = read_frame(path)
        count(next((k for k, f in (("progressive", prog), ("exif3", exif3),
                                   ("png", png)) if os.path.samefile(path, f)),
                   "other frame"))
        return out

    def mask(path):
        out = read_mask(path)
        with open(path, "rb") as fh:
            count("adam7 mask" if fh.read(29)[28] == 1 else "other mask")
        return out

    cfg_file = os.path.join(CONFIGS, "train_or_eval.yaml")
    run = os.path.join(tmp, "codings_train")
    common = ["--device", "cuda", "--cfg_file", cfg_file, "data_root", root,
              "rasterize_root", os.path.join(root, "raster"),
              "trained_model_dir", os.path.join(run, "tm"), "result_dir",
              os.path.join(run, "res")]
    f = forms("bfloat16")
    by_path = {}
    zju.imread_rgb, zju.read_mask_png = frame, mask
    try:
        t = time.perf_counter()
        kernels.reset_launch_counts()
        _, recs = train_cli.main(common + [
            "dataset", "zju", "lpips_weights", files["lpips"],
            "encoder_weights", files["resnet"], "ep_iter", "2",
            "train.epoch", "1", "compute_dtype", "bfloat16", "record_dir",
            os.path.join(run, "rec")])
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        by_path["train_codings_bf16"] = kernels.launch_counts()
        train_seen = dict(seen)
        check(len(recs) == 2 and all(np.isfinite(r["loss"])
                                     and r["lpips_loss"] > 0 for r in recs),
              f"train codings: {recs}")
        check_launches("train codings", by_path["train_codings_bf16"],
                       {f["dparf"]: 2, f["scatter"]: 4, f["fetch"]: 4})
        seen.clear()
        t = time.perf_counter()
        kernels.reset_launch_counts()
        summary = run_cli.main(["--type", "evaluate", *common])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        by_path["eval_codings_bf16"] = kernels.launch_counts()
    finally:
        zju.imread_rgb, zju.read_mask_png = read_frame, read_mask
    check(np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"]),
          f"evaluate codings: {summary}")
    check_launches("evaluate codings", by_path["eval_codings_bf16"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    check(train_seen.get("progressive") and train_seen.get("exif3")
          and train_seen.get("adam7 mask") and seen.get("png")
          and seen.get("adam7 mask") and not any(
              k.startswith("other") for k in (*train_seen, *seen)),
          f"codings: the loader read {train_seen} in training, {seen} in "
          "the evaluation")
    log(f"[m codings] train_or_eval.yaml (bf16) on 1024x1024 views of "
        f"mixed codings: 2 steps, losses "
        f"{', '.join(f'{r['loss']:.4f}' for r in recs)}, step ms "
        f"{', '.join(f'{r['step_s'] * 1e3:.1f}' for r in recs)}, sample_s "
        f"{', '.join(f'{r['sample_s'] * 1e3:.1f}' for r in recs)} ms; "
        f"files read {train_seen}; launches {by_path['train_codings_bf16']}"
        f"; --type evaluate, 1 frame of PNG frames: psnr "
        f"{summary['psnr']:.3f}, ssim {summary['ssim']:.4f}; files read "
        f"{seen}; launches {by_path['eval_codings_bf16']}; layout "
        f"{layout_s:.1f} s, train {train_s:.1f} s, evaluate {eval_s:.1f} s"
        f"  [{card}]")
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


# ------------------------------------- data parallelism across processes
ROOT = os.path.dirname(os.path.abspath(__file__))
J_TIMEOUT = 300  # s for one torchrun command, its ranks' start included
J_STEPS = 4  # bf16 steps of phase j1's culled run
J_EVAL_FRAMES = ("test.frame_interval", "3")  # frames 0, 3, 6: ranks 2 + 1
J_RECON_FRAMES = ("test.frame_interval", "4")  # frames 0, 4: one per rank
J_MESH_TH = "5"  # below a 1-step model's sigma of ~10: the cull's shell


def torchrun(what: str, nproc: int, module: str, argv, backend="gloo"):
    """``python -m torch.distributed.run --standalone --nproc_per_node
    nproc -m module --dist_backend backend argv`` (a module ending in .py
    is a script path, run as it is) from the checkout's root,
    in a session of its own that is killed whole at J_TIMEOUT or once it
    ends; fails unless it exits 0 and every rank printed its rank report.
    Returns (its output, the reports in rank order, its seconds)."""
    target = [module] if module.endswith(".py") else ["-m", module]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *target, "--dist_backend",
           backend, *argv]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    timed_out = False
    try:
        out = proc.communicate(timeout=J_TIMEOUT)[0]
    except subprocess.TimeoutExpired:
        timed_out = True
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0]
    finally:
        try:  # nothing the command started outlives it
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    secs = time.perf_counter() - t0
    check(not timed_out and proc.returncode == 0,
          f"{what}: {' '.join(cmd[1:])} "
          f"{'timed out' if timed_out else f'exited {proc.returncode}'} "
          f"after {secs:.1f} s:\n{out[-6000:]}")
    # a report is one write ending its line, but it may start mid-line: with
    # PYTHONUNBUFFERED a print is two writes (text, then "\n"), and another
    # rank's report can land between them
    reports = sorted((json.loads(m) for m in re.findall(
        r"rank report: (\{.*\})$", out, re.M)), key=lambda r: r["rank"])
    check([(r["rank"], r["world"]) for r in reports]
          == [(r, nproc) for r in range(nproc)],
          f"{what}: rank reports {reports}\n{out[-3000:]}")
    return out, reports, secs


def _summed(reports) -> dict:
    return {k: sum(r["launches"][k] for r in reports)
            for k in reports[0]["launches"]}


def _adam_step(path: str):
    """(weights by name, gradients by parameter index) of a one-step
    checkpoint, on the CPU: a first Adam step's gradient is its first
    moment / (1 - beta1)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob["optim"]["state"]
    params = blob["optim"]["param_groups"][0]["params"]
    return blob["net"], {i: state[i]["exp_avg"] / 0.1
                         for i in params if i in state}


def phase_dp_train(card: str, tmp: str):
    """j1. The train entry point over 2 ranks on the one card (torchrun,
    --dist_backend gloo, which lets ranks share a card), full width
    (phase 7's Config() defaults), train.batch_size 1 per rank from the
    seeded weights: one float32 step against this process's one-process
    step at train.batch_size 2 on the same samples and seeds (loss ≤ 1e-4
    relative, phase 6's gradient and update bounds; the gradients from
    each checkpoint's Adam moment), then J_STEPS bf16 steps with
    train.cull, K1, K2, K4 and K3 launched on each rank.  j2. One rank over
    NCCL (the default backend), 2 bf16 steps: the NCCL group, the card's
    gradient all-reduce and rank 0's saves.  Two ranks on one card measure
    the wiring, not the scaling.  Returns ({path: launches}, the float32
    2-rank checkpoint)."""
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.models.network import TransHumanNet
    from transhuman_tpu_torch.testing import init_weights

    module = "transhuman_tpu_torch.cli.train"
    run = os.path.join(tmp, "j")

    def opts(tag, steps, *extra):
        """The flags, then the config overrides, of one run."""
        return ["--device", "cuda", "--steps", str(steps), "dataset",
                "synthetic", "ep_iter", str(steps), "train.epoch", "1",
                "trained_model_dir", os.path.join(run, tag, "tm"),
                "record_dir", os.path.join(run, tag, "rec"), "result_dir",
                os.path.join(run, tag, "res"), *extra]

    dp_ckpt, one_ckpt = (os.path.join(run, f"{t}.pth") for t in ("dp", "one"))
    torch.cuda.empty_cache()
    out, reps, secs = torchrun("j1 float32", 2, module, [
        "--out", dp_ckpt, *opts("dp", 1, "train.batch_size", "1")])
    check("shared round-robin over gloo" in out,
          f"j1: the ranks did not say they share the card:\n{out[-2000:]}")
    _, recs = train_cli.main(["--out", one_ckpt, *opts(
        "one", 1, "train.batch_size", "2")])
    torch.cuda.empty_cache()
    cfg = Config().merge_opts(["dataset", "synthetic"])
    net = init_weights(TransHumanNet.from_config(cfg),
                       torch.Generator().manual_seed(cfg.seed))
    p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    (w_dp, m_dp), (w_one, m_one) = map(_adam_step, (dp_ckpt, one_ckpt))
    names = list(p0)
    g_dp = {names[i]: g for i, g in m_dp.items()}
    g_one = {names[i]: g for i, g in m_one.items()}
    check(set(g_one) == set(names) - UNREAD_PARAMS and set(g_one) <= set(g_dp),
          "j1: the parameters with a gradient differ")
    d_dp = {n: w_dp[n] - p0[n] for n in g_one}
    d_one = {n: w_one[n] - p0[n] for n in g_one}
    loss_dp, loss_one = reps[0]["loss"][0], recs[0]["loss"]
    check(reps[1]["loss"] == reps[0]["loss"], f"j1: the ranks' losses differ "
          f"{[r['loss'] for r in reps]}")
    lerr = abs(loss_dp - loss_one) / loss_one
    check(lerr <= 1e-4, f"j1: loss {loss_dp} over 2 ranks vs {loss_one}")
    rel, gerr, wt, w = f32_step_gaps("j1 2-rank step vs 1 process", g_dp,
                                     g_one, d_dp, d_one, p0, recs[0]["lr"])
    log(f"[j1 dp train] full width, float32, 2 ranks x train.batch_size 1 "
        f"(gloo, sharing the card) vs 1 process x 2: loss {loss_dp:.7g} vs "
        f"{loss_one:.7g} (rel {lerr:.3g}); max gradient err {gerr:.3g} of "
        f"its leaf's norm; worst error/tolerance {rel[0][0]:.3g} "
        f"({rel[0][1]}); update err beyond rounding {wt:.3g} where the "
        f"sign is sure, {w:.3g} anywhere; torchrun {secs:.1f} s; per-rank "
        f"step ms {[round(r['step_ms'][0], 1) for r in reps]}; gradient "
        f"all-reduce {[round(r['grad_allreduce_ms'][0], 2) for r in reps]} "
        f"ms of {reps[0]['grad_allreduce_mb']:.2f} MB (the first step)  "
        f"[{card}]")

    f = forms("bfloat16")
    bf16 = ("compute_dtype", "bfloat16", "train.batch_size", "1")
    out, reps16, secs16 = torchrun("j1 bf16", 2, module, opts(
        "bf16", J_STEPS, "train.cull", "True", *bf16))
    for r in reps16:
        check(len(r["loss"]) == J_STEPS and np.isfinite(r["loss"]).all(),
              f"j1 bf16 rank {r['rank']}: losses {r['loss']}")
        check(r["launches"]["min_excess2"] == J_STEPS, f"j1 bf16 rank "
              f"{r['rank']}: K1 launched {r['launches']['min_excess2']} "
              f"times, want {J_STEPS}")
        check_launches(f"j1 bf16 rank {r['rank']}", r["launches"], {
            "min_excess2": J_STEPS, f["dparf"]: J_STEPS,
            f["fetch"]: 2 * J_STEPS, f["scatter"]: 2 * J_STEPS})
    check(reps16[0]["loss"] == reps16[1]["loss"], "j1 bf16: the ranks' "
          "losses differ")

    def steps(r):
        return ", ".join(f"{x:.1f}" for x in r["step_ms"])

    def reduce_ms(r):
        return ", ".join(f"{x:.2f}" for x in r["grad_allreduce_ms"])

    log(f"[j1 dp train bf16] full width, bf16, train.cull, 2 ranks x "
        f"train.batch_size 1 sharing the card (gloo), {J_STEPS} steps in "
        f"{secs16:.1f} s of torchrun: " + "; ".join(
            f"rank {r['rank']} step ms {steps(r)}, gradient all-reduce ms "
            f"{reduce_ms(r)}" for r in reps16)
        + f"; {reps16[0]['grad_allreduce_mb']:.2f} MB a step; launches per "
        f"rank {[r['launches'] for r in reps16]}; losses "
        f"{', '.join(f'{x:.4f}' for x in reps16[0]['loss'])}; two ranks on "
        f"one card measure the wiring, not scaling  [{card}]")

    nccl_ckpt = os.path.join(run, "nccl.pth")
    out, reps2, secs2 = torchrun("j2 nccl", 1, module, [
        "--out", nccl_ckpt, *opts("nccl", 2, *bf16)],
        backend="nccl")
    (r2,) = reps2
    latest = os.path.join(run, "nccl", "tm", "transhuman", "transhuman_tpu",
                          "latest.pth")
    blob = torch.load(nccl_ckpt, map_location="cpu", weights_only=False)
    check(os.path.isfile(latest) and blob["step"] == 2, f"j2: checkpoints "
          f"{latest} (exists {os.path.isfile(latest)}), step {blob['step']}")
    check(len(r2["loss"]) == 2 and np.isfinite(r2["loss"]).all(),
          f"j2: losses {r2['loss']}")
    check_launches("j2 nccl", r2["launches"], {
        f["dparf"]: 2, f["fetch"]: 4, f["scatter"]: 4})
    log(f"[j2 nccl] full width, bf16, 1 rank over NCCL (the default "
        f"backend), 2 steps in {secs2:.1f} s of torchrun: step ms "
        f"{steps(r2)}; gradient all-reduce ms {reduce_ms(r2)} of "
        f"{r2['grad_allreduce_mb']:.2f} MB on the card; rank 0 wrote "
        f"latest.pth and --out  [{card}]")
    return ({"dp_train": _summed(reps16), "dp_train_nccl": r2["launches"]},
            dp_ckpt)


def phase_sharded_eval(card: str, tmp: str, ckpt: str) -> dict:
    """j3. The run entry point over 2 ranks on the one card (gloo) on
    phase j1's 2-rank checkpoint, full width: --type evaluate of 3 frames
    (rank 0 two, rank 1 one) against a one-process evaluate of the same
    frames in this process (the .npy files in the same order, per-frame
    PSNR within 0.05 dB and SSIM 2e-3, every rank printing that summary);
    --type visualize, one AVI of every frame assembled once; --type
    reconstruction of 2 frames at RECON_VOXEL, one per rank, each PLY the
    one-process PLY of its frame.  Returns {path: launches}."""
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.mesh_ops.ply import load_ply

    module = "transhuman_tpu_torch.cli.run"
    run = os.path.join(tmp, "j3")
    base = ["--device", "cuda", "--weights", ckpt, "dataset", "synthetic",
            "trained_model_dir", os.path.join(run, "tm"), "record_dir",
            os.path.join(run, "rec")]
    res = {n: os.path.join(run, f"res{n}") for n in (1, 2)}
    out_dir = {n: os.path.join(r, "epoch_-1", "debug")
               for n, r in res.items()}
    torch.cuda.empty_cache()
    out, reps, secs = torchrun("j3 evaluate", 2, module, [
        "--type", "evaluate", *base, "result_dir", res[2], *J_EVAL_FRAMES])
    check([r["frames"] for r in reps] == [2, 1], f"j3 evaluate: frames per "
          f"rank {[r['frames'] for r in reps]}")
    f = forms("float32")
    for r in reps:
        check_launches(f"j3 evaluate rank {r['rank']}", r["launches"], {
            "min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    # each rank prints the summary dict (the ranks' lines may interleave)
    summaries = re.findall(r"\{'experiment'[^}]*\}", out)
    check(len(summaries) == 2 and summaries[0] == summaries[1],
          f"j3 evaluate: the ranks' summaries {summaries}")
    timing = {}
    run_eval = run_cli.run_evaluate

    def timed(*args, **kwargs):
        t = time.perf_counter()
        try:
            return run_eval(*args, **kwargs)
        finally:
            timing["s"] = time.perf_counter() - t

    run_cli.run_evaluate = timed
    try:
        one = run_cli.main(["--type", "evaluate", *base, "result_dir",
                            res[1], *J_EVAL_FRAMES])
    finally:
        run_cli.run_evaluate = run_eval
    gaps = {}
    for name in ("mse", "psnr", "ssim"):
        a, b = (np.load(os.path.join(out_dir[n], f"{name}.npy"))
                for n in (1, 2))
        check(a.shape == b.shape == (3,), f"j3 evaluate: {name} {a} vs {b}")
        gaps[name] = float(np.abs(a - b).max())
    check(gaps["psnr"] <= 0.05 and gaps["ssim"] <= 2e-3, f"j3 evaluate: "
          f"2 ranks vs 1 process, largest per-frame gaps {gaps}")
    check(os.path.isfile(os.path.join(out_dir[2], "summary.txt")),
          "j3 evaluate: no summary.txt")
    s2 = max(r["seconds"] for r in reps) / 3
    log(f"[j3 sharded eval] full width, 512x512, 3 frames over 2 ranks "
        f"sharing the card (2 + 1) vs 1 process: per-frame gaps (the .npy "
        f"files in frame order; the synthetic frames are alike) mse "
        f"{gaps['mse']:.3g}, psnr {gaps['psnr']:.3g} dB, ssim "
        f"{gaps['ssim']:.3g}; psnr {one['psnr']:.4f}; eval s per frame "
        f"{s2:.3f} on 2 ranks (the slower rank's loop / 3) vs "
        f"{timing['s'] / 3:.3f} in 1 process; torchrun {secs:.1f} s; "
        f"launches per rank {[r['launches'] for r in reps]}  [{card}]")

    out, reps_v, secs_v = torchrun("j3 visualize", 2, module, [
        "--type", "visualize", *base, "result_dir", res[2]])
    n_frames = sum(r["frames"] for r in reps_v)
    avi = os.path.join(out_dir[2], "perform", "synthetic.avi")
    check(out.count("video: ") == 1 and len(avi_frames(avi)) == n_frames,
          f"j3 visualize: {out.count('video: ')} videos assembled, "
          f"{avi}: {len(avi_frames(avi))} frames of {n_frames}")
    log(f"[j3 sharded visualize] {n_frames} frames over 2 ranks "
        f"({[r['frames'] for r in reps_v]}), one AVI of {n_frames} frames "
        f"assembled by rank 0; torchrun {secs_v:.1f} s  [{card}]")

    vs = f"{RECON_VOXEL},{RECON_VOXEL},{RECON_VOXEL}"
    recon = ["--type", "reconstruction", *base, *J_RECON_FRAMES,
             "voxel_size", vs, "mesh_th", J_MESH_TH]
    out, reps_r, secs_r = torchrun("j3 reconstruction", 2, module, [
        *recon, "result_dir", res[2]])
    check([r["frames"] for r in reps_r] == [1, 1],
          f"j3 reconstruction: frames per rank {reps_r}")
    paths = run_cli.main([*recon, "result_dir", res[1]])
    same = []
    for p1 in paths:
        p2 = os.path.join(out_dir[2], "mesh", os.path.basename(p1))
        (v1, t1), (v2, t2) = load_ply(p1), load_ply(p2)
        check(len(v1) > 0 and v1.shape == v2.shape and np.array_equal(t1, t2)
              and float(np.abs(v1 - v2).max()) <= 1e-6, f"j3 reconstruction: "
              f"{p2} ({len(v2)} verts) is not the 1-process {p1} "
              f"({len(v1)} verts)")
        with open(p1, "rb") as a, open(p2, "rb") as b:
            same.append(a.read() == b.read())
    log(f"[j3 sharded reconstruction] 2 frames at {RECON_VOXEL} m, one per "
        f"rank, mesh_th {J_MESH_TH}: each PLY the 1-process one (byte for "
        f"byte: {same}); torchrun {secs_r:.1f} s; launches per rank "
        f"{[r['launches'] for r in reps_r]}  [{card}]")
    return {"sharded_eval": _summed(reps)}


# ---------------------------------------------------------------- phase k
K_EVAL_FRAMES = ("test.frame_interval", "4")  # frames 0 and 4 of the 8
# one frame and one target view of each protocol: its depth, cut
K_PROTOCOL_CUT = ["test.target_view", "3,", "test.frame_interval", "1000"]
K_MAP_TOL = {"rgb_map": 1e-6, "acc_map": 1e-6, "depth_map": 1e-5}


def phase_ray_render(card: str) -> dict:
    """k1. make_sharded_render over [cuda:0, cuda:1], or [cuda:0, cuda:0]
    on one card, on a full-width 512x512 request against one device's
    render_frame with the same weights: the maps within K_MAP_TOL
    (bit-equal expected), the survivor counts equal, and the launches the
    code predicts, exactly: K1 one a chunk of 512 rays, K2 one a chunk
    with survivors, K4 that plus one painting fetch in each non-empty
    share's prologue (so one more than one device's for each further
    share).  Then the render ms at R = 1 and R = 2, in turns.  Returns the
    sharded render's launches."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.ray_sampling import sample_eval_rays
    from transhuman_tpu_torch.geometry.rays import world_bounds
    from transhuman_tpu_torch.parallel.infer import (make_sharded_render,
                                                     share_bounds)
    from transhuman_tpu_torch.serve import parse_render_request
    from transhuman_tpu_torch.testing import synthetic_setup

    hw = 512
    # two shares on one card measure the wiring (the threads, the replicas,
    # the split and the gather), not the scaling
    devices = [torch.device("cuda", 0),
               torch.device("cuda", min(1, torch.cuda.device_count() - 1))]
    cfg = Config()
    _, pipe, frame, smpl, _ = synthetic_setup(image_hw=(hw, hw),
                                              device=devices[0])
    req, (tK, tR, tT), (h, w) = parse_render_request(
        _request(frame, 0, hw), cfg, smpl)
    rays = sample_eval_rays(None, tK, tR, tT.reshape(3, 1), world_bounds(
        req.verts_world.numpy(), cfg.big_box), hw=(h, w)).rays
    n, cr, r = rays.ray_o.shape[0], pipe.chunk_rays, len(devices)
    dev = devices[0]
    sharded = make_sharded_render(pipe, devices)

    def one():
        return pipe.render_frame(req.to(dev), rays.to(dev))

    runs = {}
    for tag, fn in (("one", one), ("sharded", lambda: sharded(req, rays))):
        fn()  # warm: kernel build, allocator
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        runs[tag] = (out, kernels.launch_counts(),
                     dict(pipe.last_frame_stats))
    (want, c1, s1), (got, c2, s2) = runs["one"], runs["sharded"]
    errs = {k: float((got[k].to(dev) - want[k]).abs().max()) for k in want}
    same = all(torch.equal(got[k].to(dev), want[k]) for k in want)
    check(all(errs[k] <= K_MAP_TOL[k] for k in want), f"k1: sharded maps "
          f"against one device's {errs}, bounds {K_MAP_TOL}")
    check(float(want["acc_map"].max()) > 0.5, "k1: no ray with acc > 0.5")
    check(s1 == s2, f"k1: frame stats {s2} sharded vs {s1}")
    chunks = -(-n // cr)
    shares = sum(b > a for a, b in share_bounds(n, cr, r))
    with_survivors = c1["dparf"]
    predicted = {
        "one": {"min_excess2": chunks, "dparf": with_survivors,
                "feature_gather": with_survivors + 1},
        "sharded": {"min_excess2": chunks, "dparf": with_survivors,
                    "feature_gather": with_survivors + shares}}
    for tag, counts in (("one", c1), ("sharded", c2)):
        want_counts = dict.fromkeys(counts, 0)
        want_counts.update(predicted[tag])
        check(counts == want_counts, f"k1 {tag}: launches {counts}, the "
              f"code predicts {want_counts}")
    ms = {1: [], r: []}
    for tag in (1, r, r, 1, 1, r):
        torch.cuda.synchronize()
        t = time.perf_counter()
        one() if tag == 1 else sharded(req, rays)
        torch.cuda.synchronize()
        ms[tag].append((time.perf_counter() - t) * 1e3)
    layout = ("two shares on one card: this measures the wiring, not the "
              "scaling" if devices[0] == devices[1] else "one share a card")
    log(f"[k1 ray-sharded render] full width, {hw}x{hw}, {n} rays in "
        f"{chunks} chunks of {cr}, over {[str(d) for d in devices]} "
        f"({layout}): maps "
        f"{'bit-equal' if same else 'not bit-equal'} to one device's "
        f"(max |d| {errs}); survivors {s2['survivors']} of {s2['points']} "
        f"both ways; launches one device {c1}, sharded {c2} = K1 "
        f"{chunks} chunks, K2 {with_survivors} chunks with survivors, K4 "
        f"K2 + {shares} prologue fetches (one per share); render ms R=1 "
        f"{[round(x, 1) for x in ms[1]]} (median "
        f"{float(np.median(ms[1])):.1f}), R={r} "
        f"{[round(x, 1) for x in ms[r]]} (median "
        f"{float(np.median(ms[r])):.1f})  [{card}]")
    return c2


def phase_ray_eval(card: str, tmp: str, ckpt: str) -> dict:
    """k2. On two cards or more, the run entry point --type evaluate with
    mesh_axis_rays 2 against mesh_axis_rays 1: the metric files equal.  On
    one card, the entry point's refusal with its counts, then
    evaluate_frames through FrameRenderer(devices=[cuda:0, cuda:0])
    against the unsharded frames: per-frame PSNR and SSIM within 1e-9.
    Full width, 512x512, phase 7's checkpoint, 2 frames.  Returns the
    sharded evaluation's launches."""
    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.cli.common import build_runtime
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data.synthetic import SyntheticDataset
    from transhuman_tpu_torch.evals.evaluator import Evaluator
    from transhuman_tpu_torch.train.checkpoint import read_checkpoint
    from transhuman_tpu_torch.weights import load_reference_state_dict

    run = os.path.join(tmp, "k2")
    base = ["--type", "evaluate", "--device", "cuda", "--weights", ckpt,
            "dataset", "synthetic", *K_EVAL_FRAMES]
    cards = torch.cuda.device_count()
    metrics, counts = {}, {}
    if cards >= 2:
        for r in (1, 2):
            res = os.path.join(run, f"res{r}")
            kernels.reset_launch_counts()
            run_cli.main([*base, "result_dir", res, "mesh_axis_rays",
                          str(r)])
            counts[r] = kernels.launch_counts()
            out_dir = os.path.join(res, "epoch_-1", "debug")
            metrics[r] = {m: np.load(os.path.join(out_dir, f"{m}.npy"))
                          for m in ("mse", "psnr", "ssim")}
        for m in metrics[1]:
            check(np.array_equal(metrics[1][m], metrics[2][m]), f"k2: "
                  f"{m}.npy with mesh_axis_rays 2 {metrics[2][m]} vs 1 "
                  f"{metrics[1][m]}")
        log(f"[k2 ray-sharded evaluate] the run entry point over cuda:0 "
            f"and cuda:1: metric files equal to mesh_axis_rays 1 "
            f"(psnr {metrics[2]['psnr']}); launches {counts[2]}  [{card}]")
        return counts[2]
    try:
        run_cli.main([*base, "result_dir", os.path.join(run, "refused"),
                      "mesh_axis_rays", "2"])
        refused = None
    except SystemExit as e:
        refused = str(e)
    check(refused is not None and "needs cards 0..1, but 1 CUDA card"
          in refused, f"k2: mesh_axis_rays 2 on one card: {refused!r}")
    cfg = Config().merge_opts(list(K_EVAL_FRAMES))
    data = SyntheticDataset(cfg, "test", image_hw=(512, 512))
    ck = read_checkpoint(ckpt, cfg.vit_depth)
    model, pipe, _, _ = build_runtime(cfg, torch.device("cuda"),
                                      smpl=data.smpl,
                                      pe_table=ck["pe_table"])
    load_reference_state_dict(model, ck["net"])
    frames = {}
    for r, devices in ((1, None), (2, ["cuda:0", "cuda:0"])):
        ev = Evaluator(os.path.join(run, f"frames{r}"))
        rcfg = cfg.merge_opts(["mesh_axis_rays", str(r)])
        renderer = run_cli.FrameRenderer(rcfg, pipe, devices)
        got = frames[r] = ([], [])

        def per_frame(item, out, ev=ev, got=got):
            got[0].append(ev.psnr[-1])
            got[1].append(ev.ssim[-1])
            return {}

        kernels.reset_launch_counts()
        run_cli.evaluate_frames(rcfg, pipe, data, ev, per_frame=per_frame,
                                renderer=renderer)
        counts[r] = kernels.launch_counts()
    check(len(frames[1][0]) == len(frames[2][0]) == 2, f"k2: frames "
          f"{frames}")
    gaps = [max(abs(a - b) for a, b in zip(frames[1][i], frames[2][i]))
            for i in (0, 1)]
    check(max(gaps) <= 1e-9, f"k2: per-frame psnr/ssim sharded {frames[2]} "
          f"vs one device {frames[1]}")
    log(f"[k2 ray-sharded evaluate] one card: the entry point refuses "
        f"mesh_axis_rays 2 ({refused}); evaluate_frames over [cuda:0, "
        f"cuda:0] vs one device, 2 frames at 512x512: psnr {frames[2][0]}, "
        f"largest gaps psnr {gaps[0]:.3g}, ssim {gaps[1]:.3g}; launches "
        f"{counts[2]} (one device {counts[1]})  [{card}]")
    return counts[2]


def write_smpl_pickle(model_dir: str):
    """SMPLModel.synthetic() in the official SMPL pickle's layout, as
    SMPL_NEUTRAL.pkl under model_dir: the stand-in for the licensed file."""
    import pickle

    from transhuman_tpu_torch.geometry.smpl import SMPLModel

    smpl = SMPLModel.synthetic()
    kintree = np.zeros((2, smpl.weights.shape[1]), np.int64)
    kintree[1] = np.arange(kintree.shape[1])
    kintree[0, 1:] = smpl.parent
    os.makedirs(model_dir, exist_ok=True)
    with open(os.path.join(model_dir, "SMPL_NEUTRAL.pkl"), "wb") as f:
        pickle.dump({"v_template": smpl.v_template,
                     "shapedirs": smpl.shapedirs, "posedirs": smpl.posedirs,
                     "J_regressor": smpl.J_regressor,
                     "weights": smpl.weights, "kintree_table": kintree,
                     "f": smpl.faces}, f)


def phase_make_kmeans(card: str, tmp: str) -> tuple:
    """k5. tools/make_kmeans on the stand-in SMPL pickle (300 clusters,
    seed 0): its file loads back through ClusterSpec.load_reference_dict
    with the assignment k-means gives here.  Returns (the SMPL directory,
    the kmeans file) for k4."""
    from transhuman_tpu_torch.geometry.clusters import ClusterSpec
    from transhuman_tpu_torch.geometry.smpl import SMPLModel
    from transhuman_tpu_torch.tools import make_kmeans

    smpl_dir = os.path.join(tmp, "k5", "smpl")
    write_smpl_pickle(smpl_dir)
    t = time.perf_counter()
    path = make_kmeans.main(["--smpl_dir", smpl_dir, "--num_clusters", "300",
                             os.path.join(tmp, "k5", "kmeans")])
    secs = time.perf_counter() - t
    spec = ClusterSpec.load_reference_dict(path)
    want = ClusterSpec.from_kmeans(SMPLModel.load(smpl_dir).v_template, 300)
    check(spec.num_clusters == 300 and np.array_equal(
        spec.vert2cluster, want.vert2cluster), f"k5: {path} loads back "
          f"with another assignment")
    log(f"[k5 make_kmeans] {path}: 6890 vertices into 300 clusters in "
        f"{secs:.2f} s (host), loads back with the same assignment  [{card}]")
    return smpl_dir, path


def phase_doctor(card: str, tmp: str, zju_root: str, ckpt: str):
    """k3. tools/doctor on the card over phase g's laid-out CoreView_387
    (run_mode test) with phase 7's checkpoint in its model directory: exit
    code 0, and the card, nvcc, g++ and both build rows PASS."""
    import contextlib

    from transhuman_tpu_torch.tools import doctor

    mdir = os.path.join(tmp, "k3", "model", "transhuman", "transhuman_tpu")
    os.makedirs(mdir)
    try:
        os.link(ckpt, os.path.join(mdir, "latest.pth"))
    except OSError:
        shutil.copyfile(ckpt, os.path.join(mdir, "latest.pth"))
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = doctor.main(["data_root", zju_root, "rasterize_root",
                          os.path.join(zju_root, "raster"), "run_mode", "test",
                          "trained_model_dir", os.path.join(tmp, "k3",
                                                            "model")])
    secs = time.perf_counter() - t
    out = buf.getvalue()
    for line in out.splitlines():
        if line.strip():
            log(f"[k3 doctor] {line}")
    check(rc == 0, f"k3: doctor exit code {rc}")
    for row in ("CUDA card", "nvcc", "g++", "kernel build",
                "host-library build", "checkpoint", "sample frame"):
        check(f"[PASS] {row}" in out, f"k3: doctor's {row} row is not PASS")
    log(f"[k3 doctor] exit 0 in {secs:.2f} s  [{card}]")


def write_official_pth(path: str, vit_depth: int = 12):
    """Random weights under every key of the official checkpoint
    (tools/convert_checkpoint.py::official_key_inventory), as the JAX
    package's runbook test builds its stand-in."""
    from transhuman_tpu_torch.tools.convert_checkpoint import (
        official_key_inventory)

    g = torch.Generator().manual_seed(0)
    sd = {}
    for k, shape in official_key_inventory(vit_depth).items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(2100, dtype=torch.int64)
        elif k.endswith("running_var"):
            sd[k] = torch.rand(shape, generator=g) + 0.5
        else:
            sd[k] = torch.randn(shape, generator=g) * 0.02
    torch.save({"net": sd, "epoch": 2100}, path)


def phase_validate_official(card: str, tmp: str, smpl_dir: str,
                            kmeans: str):
    """k4. tools/validate_official on the card over a laid-out
    CoreView_377 (frames 0 and 300 of 301: the fitting and pose
    protocols') and CoreView_387 (frame 0: identity and one-shot), with a
    stand-in official .pth at full width, k5's SMPL and k-means files, all
    four protocols from configs/train_or_eval.yaml, K_PROTOCOL_CUT's depth:
    exit 0, the report written, and each protocol's PSNR and SSIM those of
    a direct cli.run --type evaluate with the same argv."""
    import argparse

    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.tools import validate_official as vo

    run = os.path.join(tmp, "k4")
    root = os.path.join(run, "zju")
    write_zju_layout(root, "CoreView_377", [0, 300], 301)
    write_zju_layout(root, "CoreView_387", [0], 1, seed=1)
    pth = os.path.join(run, "official.pth")
    write_official_pth(pth)
    work = os.path.join(run, "work")
    labels = [p[0] for p in vo.PROTOCOLS]
    t = time.perf_counter()
    rc = vo.main(["--zju_root", root, "--rasterize_root",
                  os.path.join(root, "raster"), "--official_ckpt", pth,
                  "--smpl_dir", smpl_dir, "--kmeans", kmeans, "--workdir",
                  work, "--cfg_file", os.path.join(CONFIGS,
                                                   "train_or_eval.yaml"),
                  "--protocols", *labels, "--opts", *K_PROTOCOL_CUT])
    secs = time.perf_counter() - t
    check(rc == 0, f"k4: validate_official exit code {rc}")
    with open(os.path.join(work, "parity_report.json")) as f:
        rows = {r["protocol"]: r for r in json.load(f)["results"]}
    check(sorted(rows) == sorted(labels), f"k4: report rows {sorted(rows)}")
    direct = argparse.Namespace(
        device="cuda", official_ckpt=pth, zju_root=root, smpl_dir=smpl_dir,
        rasterize_root=os.path.join(root, "raster"), kmeans=kmeans,
        cfg_file=os.path.join(CONFIGS, "train_or_eval.yaml"),
        task="transhuman", workdir=os.path.join(run, "direct"),
        opts=K_PROTOCOL_CUT)
    lines = []
    for label, mode, views in vo.PROTOCOLS:
        s = run_cli.main(vo.build_argv(direct, label, mode, views, ""))
        row = rows[label]
        check(np.isfinite(row["psnr"]) and np.isfinite(row["ssim"]) and
              abs(s["psnr"] - row["psnr"]) <= 1e-9 and
              abs(s["ssim"] - row["ssim"]) <= 1e-9, f"k4 {label}: report "
              f"{row} vs the direct evaluate {s}")
        lines.append(f"{label} psnr {row['psnr']:.4f} ssim "
                     f"{row['ssim']:.4f}")
    with open(os.path.join(work, "parity_report.txt")) as f:
        check(f.read().startswith("fitting:"), "k4: parity_report.txt")
    log(f"[k4 validate_official] 4 protocols (one frame, one target view "
        f"each) on the card from train_or_eval.yaml (bf16) in {secs:.1f} s, "
        f"each equal to a direct evaluate: {'; '.join(lines)}  [{card}]")

# ---------------------- the model axis: tensor and pipeline parallelism
L_STEPS = 2  # bf16 steps of phase l1's culled tensor-parallel run
# TransHE of phase l1: small (384, 6 heads).  At base (768) the positional
# code of the centroids has embed_dim / 6 = 128 bands, the top one pi *
# 2^127, which overflows float32: the JAX package's embed_vit_pos and the
# reference's table are NaN there alike, and so is every loss of a run
# from them
L_VARIANT = "small"
L_PP = {"views": 3, "tokens": 300, "dim": 768, "heads": 12, "depth": 12,
        "stages": 2, "micro": 3}  # phase l2: TransHE base over 2 stages
L_PP_ITERS = 5  # timed passes of l2, each way
L_PP_ATOL, L_PP_GRAD_ATOL = 1e-5, 2e-6  # tests/test_torch_pp.py's bounds


def check_dparf_width(card: str, dim: int) -> dict:
    """K2 and its bf16 form at token width ``dim`` (TransHE base's 768)
    on phase 3's points, centres and rotations: the float32 form against
    its plain twin at phase 3's tolerances off near-ties, the bf16 form the
    float32 form's bits on the widened tokens and within one unit of bf16's
    last place of its plain twin; each timed beside its bound."""
    from transhuman_tpu_torch.kernels import dparf
    from transhuman_tpu_torch.tools.kernel_ab import phase3_inputs

    dev = torch.device("cuda")
    pts, _, centers, rot, _ = phase3_inputs(dev, N_CHUNK)
    g = torch.Generator(device=dev).manual_seed(768)
    tokens = torch.randn((3, centers.shape[0], dim), generator=g, device=dev)
    k = 7
    got = dparf.dparf_cuda(pts, centers, rot, tokens, k)
    plain = dparf.dparf_plain(pts, centers, rot, tokens, k)
    torch.cuda.synchronize()
    ok = ~knn_near_ties(pts, centers, k)
    tok_err = float((got[0] - plain[0])[:, ok].abs().max())
    pe_err = float((got[1] - plain[1])[ok].abs().max())
    w_err = float((got[4] - plain[4])[ok].abs().max())
    check(tok_err <= 1e-4 and pe_err <= 5e-4 and w_err <= 1e-5,
          f"K2 at D={dim}: tok err {tok_err}, pe err {pe_err}, w err {w_err}")
    check(bool((got[3].long() == plain[3])[ok].all()),
          f"K2 at D={dim}: the neighbour indices differ off ties")
    tok16 = tokens.to(torch.bfloat16)
    got16 = dparf.dparf_bf16_cuda(pts, centers, rot, tok16, k)
    want16 = dparf.dparf_cuda(pts, centers, rot, tok16.float(), k)
    plain16 = dparf.dparf_plain(pts, centers, rot, tok16, k)
    torch.cuda.synchronize()
    check(torch.equal(got16[0], want16[0].to(torch.bfloat16))
          and all(torch.equal(a, b) for a, b in zip(got16[1:], want16[1:])),
          f"K2 bf16 at D={dim}: not the float32 form's bits")
    scale = float(plain16[0].float().abs().max())
    err16 = float((got16[0].float() - plain16[0].float())[:, ok].abs().max())
    check(err16 <= 2.0**-7 * scale, f"K2 bf16 at D={dim}: tok err {err16} "
          f"vs its plain twin (max |tok| {scale})")
    ops = (8 * pts.shape[0] * centers.shape[0]
           + 2 * k * tokens.numel() // centers.shape[0] * pts.shape[0])
    out = {}
    for name, fn, pl, ins, res in (
            ("f32", dparf.dparf_cuda, dparf.dparf_plain, tokens, got),
            ("bf16", dparf.dparf_bf16_cuda, dparf.dparf_plain, tok16,
             got16)):
        out[name] = {
            "dim": dim, "ms": time_ms(lambda: fn(pts, centers, rot, ins, k)),
            "plain_ms": time_ms(lambda: pl(pts, centers, rot, ins, k),
                                iters=5),
            "max_abs_err": tok_err if name == "f32" else err16,
            **bound(nbytes(pts, centers, rot, ins, *res), ops)}
    log(f"[l0 K2 at D={dim}] {pts.shape[0]} pts, C=300, V=3, k={k}: f32 tok "
        f"err {tok_err:.3g}, pe err {pe_err:.3g}, w err {w_err:.3g}, kernel "
        f"{out['f32']['ms']:.4f} ms, plain {out['f32']['plain_ms']:.4f} ms, "
        f"bound {out['f32']['bound_ms']:.4f} ms ({out['f32']['bound_by']}); "
        f"bf16 the float32 form's bits, err vs plain {err16:.3g} of "
        f"{scale:.3g}, kernel {out['bf16']['ms']:.4f} ms, plain "
        f"{out['bf16']['plain_ms']:.4f} ms, bound "
        f"{out['bf16']['bound_ms']:.4f} ms  [{card}]")
    return out


def _vit_shard_bytes(net, n_model: int) -> dict:
    """What each of n_model ranks should hold of TransHE: its parameter
    bytes, with the sharded leaves cut n_model ways, and their names."""
    from transhuman_tpu_torch.parallel import tp

    specs = tp.tp_param_specs(dict(net.ViT.named_parameters()), n_model,
                              net.ViT.num_heads)
    total = sum(p.numel() * 4 // (n_model if specs[n] else 1)
                for n, p in net.ViT.named_parameters())
    return {"bytes": total, "sharded": sorted(n for n in specs if specs[n])}


def _shard_digests(path: str, cfg, n_model: int) -> list:
    """Each model rank's TransHE digest of the whole file at path, cut as
    that rank holds it (tp.vit_digest of a one-process net sharded in this
    process)."""
    from transhuman_tpu_torch import weights
    from transhuman_tpu_torch.models.network import TransHumanNet
    from transhuman_tpu_torch.parallel import tp
    from transhuman_tpu_torch.parallel.mesh import Axis

    out = []
    for m in range(n_model):
        net = TransHumanNet.from_config(cfg)
        weights.load_checkpoint_file(net, path)
        tp.shard_model_(net, Axis("model", m, n_model))
        out.append(tp.vit_digest(net))
    return out


def phase_tp_train(card: str, tmp: str) -> dict:
    """l1. The train entry point over 2 ranks sharing the card (torchrun,
    gloo) at mesh_axis_model 2, TransHE small (embed 384, 6 heads, depth
    12; base's positional code is NaN at embed 768 in both packages, see
    L_VARIANT), one sample (6 x 20 x 20 patches, 64 samples a ray): one
    float32 step against this process's one-process step on the same seeded
    weights and sample (phase 6's bounds, the gradients from each
    checkpoint's Adam moment), each rank's TransHE shards the saved file's
    cut (digests); then L_STEPS bf16 steps with train.cull, each rank
    reporting its TransHE parameter and moment bytes (the sharded leaves
    at half), step ms, the model axis's all-reduce count and ms a step and
    its K1, K2, K4 and K3 launches; the final --out file loaded into one
    process holds the ranks' shards.  Returns {path: summed launches}."""
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.models.network import TransHumanNet
    from transhuman_tpu_torch.testing import init_weights

    module = "transhuman_tpu_torch.cli.train"
    run = os.path.join(tmp, "l1")
    base = ("vit_variant", L_VARIANT, "train.batch_size", "1")

    def opts(tag, steps, *extra):
        return ["--device", "cuda", "--steps", str(steps), "dataset",
                "synthetic", "ep_iter", str(steps), "train.epoch", "1",
                "trained_model_dir", os.path.join(run, tag, "tm"),
                "record_dir", os.path.join(run, tag, "rec"), "result_dir",
                os.path.join(run, tag, "res"), *base, *extra]

    tp_ckpt, one_ckpt = (os.path.join(run, f"{t}.pth") for t in ("tp",
                                                                 "one"))
    torch.cuda.empty_cache()
    _, reps, secs = torchrun("l1 float32", 2, module, [
        "--out", tp_ckpt, *opts("tp", 1, "mesh_axis_model", "2")])
    _, recs = train_cli.main(["--out", one_ckpt, *opts("one", 1)])
    torch.cuda.empty_cache()
    cfg = Config().merge_opts(["dataset", "synthetic", *base])
    net = init_weights(TransHumanNet.from_config(cfg),
                       torch.Generator().manual_seed(cfg.seed))
    p0 = {n: p.detach().clone() for n, p in net.named_parameters()}
    (w_tp, m_tp), (w_one, m_one) = map(_adam_step, (tp_ckpt, one_ckpt))
    names = list(p0)
    g_tp = {names[i]: g for i, g in m_tp.items()}
    g_one = {names[i]: g for i, g in m_one.items()}
    # the TP run's reduction gives the unread mask_token a zero gradient
    check(set(g_one) == set(names) - UNREAD_PARAMS and set(g_one) <= set(
        g_tp), "l1: the parameters with a gradient differ")
    check(reps[0]["loss"] == reps[1]["loss"], f"l1: the model ranks' losses "
          f"differ {[r['loss'] for r in reps]}")
    check(reps[0]["replicated_digest"] == reps[1]["replicated_digest"],
          "l1: the model ranks' replicated parameters differ after a step")
    loss_tp, loss_one = reps[0]["loss"][0], recs[0]["loss"]
    lerr = abs(loss_tp - loss_one) / loss_one
    check(lerr <= 1e-4, f"l1: loss {loss_tp} over 2 model ranks vs "
          f"{loss_one}")
    rel, gerr, wt, w = f32_step_gaps(
        "l1 TP step vs 1 process", g_tp, g_one,
        {n: w_tp[n] - p0[n] for n in g_one},
        {n: w_one[n] - p0[n] for n in g_one}, p0, recs[0]["lr"])
    want = _vit_shard_bytes(net, 2)
    digests = _shard_digests(tp_ckpt, cfg, 2)
    for r in reps:
        check(r["vit_param_bytes"] == want["bytes"], f"l1 rank {r['rank']}: "
              f"TransHE holds {r['vit_param_bytes']} B, want {want['bytes']}")
        check(r["vit_digest"] == digests[r["model_rank"]], f"l1 rank "
              f"{r['rank']}: its TransHE shards are not the saved file's cut")
        check(r["model_allreduce_count"] == [4 * cfg.vit_depth],
              f"l1 rank {r['rank']}: {r['model_allreduce_count']} model "
              f"all-reduces, want 4 x depth {cfg.vit_depth}")
    whole = sum(p.numel() * 4 for p in net.ViT.parameters())
    log(f"[l1 tp train] TransHE {L_VARIANT} (embed {net.embed_dim}, "
        f"{net.ViT.num_heads} heads, depth {cfg.vit_depth}), float32, "
        f"2 model ranks sharing the card (gloo) vs 1 process, one sample: "
        f"loss {loss_tp:.7g} vs {loss_one:.7g} (rel {lerr:.3g}); max "
        f"gradient err {gerr:.3g} of its leaf's norm; worst error/tolerance "
        f"{rel[0][0]:.3g} ({rel[0][1]}); update err beyond rounding "
        f"{wt:.3g} where the sign is sure, {w:.3g} anywhere; TransHE bytes "
        f"a rank {reps[0]['vit_param_bytes']} of {whole} "
        f"({len(want['sharded'])} leaves at half), moments {reps[0]['vit_moment_bytes']}; step ms "
        f"{[round(r['step_ms'][0], 1) for r in reps]}; model all-reduces "
        f"{reps[0]['model_allreduce_count'][0]} in "
        f"{[round(r['model_allreduce_ms'][0], 2) for r in reps]} ms; the "
        f"replicated parameters bit-equal on both ranks; torchrun "
        f"{secs:.1f} s  [{card}]")

    f = forms("bfloat16")
    tp16 = os.path.join(run, "tp16.pth")
    _, reps16, secs16 = torchrun("l1 bf16", 2, module, [
        "--out", tp16, *opts("bf16", L_STEPS, "mesh_axis_model", "2",
                             "compute_dtype", "bfloat16", "train.cull",
                             "True")])
    cfg16 = cfg.merge_opts(["compute_dtype", "bfloat16"])
    digests = _shard_digests(tp16, cfg16, 2)
    for r in reps16:
        what = f"l1 bf16 rank {r['rank']}"
        check(len(r["loss"]) == L_STEPS and np.isfinite(r["loss"]).all(),
              f"{what}: losses {r['loss']}")
        check_launches(what, r["launches"], {
            "min_excess2": L_STEPS, f["dparf"]: L_STEPS,
            f["fetch"]: 2 * L_STEPS, f["scatter"]: 2 * L_STEPS})
        check(r["launches"]["min_excess2"] == L_STEPS and r["launches"][
            f["dparf"]] == L_STEPS, f"{what}: launches {r['launches']}")
        check(r["model_allreduce_count"] == [4 * cfg.vit_depth] * L_STEPS,
              f"{what}: model all-reduces {r['model_allreduce_count']}")
        check(r["vit_param_bytes"] == want["bytes"]
              and r["vit_moment_bytes"] == 2 * want["bytes"],
              f"{what}: TransHE {r['vit_param_bytes']} B, moments "
              f"{r['vit_moment_bytes']} B")
        check(r["vit_digest"] == digests[r["model_rank"]],
              f"{what}: its shards are not the saved file's cut")
    check(reps16[0]["loss"] == reps16[1]["loss"], "l1 bf16: the ranks' "
          "losses differ")
    check(reps16[0]["replicated_digest"] == reps16[1]["replicated_digest"],
          f"l1 bf16: the model ranks' replicated parameters differ after "
          f"{L_STEPS} steps")

    def per_rank(key, nd):
        return "; ".join(f"rank {r['rank']} "
                         + ", ".join(f"{x:.{nd}f}" for x in r[key])
                         for r in reps16)

    log(f"[l1 tp train bf16] TransHE {L_VARIANT}, bf16, train.cull, 2 "
        f"model ranks sharing the card (gloo), {L_STEPS} steps in "
        f"{secs16:.1f} s of "
        f"torchrun: step ms {per_rank('step_ms', 1)}; the gradient "
        f"all-reduces (replicated leaves over both ranks) ms "
        f"{per_rank('grad_allreduce_ms', 2)} of "
        f"{reps16[0]['grad_allreduce_mb']:.2f} MB; model all-reduces "
        f"{reps16[0]['model_allreduce_count']} a step in ms "
        f"{per_rank('model_allreduce_ms', 2)}; TransHE {want['bytes']} B a "
        f"rank of {whole}, moments {reps16[0]['vit_moment_bytes']} B; "
        f"launches per rank {[r['launches'] for r in reps16]}; the saved "
        f"file's cut equals each rank's shards, the replicated parameters "
        f"bit-equal on both ranks  [{card}]")
    return {"tp_train_bf16": _summed(reps16)}


def pp_model(dev):
    """Phase l2's seeded TransHE base, its tokens, a stored (V, C, 768)
    positional table in [-1, 1] (centroids would embed to NaN at 768, see
    L_VARIANT) and its target, on dev: every matrix N(0, 1/fan_in), norms
    1, biases N(0, 0.02^2)."""
    from transhuman_tpu_torch.models.vit import TransHE

    c = L_PP
    g = torch.Generator().manual_seed(14)
    net = TransHE(c["dim"], c["depth"], c["heads"])
    with torch.no_grad():
        for name, p in net.named_parameters():
            if p.dim() > 1:
                p.copy_(torch.randn(p.shape, generator=g) / p.shape[-1]**0.5)
            elif "norm" in name and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
    shape = (c["views"], c["tokens"], c["dim"])
    tok = torch.randn(shape, generator=g)
    pe = torch.rand(shape, generator=g) * 2 - 1
    tgt = torch.randn(shape, generator=g)
    return net.to(dev), tok.to(dev), pe.to(dev), tgt.to(dev)


def _timed_passes(fn, iters: int = L_PP_ITERS) -> list:
    """ms of each of iters calls of fn, each between two synchronises."""
    out = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def pp_worker(out_dir: str):
    """One rank of phase l2 (``chip_smoke.py --pp-worker DIR`` under
    torchrun): the pipelined TransHE on cuda:0 over a gloo ('pipe',)
    mesh, its output and this stage's gradients saved to DIR, its forward
    and forward + backward ms."""
    from transhuman_tpu_torch.cli.common import rank_report
    from transhuman_tpu_torch.parallel import (init_distributed, make_mesh,
                                               make_pp_mesh, pp, shutdown)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_device()
    init_distributed("gloo")
    try:
        mesh = make_pp_mesh(L_PP["stages"])
        net, tok, pe, tgt = pp_model(dev)
        apply = pp.make_pp_vit_apply(net, mesh, L_PP["micro"])
        params = pp.shard_pp_params(mesh, pp.stack_block_params(
            net.state_dict(), L_PP["stages"]))
        leaves = [*params["stages"].values(), params["mask_token"],
                  *params["norm"].values()]
        for t in leaves:
            t.requires_grad_()

        def step():
            for t in leaves:
                t.grad = None
            y = apply(params, tok, pe)
            ((y - tgt) ** 2).mean().backward()
            return y

        y = step().detach()
        grads = pp.unstack_block_params(
            {"stages": {k: v.grad for k, v in params["stages"].items()},
             "mask_token": params["mask_token"].grad,
             "norm": {k: v.grad for k, v in params["norm"].items()}},
            mesh["pipe"].rank)
        with torch.no_grad():
            fwd = _timed_passes(lambda: apply(params, tok, pe))
        both = _timed_passes(step)
        rank = mesh["pipe"].rank
        torch.save({"y": y.cpu(), "grads": {k: (v.cpu() if v is not None
                                                else None)
                                            for k, v in grads.items()}},
                   os.path.join(out_dir, f"pp_{rank}.pt"))
        rank_report(make_mesh(), forward_ms=fwd, step_ms=both)
    finally:
        shutdown()


def phase_pp(card: str, tmp: str) -> dict:
    """l2. The pipelined TransHE on the card: 2 gloo ranks on cuda:0
    (``chip_smoke.py --pp-worker`` under torchrun), TransHE base (3 views x
    300 tokens x 768, 12 heads, depth 12) over 2 stages in 3 microbatches,
    against the unpipelined module in this process on the same seeded
    weights: every rank's output within 1e-5, each block's gradient from
    its stage and mask_token's and norm's from each rank within 2e-6 (the
    CPU tests' bounds); the forward and forward + backward ms of both."""
    out_dir = os.path.join(tmp, "l2")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.empty_cache()
    _, reps, secs = torchrun("l2 pp", 2, os.path.join(ROOT, "chip_smoke.py"),
                             ["--pp-worker", out_dir])
    net, tok, pe, tgt = pp_model(torch.device("cuda"))

    def step():
        net.zero_grad(set_to_none=True)
        y = net(tok, pe)
        ((y - tgt) ** 2).mean().backward()
        return y

    y_ref = step().detach()
    g_ref = {n: p.grad for n, p in net.named_parameters()}
    with torch.no_grad():
        fwd = _timed_passes(lambda: net(tok, pe))
    both = _timed_passes(step)
    per = L_PP["depth"] // L_PP["stages"]
    y_err = g_err = 0.0
    seen = set()
    for r in range(L_PP["stages"]):
        got = torch.load(os.path.join(out_dir, f"pp_{r}.pt"),
                         weights_only=False)
        y_err = max(y_err, float((got["y"] - y_ref.cpu()).abs().max()))
        for k, v in got["grads"].items():
            if k.startswith("blocks."):
                check(int(k.split(".")[1]) // per == r, f"l2: rank {r} holds "
                      f"the gradient of {k}")
                seen.add(k)
            want = g_ref[k].cpu() if g_ref[k] is not None else None
            if want is None:
                check(v is None or not v.any(), f"l2: {k} has a gradient")
                continue
            g_err = max(g_err, float((v - want).abs().max()))
    check(seen == {k for k in g_ref if k.startswith("blocks.")},
          "l2: the stages' gradients do not cover every block")
    check(y_err <= L_PP_ATOL and g_err <= L_PP_GRAD_ATOL,
          f"l2: pipelined vs unpipelined output err {y_err} (bound "
          f"{L_PP_ATOL}), gradient err {g_err} (bound {L_PP_GRAD_ATOL})")

    def ms(xs):
        return ", ".join(f"{x:.2f}" for x in xs)

    log(f"[l2 pp] TransHE base (3 x 300 x 768, 12 heads, depth 12), "
        f"float32, 2 stages x 3 microbatches on 2 gloo ranks sharing the "
        f"card vs the unpipelined module: output err {y_err:.3g}, gradient "
        f"err {g_err:.3g}; pipelined forward ms "
        + "; ".join(f"rank {r['rank']} {ms(r['forward_ms'])}" for r in reps)
        + ", forward + backward ms "
        + "; ".join(f"rank {r['rank']} {ms(r['step_ms'])}" for r in reps)
        + f"; unpipelined forward ms {ms(fwd)}, forward + backward ms "
        f"{ms(both)}; torchrun {secs:.1f} s  [{card}]")
    return {"pp": {"forward_ms": [r["forward_ms"] for r in reps],
                   "step_ms": [r["step_ms"] for r in reps],
                   "plain_forward_ms": fwd, "plain_step_ms": both}}


# ------------------------------------------ frame formats, torchrun rays
FORMATS = os.path.join(os.path.dirname(FIXTURES), "torch_zju_formats")
N_STEPS = 2  # float32 steps of each phase n1 train run


def format_frames(src_dir: str) -> dict:
    """The committed 1024x1024 q95 4:2:0 fixture JPEG's decode written here
    as a 24-bit BMP, a binary PPM, a 24-bit Sun raster, a Deflate TIFF with
    the horizontal predictor in 8-row strips, an interlaced GIF on the
    6x6x6 colour cube, a run-length Radiance HDR, a lossless WebP
    (subtract-green and predictor transforms), a CMYK TIFF, a CIELab TIFF
    and a BigTIFF (Deflate, 8-row strips) (tests/_torch_formats.py's
    writers),
    beside the committed q90 lossy WebP, lossless (5/3) and lossy (9/7) JP2
    and YCbCr 4:2:0 JPEG-TIFF files of the same decode (no writer here
    codes VP8, JPEG 2000 or JPEG): kind -> path, each checked to read back
    as the decode (the GIF as its palette's colours, the HDR within 2, the
    lossy WebP and JP2 within 9, the JPEG-TIFF within 12, the CIELab TIFF
    within 40, their bytes held to cv2's in phase e)."""
    import importlib.util

    from transhuman_tpu_torch.data import image_io

    # by its path: another installed package may be named tests
    spec = importlib.util.spec_from_file_location(
        "_torch_formats", os.path.join(ROOT, "tests", "_torch_formats.py"))
    tf = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tf)

    rgb = image_io.imread_rgb(os.path.join(FIXTURES, "cv2_q95_420.jpg"))
    os.makedirs(src_dir, exist_ok=True)
    idx, pal = tf._quantize(rgb)
    files = {"bmp": ("frame.bmp", tf.bmp(rgb, 24)),
             "ppm": ("frame.ppm", tf.pnm_binary(rgb, "P6")),
             "sun": ("frame.ras", tf.sun_raster(rgb, 24)),
             "tiff": ("frame.tif", tf.tiff(rgb, compression=8, predictor=2,
                                           rows_per_strip=8)),
             "gif": ("frame.gif", tf.gif([{"idx": idx, "interlace": True}],
                                         palette=pal)),
             "hdr": ("frame.hdr", tf.hdr(rgb / 255.0)),
             "webp_lossless": ("frame.webp", tf.vp8l(rgb)),
             "tiff_cmyk": ("cmyk.tif", tf.encode_frame(rgb, "tiff_cmyk")),
             "tiff_cielab": ("cielab.tif", tf.encode_frame(rgb,
                                                          "tiff_cielab")),
             "bigtiff": ("big.tif", tf.encode_frame(rgb,
                                                    "bigtiff_deflate"))}
    out = {}
    for kind, (name, data) in files.items():
        out[kind] = os.path.join(src_dir, name)
        with open(out[kind], "wb") as fh:
            fh.write(data)
    out["webp_lossy"] = os.path.join(FORMATS, "cv2_q90_1024.webp")
    out["jp2_lossless"] = os.path.join(FORMATS, "cv2_lossless_1024.jp2")
    out["jp2_lossy"] = os.path.join(FORMATS, "cv2_lossy_1024.jp2")
    out["tiff_jpeg"] = os.path.join(FORMATS, "cv2_jpeg_420_1024.tif")
    # what each reads back as, and within what (CIELab through libtiff's
    # display conversion, which quantises the darkest levels coarsely)
    want = {"gif": (pal.astype(np.uint8)[idx], 0), "hdr": (rgb, 2),
            "webp_lossy": (rgb, 9), "jp2_lossy": (rgb, 9),
            "tiff_jpeg": (rgb, 12), "tiff_cielab": (rgb, 40)}
    for kind, path in out.items():
        ref, tol = want.get(kind, (rgb, 0))
        got = image_io.imread_rgb(path)
        err = int(np.abs(got.astype(np.int32) - ref).max())
        check(got.shape == rgb.shape and err <= tol,
              f"formats: the {kind} frame reads back {err} from its source "
              f"(bound {tol})")
    return out


def phase_formats(card: str, tmp: str) -> dict:
    """n. Frames of the formats cv2.imread reads beside JPEG and PNG, and
    mesh_axis_rays under torchrun, through the entry points:
    n1. CoreView_377 laid out at 1024x1024 with every view a lossless
    (5/3) JP2 (format_frames), the train entry point (train_or_eval.yaml,
    float32) for 2 steps under torchrun (1 rank) with mesh_axis_rays 2,
    against the same in this process at mesh_axis_rays 1 (phase 6's loss
    bound: card steps are not bit-reproducible), K2 / K4 / K3 launched
    1 / 2 / 2 a step; then --type evaluate on its checkpoint over the two
    frames of CoreView_387, whose input and target views take the thirteen
    other codings, each frame's under one name (cv2 decodes by content):
    frame 0 BMP, PPM, Sun raster, TIFF, GIF, Radiance HDR, lossless and
    lossy WebP, lossy (9/7) JP2; frame 1 YCbCr 4:2:0 JPEG-TIFF, CMYK and
    CIELab TIFFs and BigTIFF: finite PSNR and SSIM, K1, K2 and K4
    launched, each of the fourteen codings read by the loader (told apart
    by the file's digest); then the host
    split of one train sample of the JP2 tree (host_split, phase f's
    samples), beside phase f's of the JPEG tree;
    n2. examples/torch_minimal_render.py and torch_minimal_train.py (2
    steps) on the card: exit 0, a PNG of the stated size, finite losses.
    The torchrun command and the two examples run beside this process's
    R = 1 run (none of their times is compared)."""
    import hashlib
    import threading

    from transhuman_tpu_torch import kernels
    from transhuman_tpu_torch.cli import run as run_cli
    from transhuman_tpu_torch.cli import train as train_cli
    from transhuman_tpu_torch.config import Config
    from transhuman_tpu_torch.data import image_io, zju
    from transhuman_tpu_torch.geometry.smpl import SMPLModel

    t0 = time.perf_counter()
    src = format_frames(os.path.join(tmp, "formats_src"))
    root = os.path.join(tmp, "zju_formats")
    # training reads lossless JP2 views only; the two evaluated frames'
    # nine views each (3 inputs, 6 targets) the thirteen other codings:
    # frame 0 nine of them, frame 1 the TIFF codings of libtiff's other
    # colour spaces and BigTIFF, cycling
    kinds = (("bmp", "ppm", "sun", "tiff", "gif", "hdr", "webp_lossless",
              "webp_lossy", "jp2_lossy"),
             ("tiff_jpeg", "tiff_cmyk", "tiff_cielab", "bigtiff"))
    cfg_file = os.path.join(CONFIGS, "train_or_eval.yaml")
    # each evaluated frame reads its input and target cameras: each of its
    # codings on one of them, the others' views cycling; write_zju_layout
    # gives frame k camera c the view (k + c) of its list
    test = Config.from_yaml(cfg_file).test
    sources = []
    for k, ks in enumerate(kinds):
        views = [src[ks[c % len(ks)]] for c in range(ZJU_CAMS)]
        for i, c in enumerate([*test.input_view, *test.target_view]):
            views[c] = src[ks[i % len(ks)]]
        sources.append([views[(j - k) % ZJU_CAMS] for j in range(ZJU_CAMS)])
    write_zju_layout(root, "CoreView_377", range(0, 300, 30), 300, seed=4,
                     sources=[[src["jp2_lossless"]]])
    write_zju_layout(root, "CoreView_387", range(ZJU_EVAL_FRAMES),
                     ZJU_EVAL_FRAMES, seed=5, sources=sources)
    kinds = kinds[0] + kinds[1]
    layout_s = time.perf_counter() - t0

    def argv(run, rays):
        return ["--cfg_file", cfg_file, "dataset",
                "zju", "data_root", root, "rasterize_root",
                os.path.join(root, "raster"), "trained_model_dir",
                os.path.join(run, "tm"), "record_dir",
                os.path.join(run, "rec"), "result_dir",
                os.path.join(run, "res"), "ep_iter", str(N_STEPS),
                "train.epoch", "1", "compute_dtype", "float32",
                "mesh_axis_rays", str(rays)]

    f = forms("float32")
    by_path = {}
    runs = {r: os.path.join(tmp, f"formats_rays{r}") for r in (1, 2)}
    # the torchrun command and the examples (n2) run beside this process's
    # R = 1 run: three processes on the card, none timed against another
    png = os.path.join(tmp, "example.png")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    examples = {name: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", name), *args],
        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, args in (("torch_minimal_render.py", [png]),
                                      ("torch_minimal_train.py", ["2"]))}
    rays2 = {}

    def run_rays2():
        try:
            rays2["out"] = torchrun(
                "n1 train rays 2", 1, "transhuman_tpu_torch.cli.train",
                ["--device", "cuda", "--steps", str(N_STEPS),
                 *argv(runs[2], 2)])
        except BaseException as e:  # raised again below, in this thread
            rays2["error"] = e

    rays2_thread = threading.Thread(target=run_rays2)
    rays2_thread.start()

    seen, lock = {}, threading.Lock()
    read_frame = zju.imread_rgb
    coding = {}
    for kind, path in src.items():
        with open(path, "rb") as fh:
            coding[hashlib.sha256(fh.read()).digest()] = kind

    def frame(path):
        out = read_frame(path)
        with open(path, "rb") as fh:
            kind = coding.get(hashlib.sha256(fh.read()).digest(), "other")
        with lock:
            seen[kind] = seen.get(kind, 0) + 1
        return out

    zju.imread_rgb = frame
    try:
        t = time.perf_counter()
        _, recs = train_cli.main(["--device", "cuda", "--steps",
                                  str(N_STEPS), *argv(runs[1], 1)])
        torch.cuda.synchronize()
        one_s = time.perf_counter() - t
        train_seen = dict(seen)
        seen.clear()
        rays2_thread.join()
        if "error" in rays2:
            raise rays2["error"]
        _, reps, tr_s = rays2["out"]
        by_path["train_formats_rays2"] = reps[0]["launches"]
        # one binding and two fetches (painting, pixels) a step, and their
        # two backward scatters: exactly
        want = {f["dparf"]: N_STEPS, f["fetch"]: 2 * N_STEPS,
                f["scatter"]: 2 * N_STEPS}
        check_launches("n1 train rays 2", reps[0]["launches"], want)
        check(all(reps[0]["launches"][k] == n for k, n in want.items()),
              f"n1 train rays 2: launches {reps[0]['launches']}, want "
              f"{want}")
        # evaluate the torchrun run's checkpoint
        t = time.perf_counter()
        kernels.reset_launch_counts()
        summary = run_cli.main(["--type", "evaluate", "--device", "cuda",
                                *argv(runs[2], 1), "test.frame_interval",
                                "1"])
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t
        by_path["eval_formats"] = kernels.launch_counts()
    finally:
        zju.imread_rgb = read_frame
        rays2_thread.join()
        ex = {}
        for name, proc in examples.items():
            try:
                out = proc.communicate(timeout=J_TIMEOUT)[0]
            except subprocess.TimeoutExpired:
                proc.kill()
                out = proc.communicate()[0] + "\n(timed out)"
            ex[name] = (proc.returncode, out)
    loss2, loss1 = reps[0]["loss"], [r["loss"] for r in recs]
    check(len(loss2) == len(loss1) == N_STEPS
          and all(np.isfinite(loss2)) and all(
              abs(a - b) <= 1e-4 * abs(b) for a, b in zip(loss2, loss1)),
          f"n1: losses {loss2} at mesh_axis_rays 2 under torchrun vs "
          f"{loss1} at 1")
    check(np.isfinite(summary["psnr"]) and np.isfinite(summary["ssim"]),
          f"n1 evaluate: {summary}")
    check_launches("n1 evaluate", by_path["eval_formats"],
                   {"min_excess2": 1, f["dparf"]: 1, f["fetch"]: 1})
    # the frames' geometry (cameras, masks) sets these counts and their
    # views' codings do not: this layout's two frames', within 10%
    want = {"min_excess2": 1750, f["dparf"]: 1672, f["fetch"]: 1684}
    check(all(abs(by_path["eval_formats"][k] - n) <= 0.1 * n
              for k, n in want.items()),
          f"n1 evaluate: launches {by_path['eval_formats']}, want within "
          f"10% of {want}")
    # training reads 4 lossless JP2 views a sample; the evaluated frames'
    # targets and inputs the thirteen other codings: all fourteen on the
    # path
    check(set(train_seen) == {"jp2_lossless"}
          and train_seen["jp2_lossless"] >= 4 * N_STEPS
          and set(seen) == set(kinds),
          f"n1: the loader read {train_seen} in training, {seen} in the "
          f"evaluation, want only jp2_lossless, then each of {kinds}")
    # one train sample's host ms by stage on the JP2 tree, with nothing
    # else running, phase f's samples (the same cameras)
    jp2_data = zju.ZJUDataset(Config.from_yaml(cfg_file, [
        "data_root", root, "rasterize_root", os.path.join(root, "raster")]),
        "train", smpl=SMPLModel.synthetic())
    split = [host_split(jp2_data, i) for i in HOST_SPLIT_SAMPLES]
    med = {k: float(np.median([s[k] for s in split])) for k in split[0]}
    total = sum(med.values())
    jpeg = HOST_SPLITS.get("jpeg")
    vs = "" if jpeg is None else (
        f"; phase f's JPEG sample: decode {jpeg['decode']:.1f}, sum "
        f"{sum(jpeg.values()):.1f} (x{total / sum(jpeg.values()):.2f})")
    log(f"[n1 host split] one ZJU train sample of lossless JP2 views (4 "
        f"views of 1024x1024 to 512x512, jitter on), host ms by stage "
        f"(median of {len(split)} samples): "
        + ", ".join(f"{k} {v:.1f}" for k, v in med.items())
        + f"; sum {total:.1f}{vs}  [{card}]")

    # n2: the examples on the card
    for name, (rc, out) in ex.items():
        check(rc == 0, f"n2 {name}: exited {rc}:\n{out[-3000:]}")
    img = image_io.read_png(png)
    check(img.shape == (32, 32, 3), f"n2 render: a PNG of {img.shape}")
    losses = [float(v) for v in re.findall(r"  loss: (\S+)",
                                           ex["torch_minimal_train.py"][1])]
    check(len(losses) == 2 and all(np.isfinite(losses)),
          f"n2 train: losses {losses}")
    log(f"[n1 formats] train_or_eval.yaml (float32) on 1024x1024 lossless "
        f"JP2 frames: {N_STEPS} steps under torchrun at "
        f"mesh_axis_rays 2, losses {', '.join(f'{v:.6f}' for v in loss2)}, "
        f"step ms {', '.join(f'{v:.1f}' for v in reps[0]['step_ms'])}; at "
        f"mesh_axis_rays 1 here {', '.join(f'{v:.6f}' for v in loss1)}, "
        f"sample_s (host ms per sample in a loader thread, beside the "
        f"torchrun run and the examples) "
        f"{', '.join(f'{r['sample_s'] * 1e3:.1f}' for r in recs)}; "
        f"launches {by_path['train_formats_rays2']}; files read "
        f"{train_seen}; --type evaluate, a frame of BMP, PPM, Sun raster, "
        f"TIFF, GIF, Radiance HDR, lossless and lossy WebP and lossy JP2 "
        f"views and one of JPEG-TIFF, CMYK, CIELab and BigTIFF views: psnr "
        f"{summary['psnr']:.3f}, ssim {summary['ssim']:.4f}, files read "
        f"{seen}, launches {by_path['eval_formats']}; layout {layout_s:.1f} "
        f"s, torchrun {tr_s:.1f} s, train here {one_s:.1f} s, evaluate "
        f"{eval_s:.1f} s  [{card}]")
    wrote = re.search(r"^wrote .*$", ex["torch_minimal_render.py"][1], re.M)
    check(wrote is not None, "n2 render: no 'wrote' line")
    log(f"[n2 examples] torch_minimal_render.py: {wrote.group(0)}; "
        f"torch_minimal_train.py: losses "
        f"{', '.join(f'{v:.4f}' for v in losses)} (both beside n1)  "
        f"[{card}]")
    return by_path


def lap(t0: float, done: str):
    """The script's seconds so far, after the phases named ``done``."""
    log(f"[time] {time.perf_counter() - t0:.1f} s after {done}")

def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing ran", file=sys.stderr)
        return 2
    import transhuman_tpu_torch  # noqa: F401 — fails outside the repo

    if "--pp-worker" in sys.argv:  # one rank of phase l2, under torchrun
        pp_worker(sys.argv[sys.argv.index("--pp-worker") + 1])
        return 0

    t0 = time.perf_counter()
    card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    lap(t0, "1-3 device, build, kernels")
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
        lap(t0, "4-11 float32 paths")
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
        lap(t0, "12-13 bf16")
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
        lap(t0, "a-d config files, LPIPS, lifecycle")
        # the ZJU-MoCap loader: its codec, then train, evaluate, visualize
        # and reconstruction on laid-out humans
        phase_codec(card)
        zju_paths, zju_root, zju_models = phase_train_zju(card, tmp, files)
        by_path.update(zju_paths)
        by_path.update(phase_eval_zju(card, tmp, zju_models))
        # visibility from depth maps on phase g's and f's laid-out humans
        by_path.update(phase_depth(card, tmp, zju_root, zju_models))
        lap(t0, "e-g, i ZJU and depth maps")
        # the loader on progressive, EXIF-oriented and PNG frames
        by_path.update(phase_codings(card, tmp, files))
        lap(t0, "m image codings")
        # batches, the train cull, remat and the per-vertex radii cull
        k1_bias = phase_cull_bias(card)
        phase_batch_parity(card, card6)
        h3_paths, ckpt_b4 = phase_train_batches(card, tmp)
        by_path.update(h3_paths)
        by_path.update(phase_radii(card, tmp, ckpt_b4))
        by_path.update(phase_train_zju_batch(card, tmp, zju_root, files))
        lap(t0, "h batches and culls")
        # data parallelism: train over ranks, then evaluate, visualize and
        # reconstruct with the frames split between them
        t_j = time.perf_counter()
        j_paths, dp_ckpt = phase_dp_train(card, tmp)
        by_path.update(j_paths)
        by_path.update(phase_sharded_eval(card, tmp, dp_ckpt))
        log(f"[j] phase j in {time.perf_counter() - t_j:.1f} s")
        # ray-sharded inference and the remaining tools
        t_k = time.perf_counter()
        by_path["ray_sharded"] = phase_ray_render(card)
        by_path["ray_sharded_eval"] = phase_ray_eval(card, tmp, ckpt)
        smpl_dir, kmeans = phase_make_kmeans(card, tmp)
        phase_doctor(card, tmp, os.path.join(tmp, "zju_eval"), ckpt)
        phase_validate_official(card, tmp, smpl_dir, kmeans)
        log(f"[k] phase k in {time.perf_counter() - t_k:.1f} s")
        # the model axis: K2 at TransHE small's and base's widths,
        # tensor-parallel training, the pipelined TransHE
        t_l = time.perf_counter()
        k2_wide = {d: check_dparf_width(card, d) for d in (384, 768)}
        by_path.update(phase_tp_train(card, tmp))
        phase_pp(card, tmp)
        log(f"[l] phase l in {time.perf_counter() - t_l:.1f} s")
        # BMP, PPM, Sun raster, TIFF, GIF, Radiance HDR, WebP and JP2 frames;
        # mesh_axis_rays under torchrun; the examples
        t_n = time.perf_counter()
        by_path.update(phase_formats(card, tmp))
        log(f"[n] phase n in {time.perf_counter() - t_n:.1f} s")
        lap(t0, "every phase (the script's time)")
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
        if name in ("dparf", "dparf_bf16"):
            for d, res in k2_wide.items():
                k[f"d{d}"] = res["bf16" if name.endswith("_bf16") else "f32"]
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
