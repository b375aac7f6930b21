"""Inference entry point (counterpart of transhuman_tpu/cli/run.py):

    python -m transhuman_tpu_torch.cli.run
        --type evaluate|visualize|reconstruction|light_stage
        [--cfg_file configs/*.yaml] [--device cuda|cpu] [--weights PATH]
        [--ply PATH] [--occupancy_out PATH] [key value ...]

``evaluate``, ``visualize`` and ``reconstruction`` run from a checkpoint
(``--weights``: the port's ``.pth`` or the JAX package's ``.ckpt``; else
test.epoch's in ``trained_model_dir/task/exp_name``, the port's
``latest.pth`` / ``<epoch>.pth`` or failing those the JAX package's
``latest.ckpt`` / ``ep<epoch>.ckpt``; a missing file is an error) over
every frame the dataset's FrameSampler picks.  The data is the seeded
synthetic scene (``dataset synthetic``) at ``H_render x W_render``.
``evaluate`` renders each frame through ``RenderPipeline.render_frame`` and
writes the evaluator's per-frame PNGs, ``.npy`` metrics and ``summary.txt``
(with the LPIPS column when ``lpips_weights`` is set) under
``result_dir/epoch_<test.epoch>/<test.exp_folder_name>``;
``visualize`` writes one PNG per frame under its ``perform/<human>/`` and
then each human's frames as ``perform/<human>.avi`` (MJPG, the port's own
JPEG encoder: ``viz/video.py``); ``reconstruction``
extracts each frame's mesh (``mesh_ops.reconstruct.extract_mesh`` at
``voxel_size``, iso-level ``mesh_th``) and writes it as
``mesh/<human>_frame<index>.ply``.  They run on the card (``--device
cuda``, the default; without a card that is an error) with TF32 off, or on
the CPU with ``--device cpu``, in the network's ``compute_dtype`` (float32
or bfloat16).  ``light_stage`` voxelizes the mesh
``--ply`` into an occupancy volume (``tools/voxelize_mesh.py`` at
``voxel_size[0]``; default output ``<ply>.occupancy.npy``) on the host: it
needs no card and no checkpoint.

``FrameRenderer`` also serves ``serve.py``: ``dispatch`` moves a frame and
its rays to the pipeline's device and renders it; ``fetch`` brings the maps
back to the host.  ``render_frame`` waits on the card at every chunk's
compaction (``torch.nonzero``), so ``dispatch`` returns only when the last
chunk's work is queued: host work placed after it overlaps that tail and
no more.  The loops here therefore render, fetch and evaluate each frame in
turn; only the loader's eval rays run beside the render.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from ..data.loader import Loader


class FrameRenderer:
    def __init__(self, cfg, pipe):
        self._cfg, self._pipe = cfg, pipe

    def dispatch(self, frame, eval_rays):
        dev = self._pipe.device
        return self._pipe.render_frame(frame.to(dev), eval_rays.rays.to(dev))

    def fetch(self, dispatched) -> dict:
        return {k: v.cpu().numpy().astype(np.float32)
                for k, v in dispatched.items()}


def evaluate_frames(cfg, pipe, dataset, ev, per_frame=None, tag=""):
    """Render every FrameSampler frame, feed the evaluator, print one line
    per frame; the loader makes the next frames' eval rays while the card
    renders.  per_frame(item, out) -> extra stats dict, averaged.  Returns
    (the evaluator's summary, the mean extra stats)."""
    renderer = FrameRenderer(cfg, pipe)
    items = Loader(lambda i: dataset.get_eval_item(int(i)),
                   dataset.frame_sampler_indices())
    extra_vals = {}
    for item in items:
        out = renderer.fetch(renderer.dispatch(item.frame, item.eval_rays))
        r = ev.evaluate_frame(
            out["rgb_map"], item.eval_rays.rgb, item.eval_rays.mask_at_box,
            item.target_img.shape[:2], human=item.human,
            frame_index=item.frame_index, cam_ind=item.cam_ind,
            input_imgs=item.frame.images.numpy(), white_bkgd=cfg.white_bkgd)
        extra = per_frame(item, out) if per_frame else {}
        for k, v in extra.items():
            extra_vals.setdefault(k, []).append(float(v))
        print(f"[{tag}{item.human} f{item.frame_index} c{item.cam_ind}] "
              + "  ".join(f"{k}: {v:.4f}" for k, v in extra.items())
              + ("  " if extra else "")
              + "  ".join(f"{k}: {v:.4f}" for k, v in r.items()
                          if v is not None), flush=True)
    summary = ev.summarize()
    return summary, {k: float(np.mean(v)) for k, v in extra_vals.items()}


def make_eval_lpips_fn(cfg, device):
    """The evaluator's LPIPS (a, b) -> (B,) distances on numpy (B, h, w, 3)
    crops in [-1, 1], run on device in float32 without gradients; None when
    cfg.lpips_weights is empty."""
    from ..models.lpips import lpips_module

    lpips = lpips_module(cfg, device)
    if lpips is None:
        return None

    @torch.no_grad()
    def fn(a, b):
        t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
             for x in (a, b)]
        return lpips(*t).cpu().numpy()

    return fn


def run_evaluate(cfg, pipe, dataset, epoch: int = -1, per_frame=None,
                 device="cpu"):
    from ..evals.evaluator import Evaluator
    from .common import result_dir

    ev = Evaluator(result_dir(cfg), lpips_fn=make_eval_lpips_fn(cfg, device),
                   exp_name=cfg.exp_name, epoch=epoch)
    summary, _ = evaluate_frames(cfg, pipe, dataset, ev, per_frame)
    print(summary, flush=True)
    return summary


def run_visualize(cfg, pipe, dataset):
    """One PNG per frame, then one video per human; returns the PNGs'
    paths."""
    from ..viz.perform import PerformVisualizer
    from ..viz.video import frames_to_video
    from .common import result_dir

    vis = PerformVisualizer(os.path.join(result_dir(cfg), "perform"),
                            white_bkgd=cfg.white_bkgd)
    renderer = FrameRenderer(cfg, pipe)
    items = Loader(lambda i: dataset.get_perform_item(
        int(i), render_views=cfg.render_views),
        dataset.frame_sampler_indices(full_eval=True))
    paths, humans = [], []
    for item in items:
        out = renderer.fetch(renderer.dispatch(item.frame, item.eval_rays))
        paths.append(vis.visualize(out["rgb_map"], item.eval_rays.mask_at_box,
                                   item.target_img.shape[:2],
                                   item.frame_index, human=item.human))
        if item.human not in humans:
            humans.append(item.human)
        print("wrote", paths[-1], flush=True)
    for h in humans:
        video = frames_to_video(os.path.join(vis.out_dir, h),
                                os.path.join(vis.out_dir, f"{h}.mp4"))
        print("video:", video, flush=True)
    return paths


def run_reconstruction(cfg, pipe, dataset):
    """One PLY per frame; returns their paths."""
    from ..mesh_ops.ply import save_ply
    from ..mesh_ops.reconstruct import extract_mesh
    from .common import result_dir

    out_dir = os.path.join(result_dir(cfg), "mesh")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in dataset.frame_sampler_indices():
        frame, can_bounds, meta = dataset.get_mesh_item(int(i))
        verts, tris, _ = extract_mesh(pipe, frame, can_bounds,
                                      voxel_size=cfg.voxel_size,
                                      mesh_th=cfg.mesh_th)
        paths.append(os.path.join(
            out_dir, f"{meta['human']}_frame{meta['frame_index']:04d}.ply"))
        save_ply(paths[-1], verts, tris)
        print(f"wrote {paths[-1]} ({len(verts)} verts, {len(tris)} tris)",
              flush=True)
    return paths


def run_light_stage(cfg, ply, occupancy_out=None):
    """The reference's ply -> occupancy conversion (run.py:160-162);
    returns the output path."""
    from ..tools.voxelize_mesh import main as vox_main

    if not ply:
        raise SystemExit("--type light_stage needs --ply PATH (a mesh that "
                         "--type reconstruction wrote)")
    return vox_main([ply, occupancy_out or ply + ".occupancy.npy",
                     "--voxel", str(cfg.voxel_size[0])])


def parse_args(argv=None):
    from .common import parse_args as _parse_args

    return _parse_args(argv, need_type=True,
                       prog="python -m transhuman_tpu_torch.cli.run")


def main(argv=None, dataset=None, per_frame=None):
    """evaluate: the summary dict; visualize: the PNG paths;
    reconstruction: the PLY paths; light_stage: the occupancy path.
    dataset replaces make_dataset's; per_frame goes to evaluate_frames."""
    from ..train.checkpoint import read_checkpoint
    from ..weights import load_reference_state_dict
    from .common import (
        build_runtime,
        checkpoint_path,
        configure_device,
        make_dataset,
    )

    args, cfg = parse_args(argv)
    if args.type == "light_stage":
        return run_light_stage(cfg, args.ply, args.occupancy_out)
    device = configure_device(args.device)
    path = checkpoint_path(cfg, args.weights)
    if dataset is None:
        dataset = make_dataset(cfg, "test")
    # read before the runtime is built: a converted checkpoint's stored PE
    # table goes into the pipeline
    ckpt = read_checkpoint(path, cfg.vit_depth)
    model, pipe, _, _ = build_runtime(cfg, device, smpl=dataset.smpl,
                                      pe_table=ckpt["pe_table"])
    load_reference_state_dict(model, ckpt["net"])
    epoch = ckpt["epoch"]
    print(f"run: --type {args.type}, {path} (epoch {epoch}) on {device}",
          file=sys.stderr, flush=True)
    if args.type == "evaluate":
        return run_evaluate(cfg, pipe, dataset, epoch, per_frame, device)
    if args.type == "visualize":
        return run_visualize(cfg, pipe, dataset)
    return run_reconstruction(cfg, pipe, dataset)


if __name__ == "__main__":
    main()
