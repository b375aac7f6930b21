"""Inference entry point (counterpart of transhuman_tpu/cli/run.py):

    python -m transhuman_tpu_torch.cli.run
        --type evaluate|visualize|reconstruction|light_stage
        [--device cuda|cpu] [--weights PATH] [--ply PATH]
        [--occupancy_out PATH] [key value ...]

``evaluate``, ``visualize`` and ``reconstruction`` run from a
reference-layout ``.pth`` (``--weights``, or
``trained_model_dir/task/exp_name/latest.pth``, or ``<test.epoch>.pth``; a
missing file is an error) over every frame the dataset's FrameSampler
picks.  The data is the seeded synthetic scene at ``H_render x W_render``.
``evaluate`` renders each frame through ``RenderPipeline.render_frame`` and
writes the evaluator's per-frame PNGs, ``.npy`` metrics and ``summary.txt``
under ``result_dir/epoch_<test.epoch>/<test.exp_folder_name>``;
``visualize`` writes one PNG per frame under its ``perform/`` (video
assembly needs imageio or ffmpeg and is not ported); ``reconstruction``
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

import argparse
import os
import sys

import numpy as np

from ..config import Config
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


def run_evaluate(cfg, pipe, dataset, epoch: int = -1, per_frame=None):
    from ..evals.evaluator import Evaluator
    from .common import result_dir

    if cfg.evaluator != "if_nerf":
        raise ValueError(f"unknown evaluator {cfg.evaluator!r}; the port has "
                         "'if_nerf'")
    ev = Evaluator(result_dir(cfg), exp_name=cfg.exp_name, epoch=epoch)
    summary, _ = evaluate_frames(cfg, pipe, dataset, ev, per_frame)
    print(summary, flush=True)
    return summary


def run_visualize(cfg, pipe, dataset):
    """One PNG per frame; returns their paths."""
    from ..viz.perform import PerformVisualizer
    from .common import result_dir

    if cfg.visualizer != "perform":
        raise ValueError(f"unknown visualizer {cfg.visualizer!r}; the port "
                         "has 'perform'")
    vis = PerformVisualizer(os.path.join(result_dir(cfg), "perform"),
                            white_bkgd=cfg.white_bkgd)
    renderer = FrameRenderer(cfg, pipe)
    items = Loader(lambda i: dataset.get_perform_item(
        int(i), render_views=cfg.render_views),
        dataset.frame_sampler_indices(full_eval=True))
    paths = []
    for item in items:
        out = renderer.fetch(renderer.dispatch(item.frame, item.eval_rays))
        paths.append(vis.visualize(out["rgb_map"], item.eval_rays.mask_at_box,
                                   item.target_img.shape[:2],
                                   item.frame_index, human=item.human))
        print("wrote", paths[-1], flush=True)
    print("video assembly (viz/video.py: imageio or ffmpeg) is not ported; "
          f"the frames are in {vis.out_dir}", flush=True)
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
    p = argparse.ArgumentParser(prog="python -m transhuman_tpu_torch.cli.run")
    p.add_argument("--type", default="evaluate",
                   choices=["evaluate", "visualize", "reconstruction",
                            "light_stage"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--weights", default=None,
                   help="reference-layout .pth (default: <trained_model_dir>"
                        "/<task>/<exp_name>/latest.pth, or <test.epoch>.pth)")
    p.add_argument("--ply", default=None, help="light_stage: input .ply")
    p.add_argument("--occupancy_out", default=None,
                   help="light_stage: output .npy (default <ply>"
                        ".occupancy.npy)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="config overrides: key value ...")
    args = p.parse_args(argv)
    return args, Config().merge_opts(args.opts)


def main(argv=None, dataset=None, per_frame=None):
    """evaluate: the summary dict; visualize: the PNG paths;
    reconstruction: the PLY paths; light_stage: the occupancy path.
    dataset replaces make_dataset's; per_frame goes to evaluate_frames."""
    from ..weights import load_checkpoint_file
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
    model, pipe, _, _ = build_runtime(cfg, device, smpl=dataset.smpl)
    epoch = load_checkpoint_file(model, path)
    print(f"run: --type {args.type}, {path} (epoch {epoch}) on {device}",
          file=sys.stderr, flush=True)
    if args.type == "evaluate":
        return run_evaluate(cfg, pipe, dataset, epoch, per_frame)
    if args.type == "visualize":
        return run_visualize(cfg, pipe, dataset)
    return run_reconstruction(cfg, pipe, dataset)


if __name__ == "__main__":
    main()
