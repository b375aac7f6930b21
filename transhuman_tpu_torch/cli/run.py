"""Inference entry point (counterpart of transhuman_tpu/cli/run.py):

    python -m transhuman_tpu_torch.cli.run --type evaluate|visualize
        [--device cuda|cpu] [--weights PATH] [key value ...]

Both render every frame the dataset's FrameSampler picks through
``RenderPipeline.render_frame`` from a reference-layout ``.pth``
(``--weights``, or ``trained_model_dir/task/exp_name/latest.pth``, or
``<test.epoch>.pth``; a missing file is an error).  The data is the seeded
synthetic scene at ``H_render x W_render``.  ``evaluate`` writes the
evaluator's per-frame PNGs, ``.npy`` metrics and ``summary.txt`` under
``result_dir/epoch_<test.epoch>/<test.exp_folder_name>``; ``visualize``
writes one PNG per frame under its ``perform/`` (video assembly needs
imageio or ffmpeg and is not ported).  It runs on the card (``--device
cuda``, the default; without a card that is an error) with TF32 off, or on
the CPU with ``--device cpu``.  ``--type reconstruction`` and
``light_stage`` are not ported (ROADMAP queue 1 item 2).

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
import torch

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


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m transhuman_tpu_torch.cli.run")
    p.add_argument("--type", default="evaluate",
                   choices=["evaluate", "visualize", "reconstruction",
                            "light_stage"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--weights", default=None,
                   help="reference-layout .pth (default: <trained_model_dir>"
                        "/<task>/<exp_name>/latest.pth, or <test.epoch>.pth)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="config overrides: key value ...")
    args = p.parse_args(argv)
    return args, Config().merge_opts(args.opts)


def main(argv=None, dataset=None, per_frame=None):
    """evaluate: the summary dict; visualize: the PNG paths.  dataset
    replaces make_dataset's; per_frame goes to evaluate_frames."""
    from ..weights import load_checkpoint_file
    from .common import build_runtime, checkpoint_path, make_dataset

    args, cfg = parse_args(argv)
    if args.type in ("reconstruction", "light_stage"):
        raise NotImplementedError(
            f"--type {args.type} is not ported yet (ROADMAP queue 1 item 2: "
            "render_sigma mesh extraction and marching tetrahedra)")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("--device cuda, but no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    path = checkpoint_path(cfg, args.weights)
    if dataset is None:
        dataset = make_dataset(cfg, "test")
    model, pipe, _, _ = build_runtime(cfg, device, smpl=dataset.smpl)
    epoch = load_checkpoint_file(model, path)
    print(f"run: --type {args.type}, {path} (epoch {epoch}) on {device}",
          file=sys.stderr, flush=True)
    if args.type == "evaluate":
        return run_evaluate(cfg, pipe, dataset, epoch, per_frame)
    return run_visualize(cfg, pipe, dataset)


if __name__ == "__main__":
    main()
