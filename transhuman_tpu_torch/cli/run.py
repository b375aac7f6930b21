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
back to the host.  With ``mesh_axis_rays`` R > 1 it splits each frame's
rays over R devices of this process (parallel/infer.py): on the card
cuda:0..R-1, or under torchrun cuda:(LOCAL_RANK·R).., which composes with
the frame split below; fewer cards is an error with the counts.
``render_frame`` waits on the card at every chunk's compaction
(``torch.nonzero``), so ``dispatch`` returns only when the last chunk's
work is queued: host work placed after it overlaps that tail and no
more.  The loops here therefore render, fetch and evaluate each frame in
turn; only the loader's eval rays run beside the render.

Under torchrun (``python -m torch.distributed.run --nproc_per_node N -m
transhuman_tpu_torch.cli.run --type ... [--dist_backend nccl|gloo]``) the
frames are split between the ranks, as the JAX CLI splits them between its
processes: rank r takes frames r, r + N, ... of the FrameSampler sequence.
``evaluate`` gathers the per-frame metrics back in the single-process order,
so every rank prints the single-process summary, and rank 0 alone writes
the ``.npy`` files and ``summary.txt``; ``visualize`` waits for every
rank's PNGs, then rank 0 assembles each human's AVI; ``reconstruction``
writes each rank's own PLYs.  No collective runs inside the model here.
Each rank prints one ``rank report`` line at the end (its frames, the
seconds they took, its kernel launches).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from ..data.loader import Loader
from ..parallel.mesh import (
    DataMesh,
    all_gather_host,
    frame_shard,
    gather_positioned,
    make_mesh,
    shutdown,
)


class FrameRenderer:
    """The frame render of evaluate, visualize, validation and serve.  With
    ``mesh_axis_rays`` R > 1 the rays of a frame are split over R devices
    (parallel/infer.py): ``devices``, or by default R cards from cuda:(base)
    on (``ray_devices``: base = LOCAL_RANK·R under torchrun), or R entries
    of ``cpu`` for a pipe on the CPU.  ``devices`` lists the devices a
    frame renders on."""

    def __init__(self, cfg, pipe, devices=None):
        self._cfg, self._pipe = cfg, pipe
        self.devices = [pipe.device]
        self._sharded = None
        r = cfg.mesh_axis_rays
        if r > 1 or devices is not None:
            from ..parallel.infer import make_sharded_render, ray_devices

            self.devices = (ray_devices(pipe.device, r) if devices is None
                            else [torch.device(d) for d in devices])
            if len(self.devices) != r:
                raise ValueError(f"mesh_axis_rays={r} but {len(self.devices)}"
                                 " devices were given")
            self._sharded = make_sharded_render(pipe, self.devices)

    def dispatch(self, frame, eval_rays):
        if self._sharded is not None:
            return self._sharded(frame, eval_rays.rays)
        dev = self._pipe.device
        return self._pipe.render_frame(frame.to(dev), eval_rays.rays.to(dev))

    def fetch(self, dispatched) -> dict:
        return {k: v.cpu().numpy().astype(np.float32)
                for k, v in dispatched.items()}


def evaluate_frames(cfg, pipe, dataset, ev, per_frame=None, tag="",
                    mesh=None, renderer=None):
    """Render this rank's FrameSampler frames (every frame in one process),
    feed the evaluator, print one line per frame; the loader makes the
    next frames' eval rays while the card renders.  per_frame(item, out)
    -> extra stats dict, averaged.  Over a distributed mesh the per-frame
    metrics and extra stats are gathered in frame order and rank 0 writes
    the files.  renderer: a FrameRenderer of pipe (default: one built from
    cfg).  Returns (the evaluator's summary, the mean extra stats), the
    same on every rank."""
    mesh = mesh or DataMesh()
    renderer = renderer or FrameRenderer(cfg, pipe)
    local, positions = frame_shard(dataset.frame_sampler_indices(), mesh)
    items = Loader(lambda i: dataset.get_eval_item(int(i)), local)
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
    if mesh.size > 1:
        from ..evals.evaluator import merge_across_processes

        merge_across_processes(ev, positions, mesh)
        # a rank with no frames has no extra keys, yet every gather below
        # is a collective each rank must join: agree on the union first
        union = sorted({k for keys in all_gather_host(sorted(extra_vals),
                                                      mesh) for k in keys})
        extra_vals = {k: gather_positioned(
            extra_vals.get(k, []), positions[:len(extra_vals.get(k, []))],
            mesh) for k in union}
    summary = ev.summarize(write=mesh.rank == 0)
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


def run_evaluate(cfg, pipe, dataset, epoch: int = -1, per_frame=None, *,
                 device, mesh=None):
    """Evaluate every frame of this rank (evaluate_frames) with the
    evaluator's LPIPS on ``device`` (a keyword with no default); print and
    return the summary."""
    from ..registry import EVALUATORS
    from .common import result_dir

    ev = EVALUATORS.get(cfg.evaluator)(
        result_dir(cfg), lpips_fn=make_eval_lpips_fn(cfg, device),
        exp_name=cfg.exp_name, epoch=epoch)
    summary, _ = evaluate_frames(cfg, pipe, dataset, ev, per_frame,
                                 mesh=mesh)
    print(summary, flush=True)
    return summary


def run_visualize(cfg, pipe, dataset, mesh=None):
    """One PNG per frame (this rank's frames), then one video per human,
    assembled by rank 0 from every rank's PNGs once all are written;
    returns this rank's PNG paths."""
    from ..registry import VISUALIZERS
    from ..viz.video import frames_to_video
    from .common import result_dir

    mesh = mesh or DataMesh()
    vis = VISUALIZERS.get(cfg.visualizer)(
        os.path.join(result_dir(cfg), "perform"), white_bkgd=cfg.white_bkgd)
    renderer = FrameRenderer(cfg, pipe)
    local, _ = frame_shard(dataset.frame_sampler_indices(full_eval=True),
                           mesh)
    items = Loader(lambda i: dataset.get_perform_item(
        int(i), render_views=cfg.render_views), local)
    paths, humans = [], []
    for item in items:
        out = renderer.fetch(renderer.dispatch(item.frame, item.eval_rays))
        paths.append(vis.visualize(out["rgb_map"], item.eval_rays.mask_at_box,
                                   item.target_img.shape[:2],
                                   item.frame_index, human=item.human))
        if item.human not in humans:
            humans.append(item.human)
        print("wrote", paths[-1], flush=True)
    if mesh.size > 1:
        # a rank joins the gather once its PNGs are written: then rank 0
        # knows every rank's humans and finds every frame on disk
        humans = list(dict.fromkeys(
            h for hs in all_gather_host(humans, mesh) for h in hs))
        if mesh.rank != 0:
            return paths
    for h in humans:
        video = frames_to_video(os.path.join(vis.out_dir, h),
                                os.path.join(vis.out_dir, f"{h}.mp4"))
        print("video:", video, flush=True)
    return paths


def run_reconstruction(cfg, pipe, dataset, mesh=None):
    """One PLY per frame (this rank's frames); returns their paths."""
    from ..mesh_ops.ply import save_ply
    from ..mesh_ops.reconstruct import extract_mesh
    from .common import result_dir

    out_dir = os.path.join(result_dir(cfg), "mesh")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    local, _ = frame_shard(dataset.frame_sampler_indices(), mesh)
    for i in local:  # strided over the ranks: each writes its own PLYs
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
        maybe_init_distributed,
        rank_report,
    )

    args, cfg = parse_args(argv)
    if args.type == "light_stage":
        return run_light_stage(cfg, args.ply, args.occupancy_out)
    device = configure_device(args.device, args.dist_backend,
                              cfg.mesh_axis_rays)
    owns_group = maybe_init_distributed(args, device)
    try:
        # the frames split over every rank (mesh_axis_data and
        # mesh_axis_model size training only, as in the JAX package)
        mesh = make_mesh()
        path = checkpoint_path(cfg, args.weights)
        if dataset is None:
            dataset = make_dataset(cfg, "test")
        # read before the runtime is built: a converted checkpoint's stored
        # PE table goes into the pipeline
        ckpt = read_checkpoint(path, cfg.vit_depth)
        model, pipe, _, _ = build_runtime(cfg, device, smpl=dataset.smpl,
                                          pe_table=ckpt["pe_table"])
        load_reference_state_dict(model, ckpt["net"])
        epoch = ckpt["epoch"]
        print(f"run: --type {args.type}, {path} (epoch {epoch}) on {device}"
              + (f", rank {mesh.rank} of {mesh.size}" if mesh.distributed
                 else ""), file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        if args.type == "evaluate":
            out = run_evaluate(cfg, pipe, dataset, epoch, per_frame,
                               device=device, mesh=mesh)
        elif args.type == "visualize":
            out = run_visualize(cfg, pipe, dataset, mesh)
        else:
            out = run_reconstruction(cfg, pipe, dataset, mesh)
        if mesh.distributed:
            rank_report(mesh, type=args.type, seconds=time.perf_counter()
                        - t0, frames=len(frame_shard(
                            dataset.frame_sampler_indices(
                                full_eval=True if args.type == "visualize"
                                else None), mesh)[0]))
        return out
    finally:
        if owns_group:
            shutdown()


if __name__ == "__main__":
    main()
