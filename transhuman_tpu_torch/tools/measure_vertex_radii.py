"""Measure per-vertex cull radii from a trained model's density (counterpart
of transhuman_tpu/tools/measure_vertex_radii.py, the same method, flags and
outputs).

The reference culls points with a uniform 0.1 m shell around the SMPL
vertices.  A trained model's density is far more concentrated than that
almost everywhere, so ``cull_radii`` can replace the shell with a
conservative per-vertex reach:

  1. sample probe points throughout the shell of each posed body
     (several poses; each probe assigned to its nearest vertex),
  2. evaluate the model's density there (``RenderPipeline.render_sigma``,
     the decode through kernels K4 and K2) and convert it to a per-sample
     alpha ``1 - exp(-relu(sigma) * spacing)`` at the render's spacing,
  3. r_v = the largest distance of a probe with alpha > --alpha_eps
     assigned to v (+ margin), floored at --min_radius, clipped at
     cull_distance (the radii never admit a point the shell culls),
  4. cross-validate: draw fresh probe sets and widen the radii over any
     significant probe they do not cover (K1's bias form, min_j(|p - v_j|^2
     - r_j^2) <= 0, the cull's own predicate) until a fresh draw finds none
     (the report's ``certified``),
  5. unless --skip_deltas, render each pose with the shell and with the
     radii and report the image deltas.

Output: an npz with key ``radii`` ((Nv,) float32 metres) and ``meta``, and a
JSON report on stdout.  Runs on the card unless ``--device cpu``.

Usage:
    # synthetic posed bodies, random weights (or --weights W.pth):
    python -m transhuman_tpu_torch.tools.measure_vertex_radii --out radii.npz
    # a config's checkpoint (--weights, else test.epoch's) and test frames:
    python -m transhuman_tpu_torch.tools.measure_vertex_radii \\
        --cfg_file configs/train_or_eval.yaml --out radii.npz [opts ...]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch


def _probe_points(verts, cull_distance, per_vertex, rng):
    """(Nv*per_vertex, 3) probes covering the shell: random directions,
    radius uniform in [0, cull_distance]."""
    nv = verts.shape[0]
    d = rng.standard_normal((nv * per_vertex, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True) + 1e-12
    u = rng.uniform(0.0, cull_distance, (nv * per_vertex, 1)).astype(
        np.float32)
    return np.repeat(verts, per_vertex, axis=0) + d * u


def make_probe_fn(pipe):
    """(frame, pts_world (N,3), spacing, radii (Nv,)) -> numpy (alpha (N,),
    dist (N,), vert_idx (N,), covered (N,)): the density-derived per-sample
    alpha, the nearest vertex and its distance, and whether the current
    radii already cover the probe (K1 with bias r^2, <= 0).  frame, points
    and radii on the pipe's device."""
    from ..kernels.cull import min_excess2
    from ..ops.knn import pairwise_dist2
    from ..render.pipeline import to_smpl

    cp = pipe.chunk_rays * pipe.n_samples

    @torch.no_grad()
    def probe(frame, pts_world, spacing, radii):
        sigma = pipe.render_sigma(frame, pts_world)
        alpha = 1.0 - torch.exp(-torch.relu(sigma) * spacing)
        pts = to_smpl(frame, pts_world).contiguous()
        verts = frame.tar_verts_smpl.contiguous()
        covered = min_excess2(pts, verts, radii * radii) <= 0.0
        dist, vidx = [], []
        for a in range(0, pts.shape[0], cp):
            d2 = pairwise_dist2(pts[a:a + cp], verts)
            best = d2.min(dim=-1)
            dist.append(torch.sqrt(best.values))
            vidx.append(best.indices)
        return tuple(t.cpu().numpy() for t in (alpha, torch.cat(dist),
                                                torch.cat(vidx), covered))

    return probe


def measure(pipe, items, *, per_vertex=24, alpha_eps=1e-3, margin=0.005,
            min_radius=0.01, spacing=None, seed=0, max_rounds=6):
    """items: [(frame, rays-or-None)] posed frames (CPU tensors).  Returns
    (radii (Nv,), report dict).  Round 1 seeds the radii; each later round
    draws fresh probes (one rng across rounds and poses) and widens the
    radii over any significant probe they do not cover, until a fresh draw
    finds none (or max_rounds)."""
    probe_fn = make_probe_fn(pipe)
    dev = pipe.device
    nv = items[0][0].tar_verts_smpl.shape[0]
    radii = np.zeros(nv, np.float32)
    n_sig = n_total = 0
    rng = np.random.default_rng(seed)
    uncovered_per_round = []
    for rnd in range(max_rounds):
        uncovered = 0
        for frame, rays in items:
            verts = frame.tar_verts_smpl.numpy().astype(np.float32)
            pts_smpl = _probe_points(verts, pipe.cull_distance, per_vertex,
                                     rng)
            Rh, Th = frame.Rh.numpy(), frame.Th.numpy()
            pts_world = pts_smpl @ Rh.T + Th  # the inverse of to_smpl (no
            # augmentation on these frames)
            if spacing is None:
                if rays is None:
                    raise ValueError("need rays (or --spacing) to derive "
                                     "the sample spacing")
                sp = float(np.median((rays.far.numpy() - rays.near.numpy())
                                     / (pipe.n_samples - 1)))
            else:
                sp = float(spacing)
            alpha, dist, vidx, cov = probe_fn(
                frame.to(dev), torch.from_numpy(pts_world).to(dev), sp,
                torch.from_numpy(radii).to(dev))
            sig = alpha > alpha_eps
            if rnd == 0:
                n_sig += int(sig.sum())
                n_total += pts_smpl.shape[0]
            miss = sig & ~cov
            uncovered += int(miss.sum())
            np.maximum.at(radii, vidx[miss], dist[miss])
        uncovered_per_round.append(uncovered)
        if rnd > 0 and uncovered == 0:
            break
    radii = np.clip(radii + margin, min_radius, pipe.cull_distance)
    report = {
        "poses": len(items),
        "probes_per_pose_per_round": per_vertex * nv,
        "rounds": len(uncovered_per_round),
        "uncovered_per_round": uncovered_per_round,
        "certified": uncovered_per_round[-1] == 0,
        "significant_frac": round(n_sig / max(n_total, 1), 4),
        "alpha_eps": alpha_eps,
        "margin_m": margin,
        "radii": {
            "min": round(float(radii.min()), 4),
            "mean": round(float(radii.mean()), 4),
            "max": round(float(radii.max()), 4),
        },
        # the shell-volume proxy for the survivor shrink
        "mean_reach_vs_shell": round(float(radii.mean())
                                     / pipe.cull_distance, 4),
    }
    return radii, report


def report_deltas(pipe, radii, items):
    """Each pose rendered with the shell and with the measured radii, and
    the image deltas between the two."""
    tight = pipe.clone(vertex_radii=np.asarray(radii, np.float32))
    dev = pipe.device
    rows = []
    for frame, rays in items:
        if rays is None:
            continue
        f, r = frame.to(dev), rays.to(dev)
        a = pipe.render_frame(f, r)["rgb_map"].float().cpu().numpy()
        b = tight.render_frame(f, r)["rgb_map"].float().cpu().numpy()
        mse = float(np.mean((a - b) ** 2))
        rows.append({
            "max_abs_delta": round(float(np.abs(a - b).max()), 6),
            "mse": mse,
            "psnr_vs_shell": round(float(-10 * np.log10(max(mse, 1e-12))), 2),
        })
    return rows


def synthetic_items(n_frames, n_rays, seed=0, *, device, weights=None,
                    **setup_kw):
    """(pipe, items): the synthetic scene's pipeline (testing.
    synthetic_setup with setup_kw; random weights, or the checkpoint
    ``weights``) and n_frames seeded poses of its body, each with n_rays
    frontal rays, as the JAX package's synthetic_items poses them."""
    from ..testing import synthetic_rays, synthetic_setup
    from ..weights import load_checkpoint_file

    model, pipe, frame, smpl, _ = synthetic_setup(device=device, **setup_kw)
    if weights:
        load_checkpoint_file(model, weights)
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n_frames):
        pose = rng.normal(0.0, 0.2, 72).astype(np.float32)
        pose[:3] = 0.0
        verts, _, _ = smpl(pose, np.zeros(10))
        verts = torch.from_numpy(np.asarray(verts, np.float32))
        f = dataclasses.replace(frame, verts_world=verts,
                                tar_verts_smpl=verts)
        items.append((f, synthetic_rays(n_rays, seed=seed + i)))
    return pipe, items


def dataset_items(cfg, n_frames, *, device, weights=None):
    """(pipe, items): the config's pipeline with its checkpoint (weights,
    else test.epoch's) and the first n_frames frames of its test set, each
    with its eval rays."""
    from ..cli.common import build_runtime, checkpoint_path, make_dataset
    from ..train.checkpoint import read_checkpoint
    from ..weights import load_reference_state_dict

    dataset = make_dataset(cfg, "test")
    ckpt = read_checkpoint(checkpoint_path(cfg, weights), cfg.vit_depth)
    model, pipe, _, _ = build_runtime(cfg, device, smpl=dataset.smpl,
                                      pe_table=ckpt["pe_table"])
    load_reference_state_dict(model, ckpt["net"])
    items = []
    for i in dataset.frame_sampler_indices()[:n_frames]:
        it = dataset.get_eval_item(int(i))
        items.append((it.frame, it.eval_rays.rays))
    return pipe, items


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.measure_vertex_radii",
        description=__doc__.split("\n", 1)[0])
    p.add_argument("--cfg_file", default=None,
                   help="measure a config's checkpoint on its test frames "
                        "(default: synthetic posed bodies)")
    p.add_argument("--out", required=True, help="output npz path")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--n_rays", type=int, default=16384)
    p.add_argument("--per_vertex", type=int, default=24,
                   help="probe points per vertex per pose")
    p.add_argument("--alpha_eps", type=float, default=1e-3,
                   help="per-sample alpha below which density is "
                        "insignificant")
    p.add_argument("--margin", type=float, default=0.005,
                   help="additive safety margin (m) on each radius")
    p.add_argument("--min_radius", type=float, default=0.01)
    p.add_argument("--spacing", type=float, default=None,
                   help="ray sample spacing for the alpha conversion "
                        "(default: median (far-near)/(S-1) of the frames)")
    p.add_argument("--skip_deltas", action="store_true",
                   help="skip the shell-vs-radii render comparison")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--weights", default=None,
                   help="a checkpoint (.pth or the JAX package's .ckpt)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; fails without a card) or cpu")
    p.add_argument("opts", nargs="*", default=[])
    args = p.parse_args(argv)

    from ..cli.common import configure_device

    device = configure_device(args.device)
    if args.cfg_file:
        from ..config import Config, check_supported

        cfg = check_supported(Config.from_yaml(args.cfg_file, args.opts))
        pipe, items = dataset_items(cfg, args.frames, device=device,
                                    weights=args.weights)
    else:
        pipe, items = synthetic_items(args.frames, args.n_rays, args.seed,
                                      device=device, weights=args.weights)
    radii, report = measure(
        pipe, items, per_vertex=args.per_vertex, alpha_eps=args.alpha_eps,
        margin=args.margin, min_radius=args.min_radius, spacing=args.spacing,
        seed=args.seed)
    if not args.skip_deltas:
        report["image_deltas_vs_shell"] = report_deltas(pipe, radii, items)
    np.savez(args.out, radii=radii,
             meta=json.dumps({k: v for k, v in report.items()
                              if k != "image_deltas_vs_shell"}))
    report["out"] = args.out
    print(json.dumps(report))
    return radii, report


if __name__ == "__main__":
    main()
