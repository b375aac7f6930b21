"""Training entry point (counterpart of transhuman_tpu/cli/train.py):

    python -m transhuman_tpu_torch.cli.train [--device cuda|cpu] [--steps N]
        [--out PATH] [key value ...]

Trains on the seeded synthetic scene (the only data the repository holds)
at the config's render size (H_render x W_render, 512 x 512 by default),
from ``testing.init_weights`` weights seeded with ``cfg.seed``: one sample
per step, the epoch's samples in a seeded permutation, one loss line per
step, and a reference-layout ``.pth`` at the end that
``python -m transhuman_tpu_torch.serve --weights`` serves.  Config
overrides are ``key value`` pairs as the serve entry point takes them.
It runs on the card (``--device cuda``, the default; without a card that is
an error) with the float32 math in full precision (TF32 off), or on the CPU
with ``--device cpu``; ``compute_dtype bfloat16`` trains the bf16 network
(float32 parameters, gradients and optimizer).  With ``profile_dir DIR``
the steady-state window of steps 5-8 (fewer in a short run) runs under
torch.profiler; its chrome trace and a device-time summary
(``train/profile.py``) go to DIR.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..config import Config
from ..data.synthetic import SyntheticDataset
from ..render.pipeline import fold_in
from ..testing import init_weights
from ..train.checkpoint import save_checkpoint
from ..train.profile import format_summary, load_trace, summarize_trace
from ..train.step import TrainState, make_optimizer, make_train_step
from .common import build_runtime, configure_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.cli.train")
    p.add_argument("--device", default="cuda")
    p.add_argument("--steps", type=int, default=0,
                   help="updates to run (0: train.epoch x ep_iter)")
    p.add_argument("--out", default=None,
                   help="checkpoint path (default: <trained_model_dir>/"
                        "<task>/<exp_name>/latest.pth)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[],
                   help="config overrides: key value ...")
    args = p.parse_args(argv)
    return args, Config().merge_opts(args.opts)


def build_trainer(cfg: Config, device):
    """(state, step_fn, dataset, pipe) for cfg on device."""
    if cfg.train.cull:
        raise NotImplementedError(
            "train.cull (the SMPL cull on the train decode) is not ported")
    if cfg.lpips_weights:
        raise NotImplementedError("LPIPS is not ported yet; leave "
                                  "lpips_weights empty")
    print("WARNING: cfg.lpips_weights empty -> perceptual loss DISABLED; "
          "the trained model will NOT match the reference loss landscape "
          "(if_nerf_clight.py:65-72 adds 0.1*LPIPS).", file=sys.stderr)
    dataset = SyntheticDataset(cfg, image_hw=(cfg.H_render, cfg.W_render))
    model, pipe, _, _ = build_runtime(cfg, device, smpl=dataset.smpl)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    sch = cfg.train.scheduler
    opt, scheduler = make_optimizer(
        model.parameters(), lr=cfg.train.lr, end_lr=sch.end_lr,
        warmup_epochs=sch.warmup_epochs, decay_epochs=sch.decay_epochs,
        iters_per_epoch=cfg.ep_iter, weight_decay=cfg.train.weight_decay,
        optim=cfg.train.optim)
    step_fn = make_train_step(
        pipe, l2_weight=cfg.l2rec_weight, perturb=cfg.perturb > 0,
        batch_size=cfg.train.batch_size, accum_steps=cfg.train.accum_steps)
    return TrainState(model, opt, scheduler), step_fn, dataset, pipe


def _activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _write_profile(out_dir: str, prof, records):
    """The window's chrome trace and its device-time summary
    (train/profile.py) into out_dir; the summary is printed too."""
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "train_trace.json.gz")
    prof.export_chrome_trace(path)
    summary = summarize_trace(load_trace(path),
                              sum(r["step_s"] for r in records) * 1e3,
                              len(records))
    summary["first_step"] = records[0]["step"]
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(f"profiler trace (steps {records[0]['step']}-"
          f"{records[-1]['step']}) written to {path}\n"
          f"{format_summary(summary)}", flush=True)


def main(argv=None):
    """Returns (state, records): records holds one dict per step (losses,
    lr, step seconds)."""
    args, cfg = parse_args(argv)
    device = configure_device(args.device)
    state, step_fn, dataset, _ = build_trainer(cfg, device)
    steps = args.steps or cfg.train.epoch * cfg.ep_iter
    # the JAX CLI's steady-state window: steps 5-8 of the first epoch,
    # shorter in a short run
    prof_stop = min(8, cfg.ep_iter - 1, steps - 1)
    prof_start = max(0, prof_stop - 3)
    prof = None
    records = []
    for it in range(steps):
        epoch, i = divmod(it, cfg.ep_iter)
        if i == 0:
            dataset.set_epoch(epoch)
            # exactly ep_iter samples per epoch, cycling a seeded permutation
            ep_rng = np.random.default_rng(cfg.seed + epoch)
            perm = np.concatenate([
                ep_rng.permutation(len(dataset))
                for _ in range(-(-cfg.ep_iter // len(dataset)))])
        if cfg.profile_dir and it == prof_start:
            prof = torch.profiler.profile(activities=_activities(device))
            prof.start()
        t0 = time.perf_counter()
        sample = dataset.get_train_sample(int(perm[i])).to(device)
        t1 = time.perf_counter()
        stats = step_fn(state, sample, fold_in(cfg.seed, it))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        rec = dict(stats, step=it, data_s=t1 - t0, step_s=t2 - t1)
        records.append(rec)
        if prof is not None and it == prof_stop:
            prof.stop()
            _write_profile(cfg.profile_dir, prof, records[prof_start:])
            prof = None
        print(f"epoch {epoch} iter {i}/{cfg.ep_iter}  loss {stats['loss']:.6f}"
              f"  mse_loss {stats['mse_loss']:.6f}  lr {stats['lr']:.3e}  "
              f"data {rec['data_s']:.3f}s  step {rec['step_s']:.3f}s",
              flush=True)
    out = args.out or os.path.join(cfg.trained_model_dir, cfg.task,
                                   cfg.exp_name, "latest.pth")
    save_checkpoint(out, state, (steps - 1) // cfg.ep_iter)
    print(f"checkpoint: {out}", flush=True)
    return state, records


if __name__ == "__main__":
    main()
