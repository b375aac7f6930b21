"""The training step: render a batch of samples' rays, patch loss, backward,
clip, optimizer update (counterpart of transhuman_tpu/train/step.py;
reference ``lib/train/trainers/trainer.py``).

On one device, as the JAX step without a mesh: a batch of B samples renders
with one encoder pass over all their views (``render_train_batch``), so
BatchNorm pools its statistics over the batch as the JAX step's vmap over
its 'batch' axis does.  The loss and every stat are the means of the
per-sample ones.  ``accum_steps`` splits the batch, strided as the JAX
package splits it, into microbatches that each render and backpropagate in
turn (BatchNorm pooled within each), before one clip and one update.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from ..render.pipeline import fold_in
from .loss import TrainSample, patch_losses, random_ray_losses
from .schedule import warmup_cosine_epoch_schedule


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    step: int = 0


def make_optimizer(params, lr: float = 7e-4, end_lr: float = 1e-6,
                   warmup_epochs: int = 300, decay_epochs: int = 3000,
                   iters_per_epoch: int = 500, weight_decay: float = 0.0,
                   optim: str = "adam"):
    """(optimizer, scheduler): Adam, AdamW, RAdam or SGD(momentum 0.9) with
    optax's defaults, under the per-epoch warmup-cosine schedule.  The
    scheduler is stepped after each update, so update k uses lr(k), as optax
    evaluates its schedule at the count before incrementing it (the first
    update uses lr(0) = lr / warmup_epochs)."""
    params = list(params)
    schedule = warmup_cosine_epoch_schedule(lr, end_lr, warmup_epochs,
                                            decay_epochs, iters_per_epoch)
    if optim == "adamw" or (optim == "adam" and weight_decay > 0):
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif optim == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optim == "radam":
        opt = torch.optim.RAdam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif optim == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=0.9)
    else:
        raise ValueError(f"unknown optimizer {optim!r}")
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: schedule(step) / lr)
    return opt, scheduler


def make_batch_loss(pipe, l2_weight: float = 1.0, perturb: bool = True,
                    lpips_fn=None, lpips_weight: float = 0.1,
                    patch_mode: bool = True):
    """(samples, seeds) -> (loss, stats) of a batch: each sample's loss, the
    composition of the reference's NetworkWrapper (if_nerf_clight.py:43-91),
    then the mean over the samples of the loss and of each stat, as the JAX
    step means its vmapped per-sample losses (not pooled over rays).  Patch
    mode (``patch.use_patch_sampling``): the patch MSE, with LPIPS when
    lpips_fn is given (its backward runs through the VGG16 convolutions
    into the rendered patches); otherwise the masked MSE of the single
    rays, added unweighted as in the reference (l2rec_weight scales the
    patch MSE only).  Under train.cull the stats carry JAX's ``overflow``,
    which is 0 here."""

    def sample_loss(out, sample: TrainSample):
        if not patch_mode:
            loss, stats = random_ray_losses(out["rgb_map"], sample)
        else:
            loss, stats = patch_losses(out["rgb_map"], sample, lpips_fn,
                                       l2_weight, lpips_weight)
        if "overflow" in out:
            stats["overflow"] = out["overflow"][0]
        return loss, stats

    def batch_loss(samples, seeds):
        outs = pipe.render_train_batch([s.frame for s in samples],
                                       [s.rays for s in samples], seeds,
                                       sample_jitter=perturb)
        per = [sample_loss(o, s) for o, s in zip(outs, samples)]
        loss = torch.stack([lo for lo, _ in per]).mean()
        stats = {k: torch.stack([st[k] for _, st in per]).mean()
                 for k in per[0][1]}
        return loss, stats

    return batch_loss


def make_sample_loss(pipe, l2_weight: float = 1.0, perturb: bool = True,
                     lpips_fn=None, lpips_weight: float = 0.1,
                     patch_mode: bool = True):
    """(sample, seed) -> (loss, stats) for one sample (make_batch_loss of a
    batch of one)."""
    batch_loss = make_batch_loss(pipe, l2_weight, perturb, lpips_fn,
                                 lpips_weight, patch_mode)

    def sample_loss(sample: TrainSample, seed=None):
        return batch_loss([sample], [seed])

    return sample_loss


def make_train_step(pipe, clip_value: float = 40.0, l2_weight: float = 1.0,
                    perturb: bool = True, accum_steps: int = 1,
                    lpips_fn=None, lpips_weight: float = 0.1,
                    patch_mode: bool = True):
    """(state, batch, seed) -> stats, batch a TrainSample or a list of B of
    them: forward, loss, backward (in accum_steps microbatches), per-element
    gradient clip at clip_value (reference trainer.py:85), optimizer
    update, schedule step.  Updates state.model, its optimizer and
    scheduler in place and advances state.step.  stats holds the means of
    the losses over the batch as floats and the lr the update used.

    Sample i renders with the seed ``fold_in(seed, i)``, fixed before the
    batch is split, so accum_steps never changes a sample's draws (JAX:
    ``fold_in(rng, i)``).  Microbatch j holds samples j, j + accum_steps,
    ... (the JAX package's strided split); each backpropagates its mean
    loss over accum_steps, so the gradient is the mean over the
    microbatches, as are the stats.  A batch that accum_steps does not
    divide is a ValueError, as in JAX.  Under train.cull stats also holds
    ``cull_survivors``, the fraction of the batch's points decoded (the
    JAX package reports it through ``train_cull_fraction``)."""
    batch_loss = make_batch_loss(pipe, l2_weight, perturb, lpips_fn,
                                 lpips_weight, patch_mode)

    def step(state: TrainState, batch, seed=None) -> dict:
        samples = [batch] if isinstance(batch, TrainSample) else list(batch)
        b = len(samples)
        if b % accum_steps:
            raise ValueError(
                f"batch {b} not divisible by accum_steps {accum_steps}")
        seeds = [None if seed is None else fold_in(seed, i)
                 for i in range(b)]
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        totals, decoded = {}, [0, 0]
        for j in range(accum_steps):
            mb = range(j, b, accum_steps)
            # the ranges train/profile.py splits a profiled step by
            with record_function("train_step.forward"):
                loss, stats = batch_loss([samples[i] for i in mb],
                                         [seeds[i] for i in mb])
            with record_function("train_step.backward"):
                (loss / accum_steps).backward()
            for k, v in stats.items():
                totals[k] = totals.get(k, 0.0) + v.detach()
            decoded[0] += pipe.last_frame_stats["survivors"]
            decoded[1] += pipe.last_frame_stats["points"]
        with record_function("train_step.optimizer"):
            params = [p for g in opt.param_groups for p in g["params"]]
            torch.nn.utils.clip_grad_value_(params, clip_value)
            lr = opt.param_groups[0]["lr"]
            opt.step()
            state.scheduler.step()
        state.step += 1
        out = {k: float(v) / accum_steps for k, v in totals.items()}
        out["lr"] = lr
        if pipe.train_cull:
            out["cull_survivors"] = decoded[0] / decoded[1]
        return out

    return step
