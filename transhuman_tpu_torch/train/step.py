"""The training step: render the sample's rays, patch loss, backward, clip,
optimizer update (counterpart of transhuman_tpu/train/step.py; reference
``lib/train/trainers/trainer.py``).

One sample per step on one device.  The JAX step vmaps a batch and pools
BatchNorm statistics over it (its model's ``axis_name``); a loop over
samples here would normalise each alone, a different model, so
``batch_size`` and ``accum_steps`` other than 1 are refused.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from .loss import TrainSample, patch_losses
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


def make_sample_loss(pipe, l2_weight: float = 1.0, perturb: bool = True,
                     lpips_fn=None, lpips_weight: float = 0.1):
    """(sample, seed) -> (loss, stats) for one patch-mode sample: the loss
    composition of the reference's NetworkWrapper (if_nerf_clight.py:43-91),
    with LPIPS when lpips_fn is given (its backward runs through the VGG16
    convolutions into the rendered patches).  The only sampler the port has
    is the patch sampler, so the non-patch loss (``loss.random_ray_losses``)
    has no caller here."""

    def sample_loss(sample: TrainSample, seed=None):
        out = pipe.render_train(sample.frame, sample.rays, seed,
                                sample_jitter=perturb)
        return patch_losses(out["rgb_map"], sample, lpips_fn, l2_weight,
                            lpips_weight)

    return sample_loss


def make_train_step(pipe, clip_value: float = 40.0, l2_weight: float = 1.0,
                    perturb: bool = True, batch_size: int = 1,
                    accum_steps: int = 1, lpips_fn=None,
                    lpips_weight: float = 0.1):
    """(state, sample, seed) -> stats: forward, loss, backward, per-element
    gradient clip at clip_value (reference trainer.py:85), optimizer update,
    schedule step.  Updates state.model, its optimizer and scheduler in
    place and advances state.step.  stats holds the losses as floats and
    the lr the update used."""
    if batch_size != 1 or accum_steps != 1:
        raise ValueError(
            f"batch_size={batch_size}, accum_steps={accum_steps}: the port "
            "trains one sample per step; the JAX package pools BatchNorm "
            "statistics over its batch, which a loop over samples would not "
            "reproduce")
    sample_loss = make_sample_loss(pipe, l2_weight, perturb, lpips_fn,
                                   lpips_weight)

    def step(state: TrainState, sample: TrainSample, seed=None) -> dict:
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        # the ranges train/profile.py splits a profiled step by
        with record_function("train_step.forward"):
            loss, stats = sample_loss(sample, seed)
        with record_function("train_step.backward"):
            loss.backward()
        with record_function("train_step.optimizer"):
            params = [p for g in opt.param_groups for p in g["params"]]
            torch.nn.utils.clip_grad_value_(params, clip_value)
            lr = opt.param_groups[0]["lr"]
            opt.step()
            state.scheduler.step()
        state.step += 1
        out = {k: float(v.detach()) for k, v in stats.items()}
        out["lr"] = lr
        return out

    return step
