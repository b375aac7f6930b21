"""Training losses (counterpart of transhuman_tpu/train/loss.py; reference
``lib/train/trainers/if_nerf_clight.py``).

Patch mode scatters the predicted ray colours into N_patches square patches
(pixels no ray covers stay black) and takes the MSE against the target
patches, plus ``lpips_weight`` x the mean LPIPS of the patches when an LPIPS
module is given (the reference's 1.0 x MSE + 0.1 x LPIPS).  Each ray carries
its index into the flattened patch raster; invalid rays carry -1 and are
dropped.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch

from ..render.pipeline import FrameInputs, RayBundle


@dataclass
class TrainSample:
    """One training example.  Patch mode fills target_patches and
    ray_pixel_idx; non-patch mode fills target_rgb."""

    frame: FrameInputs
    rays: RayBundle
    target_patches: Optional[torch.Tensor] = None  # (P, ps, ps, 3)
    ray_pixel_idx: Optional[torch.Tensor] = None  # (R,) into P*ps*ps; -1
    target_rgb: Optional[torch.Tensor] = None  # (R, 3)

    def to(self, device):
        """A copy with every tensor moved to ``device``."""
        out = {}
        for f in fields(self):
            x = getattr(self, f.name)
            out[f.name] = None if x is None else x.to(device)
        return TrainSample(**out)


def unpack_patches(pred_rgb, ray_pixel_idx, patch_shape):
    """Scatter per-ray colours (R, 3) into (P, ps, ps, 3) patches, black
    where no ray lands; rays with index -1 are dropped."""
    p, ps = patch_shape[0], patch_shape[1]
    valid = ray_pixel_idx >= 0
    flat = torch.zeros((p * ps * ps, 3), dtype=pred_rgb.dtype,
                       device=pred_rgb.device)
    flat = flat.index_put((ray_pixel_idx[valid].long(),), pred_rgb[valid])
    return flat.reshape(p, ps, ps, 3)


def patch_losses(pred_rgb, sample: TrainSample, lpips_fn=None,
                 l2_weight: float = 1.0, lpips_weight: float = 0.1):
    """(loss, stats) of the patch MSE, plus lpips_weight x mean LPIPS over
    the (P, ps, ps, 3) patches mapped to [-1, 1] when lpips_fn (a
    models.lpips.LPIPS) is given.  pred_rgb (R, 3) ray colours."""
    targets = sample.target_patches
    pred = unpack_patches(pred_rgb, sample.ray_pixel_idx, targets.shape)
    mse = l2_weight * torch.mean(torch.square(pred - targets))
    loss, stats = mse, {"mse_loss": mse}
    if lpips_fn is not None:
        lp = lpips_weight * torch.mean(lpips_fn(pred * 2.0 - 1.0,
                                                targets * 2.0 - 1.0))
        loss = loss + lp
        stats["lpips_loss"] = lp
    stats["loss"] = loss
    return loss, stats


def masked_mse(pred_rgb, target_rgb, mask):
    """MSE over the valid rays (reference if_nerf_clight.py:77-81)."""
    m = mask[:, None].to(pred_rgb.dtype)
    denom = torch.clamp_min(torch.sum(m) * 3.0, 1.0)
    return torch.sum(torch.square((pred_rgb - target_rgb) * m)) / denom


def random_ray_losses(pred_rgb, sample: TrainSample, l2_weight: float = 1.0):
    """Non-patch loss: the masked MSE, named 'img_loss' as in the
    reference."""
    img_loss = l2_weight * masked_mse(pred_rgb, sample.target_rgb,
                                      sample.rays.mask)
    return img_loss, {"img_loss": img_loss, "loss": img_loss}
