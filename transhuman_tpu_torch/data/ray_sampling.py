"""Full-frame evaluation rays (counterpart of
transhuman_tpu/data/ray_sampling.py::sample_eval_rays): every pixel whose ray
meets the inflated body AABB is a ray; and the eval item that carries them
(counterpart of transhuman_tpu/data/zju.py::EvalItem)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.rays import get_near_far, get_rays
from ..render.pipeline import FrameInputs, RayBundle


@dataclass
class EvalRays:
    rays: RayBundle  # R = rays in the box, CPU tensors
    pix_idx: np.ndarray  # (R,) int32 index into H*W for the scatter-back
    rgb: np.ndarray  # (R, 3) ground-truth colours (zeros without an image)
    mask_at_box: np.ndarray  # (H*W,) bool


@dataclass
class EvalItem:
    frame: FrameInputs  # the V input views, CPU tensors
    eval_rays: EvalRays
    target_img: np.ndarray  # (H, W, 3)
    target_msk: np.ndarray  # (H, W) uint8 (0 bg / 1 body / 100 border)
    human: str
    human_idx: int
    frame_index: int
    cam_ind: int


def sample_eval_rays(img, K, R, T, can_bounds, hw=None) -> EvalRays:
    """img (H,W,3) or None with hw=(H, W) when no ground truth exists (the
    serving path); K (3,3), R (3,3), T (3,1), can_bounds (2,3) world AABB."""
    H, W = img.shape[:2] if img is not None else hw
    ray_o, ray_d = get_rays(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3)
    ray_d = ray_d.reshape(-1, 3)
    near, far, mask_at_box = get_near_far(can_bounds, ray_o, ray_d)
    pix_idx = np.nonzero(mask_at_box)[0].astype(np.int32)
    rays = RayBundle(
        ray_o=torch.from_numpy(np.ascontiguousarray(ray_o[mask_at_box])),
        ray_d=torch.from_numpy(np.ascontiguousarray(ray_d[mask_at_box])),
        near=torch.from_numpy(near),
        far=torch.from_numpy(far),
        mask=torch.ones(pix_idx.shape[0], dtype=torch.bool),
    )
    rgb = (img.reshape(-1, 3)[mask_at_box].astype(np.float32)
           if img is not None
           else np.zeros((pix_idx.shape[0], 3), np.float32))
    return EvalRays(rays=rays, pix_idx=pix_idx, rgb=rgb,
                    mask_at_box=mask_at_box)
