"""Host ray sampling (counterpart of transhuman_tpu/data/ray_sampling.py):
patches and single rays for training, full-frame rays for evaluation; and
the eval item that carries them (counterpart of
transhuman_tpu/data/zju.py::EvalItem).

* Train, patch mode (the default): rays exist only inside the projected-AABB
  bound mask and the ray-AABB hit mask; ``n_patches`` square patches are
  placed, each centred (probability ``subject_ratio``) on a random subject
  pixel, else on a random box-minus-subject pixel; every patch pixel whose
  ray meets the box becomes a ray, its index into the flattened patches in
  ``ray_pixel_idx`` (-1 on padding).
* Train, non-patch (``patch.use_patch_sampling False``): ``n_rays`` single
  rays, ``body_ratio`` of each round from subject pixels, the rest uniform
  over the bound mask, rejection-resampled until every ray meets the box
  (``sample_train_rays_random``).
* Eval: every pixel whose ray meets the inflated body AABB.

The RNG calls are the JAX package's, in its order, so one seed draws the
same patches and rays in both packages.  Rays come back as CPU tensors,
the rest as numpy arrays.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..geometry.rays import (
    get_bound_2d_mask,
    get_near_far,
    get_near_far_hull,
    get_rays_cached,
)
from ..render.pipeline import FrameInputs, RayBundle


def _bundle(ray_o, ray_d, near, far, mask) -> RayBundle:
    """A RayBundle of CPU tensors over the numpy arrays."""
    t = [torch.from_numpy(np.ascontiguousarray(x))
         for x in (ray_o, ray_d, near, far, mask)]
    return RayBundle(*t)


@dataclass
class TrainRays:
    rays: RayBundle  # padded to n_patches * ps^2, CPU tensors
    ray_pixel_idx: np.ndarray  # (R,) int32, -1 on padding
    target_patches: np.ndarray  # (P, ps, ps, 3)
    patch_masks: np.ndarray  # (P, ps, ps) bool: ray-mask pixels per patch
    patch_masks_sub: np.ndarray  # (P, ps, ps) bool: subject pixels per patch
    sub_mask: np.ndarray  # (R,) bool: the ray is on the subject


@dataclass
class RandomTrainRays:
    rays: RayBundle  # R = n_rays (mask False on the rare padding)
    rgb: np.ndarray  # (R, 3) ground-truth colours at the sampled pixels
    coord: np.ndarray  # (R, 2) int32 (y, x) pixel coords


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


def _pick_patch(candidate_mask, ps, H, W, rng):
    """Random patch box centred on a candidate pixel, clipped to the
    image."""
    ys, xs = np.nonzero(candidate_mask)
    i = rng.integers(ys.shape[0])
    x0 = int(np.clip(xs[i] - ps // 2, 0, W - ps))
    y0 = int(np.clip(ys[i] - ps // 2, 0, H - ps))
    return x0, y0


def sample_train_rays(img, msk, K, R, T, can_bounds, rng: np.random.Generator,
                      n_patches: int = 6, patch_size: int = 20,
                      subject_ratio: float = 0.8) -> TrainRays:
    """img (H,W,3) float; msk (H,W) uint8 {0 bg, 1 body, 100 border};
    can_bounds (2,3) world AABB; rng places the patches."""
    H, W = img.shape[:2]
    ps = patch_size
    ray_o, ray_d = get_rays_cached(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3)
    ray_d = ray_d.reshape(-1, 3)

    pose = np.concatenate([R, T.reshape(3, 1)], axis=1)
    bound_mask = get_bound_2d_mask(can_bounds, K, pose, H, W)
    msk_eff = msk * bound_mask  # the mask clipped to the projected AABB

    near_full, far_full, ray_mask = get_near_far_hull(
        can_bounds, ray_o, ray_d, K, R, T, H, W)

    subject_mask = msk_eff > 0
    bbox_not_subject = ray_mask.reshape(H, W) & ~subject_mask

    cap = n_patches * ps * ps
    sel_pix = np.full(cap, -1, np.int64)  # flat H*W pixel index per ray slot
    ray_pixel_idx = np.full(cap, -1, np.int32)
    patch_masks = np.zeros((n_patches, ps, ps), bool)
    patch_masks_sub = np.zeros((n_patches, ps, ps), bool)
    target_patches = np.zeros((n_patches, ps, ps, 3), np.float32)
    n_rays = 0

    for p in range(n_patches):
        if rng.random() < subject_ratio and subject_mask.any():
            cand = subject_mask
        else:
            cand = bbox_not_subject if bbox_not_subject.any() else subject_mask
        if not cand.any():
            cand = np.ones((H, W), bool)
        x0, y0 = _pick_patch(cand, ps, H, W, rng)
        target_patches[p] = img[y0:y0 + ps, x0:x0 + ps]

        in_patch = np.zeros((H, W), bool)
        in_patch[y0:y0 + ps, x0:x0 + ps] = True
        inter = in_patch & ray_mask.reshape(H, W)
        patch_masks[p] = inter[y0:y0 + ps, x0:x0 + ps]
        patch_masks_sub[p] = (in_patch & subject_mask)[y0:y0 + ps,
                                                       x0:x0 + ps]

        pys, pxs = np.nonzero(inter)
        k = pys.shape[0]
        sel_pix[n_rays:n_rays + k] = pys * W + pxs
        ray_pixel_idx[n_rays:n_rays + k] = (
            p * ps * ps + (pys - y0) * ps + (pxs - x0)).astype(np.int32)
        n_rays += k

    valid = sel_pix >= 0
    sel = np.where(valid, sel_pix, 0)
    rays = _bundle(
        ray_o=ray_o[sel].astype(np.float32),
        ray_d=np.where(valid[:, None], ray_d[sel],
                       [[0, 0, 1.0]]).astype(np.float32),
        near=np.where(valid, near_full[sel], 0.0).astype(np.float32),
        far=np.where(valid, far_full[sel], 1e-3).astype(np.float32),
        mask=valid,
    )
    sub_mask = np.zeros(cap, bool)
    sub_mask[valid] = subject_mask.reshape(-1)[sel[valid]]
    return TrainRays(rays=rays, ray_pixel_idx=ray_pixel_idx,
                     target_patches=target_patches, patch_masks=patch_masks,
                     patch_masks_sub=patch_masks_sub, sub_mask=sub_mask)


def sample_train_rays_random(img, msk, K, R, T, can_bounds,
                             rng: np.random.Generator, n_rays: int = 1024,
                             body_ratio: float = 0.5,
                             face_ratio: float = 0.0) -> RandomTrainRays:
    """Non-patch train sampling (the reference's ``sample_ray_h36m`` train
    branch): per round, ``body_ratio`` of the rays still needed come from
    subject pixels (msk == 1), ``face_ratio`` from face pixels (msk == 13,
    which the binarised masks never hold: dead in the reference too), the
    rest uniformly from the bound mask without the border label 100; only
    rays that meet the 3D AABB count, and rounds repeat until exactly
    ``n_rays`` are collected.  After 64 rounds the tail is padded with
    mask-False rays, which the masked MSE drops."""
    H, W = img.shape[:2]
    ray_o, ray_d = get_rays_cached(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3)
    ray_d = ray_d.reshape(-1, 3)
    img_flat = img.reshape(-1, 3)

    pose = np.concatenate([R, T.reshape(3, 1)], axis=1)
    bound_mask = get_bound_2d_mask(can_bounds, K, pose, H, W)
    msk_eff = msk * bound_mask
    bound_mask = bound_mask.copy()
    bound_mask[msk_eff == 100] = 0  # exclude the eroded-border label

    body_pix = np.flatnonzero(msk_eff == 1)
    face_pix = np.flatnonzero(msk_eff == 13)
    rand_pix = np.flatnonzero(bound_mask == 1)

    sel = np.zeros(n_rays, np.int64)
    near_out = np.zeros(n_rays, np.float32)
    far_out = np.full(n_rays, 1e-3, np.float32)
    valid = np.zeros(n_rays, bool)
    n = 0
    for _ in range(64):
        rem = n_rays - n
        if rem <= 0:
            break
        n_body = int(rem * body_ratio)
        n_face = int(rem * face_ratio)
        n_rand = rem - n_body - n_face
        parts = []
        if body_pix.size:
            parts.append(body_pix[rng.integers(0, body_pix.size, n_body)])
        if face_pix.size and n_face:
            parts.append(face_pix[rng.integers(0, face_pix.size, n_face)])
        if rand_pix.size:
            parts.append(rand_pix[rng.integers(0, rand_pix.size, n_rand)])
        if not parts:
            break
        cand = np.concatenate(parts)
        near_, far_, in_box = get_near_far(can_bounds, ray_o[cand],
                                           ray_d[cand])
        k = min(int(in_box.sum()), rem)
        kept = cand[in_box][:k]
        sel[n:n + k] = kept
        near_out[n:n + k] = near_[:k]
        far_out[n:n + k] = far_[:k]
        valid[n:n + k] = True
        n += k

    if n < n_rays:
        print(f"WARNING: ray rejection sampling padded {n_rays - n}/{n_rays} "
              "rays after 64 rounds (degenerate mask/bounds?); these rays "
              "are masked out of the loss")

    rays = _bundle(
        ray_o=ray_o[sel].astype(np.float32),
        ray_d=np.where(valid[:, None], ray_d[sel],
                       [[0, 0, 1.0]]).astype(np.float32),
        near=near_out, far=far_out, mask=valid,
    )
    coord = np.stack([sel // W, sel % W], axis=1).astype(np.int32)
    return RandomTrainRays(
        rays=rays,
        rgb=np.where(valid[:, None], img_flat[sel], 0.0).astype(np.float32),
        coord=coord)


def sample_eval_rays(img, K, R, T, can_bounds, hw=None) -> EvalRays:
    """Every pixel whose ray meets the world AABB.  img (H,W,3), or None
    with hw=(H, W) when no ground truth exists (the serving path); K (3,3),
    R (3,3), T (3,1), can_bounds (2,3)."""
    H, W = img.shape[:2] if img is not None else hw
    ray_o, ray_d = get_rays_cached(H, W, K, R, T)
    ray_o = ray_o.reshape(-1, 3)
    ray_d = ray_d.reshape(-1, 3)
    near_full, far_full, mask_at_box = get_near_far_hull(
        can_bounds, ray_o, ray_d, K, R, T, H, W)
    pix_idx = np.nonzero(mask_at_box)[0].astype(np.int32)
    rays = _bundle(
        ray_o=ray_o[mask_at_box].astype(np.float32),
        ray_d=ray_d[mask_at_box].astype(np.float32),
        near=near_full[mask_at_box].astype(np.float32),
        far=far_full[mask_at_box].astype(np.float32),
        mask=np.ones(pix_idx.shape[0], bool),
    )
    rgb = (img.reshape(-1, 3)[mask_at_box].astype(np.float32)
           if img is not None
           else np.zeros((pix_idx.shape[0], 3), np.float32))
    return EvalRays(rays=rays, pix_idx=pix_idx, rgb=rgb,
                    mask_at_box=mask_at_box)
