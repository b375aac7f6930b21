"""Pinhole rays and ray-AABB intersection (host numpy).

The math of transhuman_tpu/geometry/rays.py (reference
``if_nerf_data_utils.py:11-97``), kept in the port so that it runs with numpy
alone: the JAX package's projected-hull shortcut needs OpenCV.  The full
six-plane test here gives the same rays (tests hold the two equal).
"""

from __future__ import annotations

import numpy as np


def get_rays(H: int, W: int, K, R, T):
    """Rays through every pixel: (rays_o, rays_d), each (H, W, 3) float32.
    K (3,3) intrinsics, R (3,3) world->camera, T (3,1); rays_d ends on the
    z = 1 camera plane (not normalised)."""
    rays_o = -np.dot(R.T, T).ravel()
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    xy1 = np.stack([i, j, np.ones_like(i)], axis=2)
    pixel_camera = np.dot(xy1, np.linalg.inv(K).T)
    pixel_world = np.dot(pixel_camera - T.ravel(), R)
    rays_d = pixel_world - rays_o[None, None]
    rays_o = np.broadcast_to(rays_o, rays_d.shape)
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def world_bounds(verts_world: np.ndarray, big_box: bool) -> np.ndarray:
    """Body AABB (2,3): inflated 0.05 m along z, or along all axes when
    big_box."""
    mn = verts_world.min(0).copy()
    mx = verts_world.max(0).copy()
    if big_box:
        mn, mx = mn - 0.05, mx + 0.05
    else:
        mn[2] -= 0.05
        mx[2] += 0.05
    return np.stack([mn, mx])


def get_near_far(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """Ray-AABB near/far by six-plane intersection, the box inflated by
    1 cm; a ray hits when exactly 2 of the 6 plane hits land on the box.

    Returns (near (M,), far (M,), mask_at_box (N,) bool)."""
    bounds = bounds + np.array([-0.01, 0.01])[:, None]
    ray_d = ray_d.copy()
    ray_d[np.abs(ray_d) < 1e-5] = 1e-5
    nominator = bounds[None] - ray_o[:, None]
    d_intersect = (nominator / ray_d[:, None]).reshape(-1, 6)
    p_intersect = d_intersect[..., None] * ray_d[:, None] + ray_o[:, None]
    min_x, min_y, min_z, max_x, max_y, max_z = bounds.ravel()
    eps = 1e-6
    p_mask_at_box = (
        (p_intersect[..., 0] >= (min_x - eps))
        * (p_intersect[..., 0] <= (max_x + eps))
        * (p_intersect[..., 1] >= (min_y - eps))
        * (p_intersect[..., 1] <= (max_y + eps))
        * (p_intersect[..., 2] >= (min_z - eps))
        * (p_intersect[..., 2] <= (max_z + eps))
    )
    mask_at_box = p_mask_at_box.sum(-1) == 2
    p_intervals = p_intersect[mask_at_box][
        p_mask_at_box[mask_at_box]].reshape(-1, 2, 3)
    ray_o_m = ray_o[mask_at_box]
    norm_ray = np.linalg.norm(ray_d[mask_at_box], axis=1)
    d0 = np.linalg.norm(p_intervals[:, 0] - ray_o_m, axis=1) / norm_ray
    d1 = np.linalg.norm(p_intervals[:, 1] - ray_o_m, axis=1) / norm_ray
    near = np.minimum(d0, d1)
    far = np.maximum(d0, d1)
    return near.astype(np.float32), far.astype(np.float32), mask_at_box
