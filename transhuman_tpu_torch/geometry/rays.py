"""Pinhole rays and ray-AABB intersection (host numpy).

The math of transhuman_tpu/geometry/rays.py (reference
``if_nerf_data_utils.py:11-97``) with numpy alone: the projected AABB's mask
and the hull shortcut draw with ``data.imgproc.fill_poly`` / ``dilate`` in
place of OpenCV (tests hold each function equal to the JAX package's).
"""

from __future__ import annotations

import numpy as np

from ..utils.cache import ByteLRU


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


def get_bound_corners(bounds: np.ndarray) -> np.ndarray:
    """(2,3) min/max AABB -> (8,3) corners, the reference's order."""
    min_x, min_y, min_z = bounds[0]
    max_x, max_y, max_z = bounds[1]
    return np.array([
        [min_x, min_y, min_z],
        [min_x, min_y, max_z],
        [min_x, max_y, min_z],
        [min_x, max_y, max_z],
        [max_x, min_y, min_z],
        [max_x, min_y, max_z],
        [max_x, max_y, min_z],
        [max_x, max_y, max_z],
    ])


def project(xyz: np.ndarray, K: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """World points -> pixel coords; RT (3,4) [R|T] (base_utils.py:178-187)."""
    xyz = np.dot(xyz, RT[:, :3].T) + RT[:, 3:].T
    xyz = np.dot(xyz, K.T)
    return xyz[:, :2] / xyz[:, 2:]


# the six faces of get_bound_corners' box, as the reference fills them (the
# second closes on corner 5, not 4)
_FACES = ([0, 1, 3, 2, 0], [4, 5, 7, 6, 5], [0, 1, 5, 4, 0], [2, 3, 7, 6, 2],
          [0, 2, 6, 4, 0], [1, 3, 7, 5, 1])


def get_bound_2d_mask(bounds, K, pose, H, W) -> np.ndarray:
    """(H, W) uint8 mask of the projected 3D AABB, its six faces filled
    (if_nerf_data_utils.py:49-62)."""
    from ..data.imgproc import fill_poly

    corners_2d = project(get_bound_corners(bounds), K, pose)
    corners_2d = np.round(corners_2d).astype(int)
    mask = np.zeros((H, W), dtype=np.uint8)
    for face in _FACES:
        fill_poly(mask, corners_2d[face], 1)
    return mask


_RAY_CACHE = ByteLRU(256 * 1024 * 1024)  # one 512x512 grid = 6 MB


def get_rays_cached(H, W, K, R, T):
    """get_rays, LRU-cached by (size, intrinsics, pose): cameras are fixed
    for a dataset.  The arrays are shared and read-only."""
    K = np.asarray(K)
    key = (H, W, K.tobytes(), np.asarray(R).tobytes(),
           np.asarray(T).tobytes())
    hit = _RAY_CACHE.get(key)
    if hit is not None:
        return hit
    return _RAY_CACHE.put(key, get_rays(H, W, K, R, T))


def get_near_far_hull(bounds, ray_o, ray_d, K, R, T, H, W):
    """get_near_far over the full H*W pixel grid, restricted to the rays
    inside the projected hull of the AABB inflated 2 cm, dilated 2 px: the
    same outputs as the dense test for less host work (a ray that meets
    the 1 cm-inflated box projects inside that hull when the box lies in
    front of the camera).  When a corner of the inflated box lies at or
    behind the camera the dense test runs instead.

    Returns (near_full (H*W,), far_full (H*W,), mask (H*W,)), near/far 0
    outside mask."""
    from ..data.imgproc import dilate

    n = H * W
    infl = bounds + np.array([-0.02, 0.02])[:, None]
    corners = get_bound_corners(infl)
    z_cam = (corners @ np.asarray(R).T + np.asarray(T).reshape(1, 3))[:, 2]
    near_full = np.zeros(n, np.float32)
    far_full = np.zeros(n, np.float32)
    if np.any(z_cam < 1e-3):
        near, far, mask = get_near_far(bounds, ray_o, ray_d)
        near_full[mask] = near
        far_full[mask] = far
        return near_full, far_full, mask
    pose = np.concatenate([np.asarray(R), np.asarray(T).reshape(3, 1)],
                          axis=1)
    hull = dilate(get_bound_2d_mask(infl, K, pose, H, W), 5)
    idx = np.nonzero(hull.ravel())[0]
    near_s, far_s, mask_s = get_near_far(bounds, ray_o[idx], ray_d[idx])
    mask = np.zeros(n, bool)
    mask[idx] = mask_s
    sel = idx[mask_s]
    near_full[sel] = near_s
    far_full[sel] = far_s
    return near_full, far_full, mask
