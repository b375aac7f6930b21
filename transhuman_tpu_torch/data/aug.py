"""Canonical-SMPL transformation augmentation (cfg.rot_ratio); a copy of
transhuman_tpu/data/aug.py, which the port may not import.

With probability ``rot_ratio`` the SMPL-coordinate vertices rotate by a
uniform angle in [-pi/32, pi/32] in the xz-plane about their mean, then
translate by uniform x/z offsets (+-0.05 / +-0.025 m) (reference
``if_nerf_data_utils.py:660-688``); the identity triple otherwise.  The same
rigid transform hits the sampled points at query time, as in the JAX package
(the reference defines but never calls ``transform_sampling_points``): the
2x2 rotation is packed into a (3, 3) matrix so that

    pts' = (pts - center) @ rot3.T + center + trans

which ``render.pipeline.to_smpl`` applies whenever the frame carries aug
fields (training samples with rot_ratio > 0; eval frames never do).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

ROT_RANGE = np.pi / 32  # if_nerf_data_utils.py:671
X_RANGE = 0.05  # :681
Z_RANGE = 0.025  # :682


def identity_aug() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(center, rot3, trans) leaving points unchanged."""
    return (
        np.zeros(3, np.float32),
        np.eye(3, dtype=np.float32),
        np.zeros(3, np.float32),
    )


def transform_can_smpl(
    xyz: np.ndarray, rng: np.random.Generator, rot_ratio: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """xyz (N, 3) SMPL-coord verts -> (xyz_aug, center, rot3, trans).

    The reference's 2x2 rotation ``[[c, -s], [s, c]]`` acting on the
    ``[0, 2]`` columns embeds into rot3 so that ``xyz @ rot3.T`` reproduces
    ``xyz[:, [0, 2]] @ rot2.T`` with y untouched.
    """
    center, rot3, trans = identity_aug()
    if rng.uniform() > rot_ratio:
        return xyz, center, rot3, trans
    t = rng.uniform(-ROT_RANGE, ROT_RANGE)
    c, s = np.float32(np.cos(t)), np.float32(np.sin(t))
    rot3 = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
    center = xyz.mean(axis=0).astype(np.float32)
    trans = np.array(
        [rng.uniform(-X_RANGE, X_RANGE), 0.0, rng.uniform(-Z_RANGE, Z_RANGE)],
        np.float32,
    )
    xyz = (xyz - center) @ rot3.T + center + trans
    return xyz.astype(np.float32), center, rot3, trans
