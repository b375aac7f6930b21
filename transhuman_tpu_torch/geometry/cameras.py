"""Camera utilities: world<->SMPL transforms and the spherical freeview path
(a copy of transhuman_tpu/geometry/cameras.py, which the port may not
import).

Reimplements the math of the reference's `lib/utils/render_utils.py:239-364`
(load_cam / gen_path_virt) and the world<->SMPL coordinate maps used throughout
(`if_clight_renderer.py:289-304`, `can_smpl.py:304-313`).
"""

from __future__ import annotations

import numpy as np


def world2smpl(pts: np.ndarray, Rh: np.ndarray, Th: np.ndarray) -> np.ndarray:
    """World -> SMPL coords: (x - Th) @ Rh.  Rh: (3,3) rotation (from Rodrigues
    of the params' axis-angle), Th: (1,3) or (3,)."""
    return (pts - np.reshape(Th, (1, 3))) @ Rh


def smpl2world(pts: np.ndarray, Rh: np.ndarray, Th: np.ndarray) -> np.ndarray:
    return pts @ np.linalg.inv(Rh) + np.reshape(Th, (1, 3))


def _normalize(x):
    return x / np.linalg.norm(x)


def _normalize_rows(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def load_cam(ann_file: str, ratio: float = 0.5):
    """Load camera K/RT lists from a ZJU-MoCap annots.npy
    (render_utils.load_cam, render_utils.py:239-260)."""
    annots = np.load(ann_file, allow_pickle=True).item()
    cams = annots["cams"]
    K, RT = [], []
    lower_row = np.array([[0.0, 0.0, 0.0, 1.0]])
    for i in range(len(cams["K"])):
        k = np.array(cams["K"][i]).astype(np.float64).copy()
        k[:2] = k[:2] * ratio
        K.append(k)
        r = np.array(cams["R"][i])
        t = np.array(cams["T"][i]) / 1000.0
        RT.append(np.concatenate([np.concatenate([r, t], 1), lower_row], 0))
    return K, RT


def gen_path_virt(RT, render_views: int, center=None):
    """360-degree spherical w2c path around the subject.

    Output-equal reimplementation of `render_utils.gen_path_virt`
    (render_utils.py:318-364) — the path must match for freeview-video
    parity (golden test: tests/golden/gen_path_virt.npz).  Geometry: from
    the input w2c extrinsics, build an average "rig" frame whose first axis
    is the mean camera up; place `render_views` cameras on an ellipse (radii
    = 80th-percentile camera spread * 1.3) in that frame's Y/Z plane, each
    looking at a pivot offset `z_off` along the rig's up axis; convert each
    look-at c2w to OpenCV-convention w2c.
    """
    # c2w in "viewmatrix" column convention [down, right, -forward, pos]
    c2w_in = np.linalg.inv(np.asarray(RT, dtype=np.float64))
    cams = np.concatenate(
        [c2w_in[:, :, 1:2], c2w_in[:, :, 0:1], -c2w_in[:, :, 2:3],
         c2w_in[:, :, 3:4]], 2
    )
    up = _normalize(cams[:, :3, 0].sum(0))
    z0 = _normalize(cams[0, :3, 2])
    vec1 = _normalize(np.cross(z0, up))
    vec2 = _normalize(np.cross(up, vec1))
    z_off = 0.0
    if center is None:
        center = cams[:, :3, 3].mean(0)
        z_off = 1.3  # pivot raised along `up` so the path looks slightly down
    rig = np.stack([up, vec1, vec2, center], 1)  # (3, 4) rig frame

    # per-axis camera spread in the rig frame -> ellipse radii
    tt = (cams[:, :3, 3] - rig[:, 3]) @ rig[:3, :3]
    rads = np.percentile(np.abs(tt), 80, axis=0) * 1.3

    theta = np.linspace(0.0, 2 * np.pi, render_views + 1)[:-1]
    ring = np.stack(
        [np.zeros_like(theta), np.sin(theta), np.cos(theta)], 1
    ) * rads  # (views, 3) rig coords
    pos = ring @ rig[:3, :3].T + rig[:, 3]  # (views, 3) world
    pivot = rig[:, 3] + z_off * rig[:, 0]
    fwd = _normalize_rows(pos - pivot)

    # look-at basis per view, matching the reference's `viewmatrix`
    # (render_utils.py:225-231): vec1 = normalize(cross(fwd, up_hint)),
    # vec0 = normalize(cross(vec1, fwd)).  With right := cross(up, fwd)
    # that is vec1 = -right, vec0 = cross(fwd, right) = vup.
    right = _normalize_rows(np.cross(up, fwd))
    vup = _normalize_rows(np.cross(fwd, right))
    # column shuffle [1,0,-2,3] of [vec0, vec1, fwd, pos] -> OpenCV c2w
    # columns x = vec1 = -right, y = vec0 = vup, z = -fwd; then invert rigidly
    rot_c2w = np.stack([-right, vup, -fwd], 2)  # (views, 3, 3)
    w2c = np.zeros((render_views, 4, 4))
    w2c[:, :3, :3] = np.transpose(rot_c2w, (0, 2, 1))
    w2c[:, :3, 3] = -np.einsum("vij,vj->vi", w2c[:, :3, :3], pos)
    w2c[:, 3, 3] = 1.0
    return list(w2c)
