"""Offline dynamic-mesh video rendering (counterpart of
transhuman_tpu/viz/mesh_render.py; parity: render_mesh_dynamic.py, the
reference's PyTorch3D rasterization of exported .ply meshes with normal-map
shading along the spherical freeview path).

Two routes, as in the JAX package: ``native/rasterize.cc`` (a CPU z-buffer
in C++, built by ``native/build.py`` on first use), the default, and the
numpy one (``_render_np``, per triangle, slower), held against it by the
tests.  A failed build raises.  The frames are written as PNGs by the
port's ``utils/png.py`` (the JAX package uses OpenCV)."""

from __future__ import annotations

import ctypes
import os
from typing import Sequence

import numpy as np

from ..mesh_ops.ply import load_ply
from ..native import build as native
from ..utils.png import write_png


def render_mesh(verts, tris, K, R, T, hw):
    """Rasterize one mesh.  Returns (rgb (H,W,3) float in [0,1] normal-map
    shaded, depth (H,W))."""
    h, w = hw
    lib = native.library("rasterize")
    v = np.ascontiguousarray(verts, np.float32)
    t = np.ascontiguousarray(tris, np.int64)
    Kf = np.ascontiguousarray(K, np.float32)
    Rf = np.ascontiguousarray(R, np.float32)
    Tf = np.ascontiguousarray(np.reshape(T, 3), np.float32)
    rgb = np.zeros((h, w, 3), np.float32)
    dep = np.zeros((h, w), np.float32)
    rc = lib.rz_render(v.ctypes.data, len(v), t.ctypes.data, len(t),
                       Kf.ctypes.data, Rf.ctypes.data, Tf.ctypes.data, h, w,
                       rgb.ctypes.data, dep.ctypes.data)
    if rc != 0:
        # a failing backend must not ship silent black frames
        raise RuntimeError(f"rz_render returned {rc}")
    return rgb, dep


def _render_np(verts, tris, K, R, T, hw):
    h, w = hw
    cam = verts @ R.T + T
    pix = cam @ K.T
    z = np.where(np.abs(pix[:, 2]) < 1e-8, 1e-8, pix[:, 2])
    uv = pix[:, :2] / z[:, None]
    rgb = np.zeros((h, w, 3), np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)

    e1 = verts[tris[:, 1]] - verts[tris[:, 0]]
    e2 = verts[tris[:, 2]] - verts[tris[:, 0]]
    n = np.cross(e1, e2)
    nl = np.linalg.norm(n, axis=1, keepdims=True)
    ok = nl[:, 0] > 1e-12
    n = np.where(nl > 1e-12, n / np.maximum(nl, 1e-12), 0)
    flip = np.where((n @ R[2]) > 0, -1.0, 1.0)[:, None]
    cols = n * flip * 0.5 + 0.5

    for f in np.nonzero(ok)[0]:
        ia, ib, ic = tris[f]
        za, zb, zc = cam[ia, 2], cam[ib, 2], cam[ic, 2]
        if min(za, zb, zc) <= 1e-6:
            continue
        (ax, ay), (bx, by), (cx, cy) = uv[ia], uv[ib], uv[ic]
        x0 = max(0, int(np.floor(min(ax, bx, cx))))
        x1 = min(w - 1, int(np.ceil(max(ax, bx, cx))))
        y0 = max(0, int(np.floor(min(ay, by, cy))))
        y1 = min(h - 1, int(np.ceil(max(ay, by, cy))))
        if x0 > x1 or y0 > y1:
            continue
        den = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
        if abs(den) < 1e-12:
            continue
        xs, ys = np.meshgrid(np.arange(x0, x1 + 1), np.arange(y0, y1 + 1))
        w1 = ((bx - xs) * (cy - ys) - (cx - xs) * (by - ys)) / den
        w2 = ((cx - xs) * (ay - ys) - (ax - xs) * (cy - ys)) / den
        w3 = 1.0 - w1 - w2
        inside = (w1 >= 0) & (w2 >= 0) & (w3 >= 0)
        zf = 1.0 / (w1 / za + w2 / zb + w3 / zc + 1e-30)
        upd = inside & (zf < zbuf[ys, xs])
        yy, xx = ys[upd], xs[upd]
        zbuf[yy, xx] = zf[upd]
        rgb[yy, xx] = cols[f]
    depth = np.where(np.isinf(zbuf), 0.0, zbuf)
    return rgb, depth


def render_mesh_sequence(ply_paths: Sequence[str], K,
                         w2c_path: Sequence[np.ndarray], hw, out_dir: str):
    """Render each mesh with the matching spherical-path camera; write
    ``mesh<i>.png`` per mesh and return the paths."""
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for i, p in enumerate(ply_paths):
        verts, tris = load_ply(p)
        w2c = w2c_path[i % len(w2c_path)]
        rgb, _ = render_mesh(verts, tris, K, w2c[:3, :3], w2c[:3, 3], hw)
        path = os.path.join(out_dir, f"mesh{i:04d}.png")
        write_png(path, rgb)
        out.append(path)
    return out
