"""Mesh -> occupancy voxel grid (a copy of transhuman_tpu/tools/
voxelize_mesh.py; parity: lib/utils/light_stage/ply_to_occupancy.py, the
reference's offline tool producing occupancy volumes from exported .ply
meshes).

    python -m transhuman_tpu_torch.tools.voxelize_mesh in.ply out.npy \
        --voxel 0.005

Method: sample points densely on every triangle, mark their voxels as
surface, then flood-fill the outside from the grid boundary; occupancy =
interior + surface.
"""

from __future__ import annotations

import numpy as np


def voxelize(verts: np.ndarray, tris: np.ndarray, voxel: float = 0.005, pad: int = 2):
    """Returns (occupancy (X,Y,Z) uint8, origin (3,))."""
    lo = verts.min(0) - pad * voxel
    hi = verts.max(0) + pad * voxel
    dims = np.maximum(np.ceil((hi - lo) / voxel).astype(int) + 1, 1)
    occ = np.zeros(dims, np.uint8)

    # surface: supersample each triangle with enough points per voxel
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    edge = np.maximum(
        np.linalg.norm(b - a, axis=1), np.linalg.norm(c - a, axis=1)
    )
    n_side = np.clip(np.ceil(edge / (0.5 * voxel)).astype(int), 1, 64)
    for n in np.unique(n_side):
        sel = n_side == n
        if not sel.any():
            continue
        u = np.linspace(0, 1, n + 1)
        uu, vv = np.meshgrid(u, u)
        m = uu + vv <= 1.0
        uu, vv = uu[m], vv[m]
        pts = (
            a[sel][:, None] * (1 - uu - vv)[None, :, None]
            + b[sel][:, None] * uu[None, :, None]
            + c[sel][:, None] * vv[None, :, None]
        ).reshape(-1, 3)
        idx = np.clip(((pts - lo) / voxel).astype(int), 0, dims - 1)
        occ[idx[:, 0], idx[:, 1], idx[:, 2]] = 1

    # flood fill the exterior: 6-connected frontier dilation, fully
    # vectorized (the previous per-voxel Python BFS took minutes on the
    # ~7M-cell grids a human mesh yields at voxel=0.005); each pass expands
    # the outside region one step along every axis until fixpoint —
    # O(grid diameter) array passes instead of O(cells) Python iterations
    free = occ == 0
    outside = np.zeros(dims, bool)
    # seed: every free boundary cell
    for axis in range(3):
        sl0 = [slice(None)] * 3
        sl1 = [slice(None)] * 3
        sl0[axis] = 0
        sl1[axis] = dims[axis] - 1
        outside[tuple(sl0)] |= free[tuple(sl0)]
        outside[tuple(sl1)] |= free[tuple(sl1)]
    while True:
        grown = outside.copy()
        grown[1:, :, :] |= outside[:-1, :, :]
        grown[:-1, :, :] |= outside[1:, :, :]
        grown[:, 1:, :] |= outside[:, :-1, :]
        grown[:, :-1, :] |= outside[:, 1:, :]
        grown[:, :, 1:] |= outside[:, :, :-1]
        grown[:, :, :-1] |= outside[:, :, 1:]
        grown &= free
        if (grown == outside).all():
            break
        outside = grown

    occupancy = (~outside).astype(np.uint8)
    return occupancy, lo


def main(argv=None) -> str:
    """Writes np.save({occupancy, origin, voxel}) to the output path and
    returns it."""
    import argparse

    from ..mesh_ops.ply import load_ply

    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.voxelize_mesh")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--voxel", type=float, default=0.005)
    args = p.parse_args(argv)
    verts, tris = load_ply(args.input)
    occ, origin = voxelize(verts, tris, args.voxel)
    np.save(args.output, {"occupancy": occ, "origin": origin, "voxel": args.voxel})
    print(f"wrote {args.output}: grid {occ.shape}, filled {int(occ.sum())}")
    return args.output


if __name__ == "__main__":
    main()
