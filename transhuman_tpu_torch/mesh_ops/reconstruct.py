"""Mesh reconstruction: density grid -> iso-surface -> world mesh
(counterpart of transhuman_tpu/mesh_ops/reconstruct.py).

The reference mesh workload (`lib/networks/renderer/if_mesh_renderer.py:
46-113` + the grid of `can_smpl_mesh.py:78-95`): a dense voxel grid over the
world box (voxel 0.005 m), the density of every grid point with the SMPL
cull (``RenderPipeline.render_sigma``), a 10-voxel zero pad, the iso-surface
at ``mesh_th`` (20) and the index -> world transform.  The JAX package's
bucket padding, compaction capacity and its overflow recovery have no job
here: the port's compaction is dynamic.
"""

from __future__ import annotations

import numpy as np
import torch

from .marching import marching_tetrahedra


def make_grid(can_bounds: np.ndarray, voxel_size) -> np.ndarray:
    """(X, Y, Z, 3) float32 world-coordinate grid points (the arange of
    can_smpl_mesh.py:78-86, whose upper bound is one voxel past the box)."""
    vs = np.asarray(voxel_size, np.float32)
    axes = [
        np.arange(can_bounds[0, i], can_bounds[1, i] + vs[i], vs[i],
                  dtype=np.float32)
        for i in range(3)
    ]
    return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)


def extract_mesh(pipe, frame, can_bounds: np.ndarray,
                 voxel_size=(0.005, 0.005, 0.005), mesh_th: float = 20.0,
                 pad_voxels: int = 10):
    """(vertices_world (N,3) float32, triangles (M,3) int64, cube): cube is
    the zero-padded (X+2p, Y+2p, Z+2p) sigma grid, on the host.  frame is a
    FrameInputs on any device; the density runs on ``pipe.device``."""
    grid = make_grid(can_bounds, voxel_size)
    gx, gy, gz, _ = grid.shape
    pts = torch.from_numpy(grid.reshape(-1, 3)).to(pipe.device)
    sigma = pipe.render_sigma(frame.to(pipe.device), pts)
    sigma = sigma.cpu().numpy().reshape(gx, gy, gz)

    cube = np.pad(sigma, pad_voxels, mode="constant")
    verts_idx, tris = marching_tetrahedra(cube, mesh_th)
    lb = can_bounds[0] - pad_voxels * np.asarray(voxel_size)
    verts_world = (verts_idx * np.asarray(voxel_size, np.float32)
                   + lb.astype(np.float32))
    return verts_world, tris, cube
