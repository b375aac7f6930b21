"""Debug helpers (counterpart of transhuman_tpu/utils/debug.py, the
reference's inline hooks): coloured point-cloud dumps
(vis_utils.write_point_cloud) and parameter counting
(base_utils.count_parameters)."""

from __future__ import annotations

import numpy as np
import torch


def save_point_cloud(path: str, xyz, rgb=None):
    """Write an ASCII PLY point cloud of xyz (N, 3); rgb (N, 3) in [0, 255]
    is optional.  The bytes of the JAX package's writer."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    has_c = rgb is not None
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if has_c:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        if has_c:
            rgb = np.clip(np.asarray(rgb), 0, 255).astype(np.uint8)
            for p, c in zip(xyz, rgb):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for p in xyz:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


def param_count(params) -> int:
    """Total parameter count of an ``nn.Module`` (its parameters) or of a
    state dict or nested dict of tensors and arrays (every leaf)."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return int(np.prod(np.shape(params)))
