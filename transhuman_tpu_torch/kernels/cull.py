"""K1 wrapper: the SMPL-proximity cull, ``min_j (|p - r_j|^2 - b_j)``.

``min_excess2_cuda`` launches ``csrc/cull.cu`` (which replaces
``transhuman_tpu/experiments/cull.py::min_dist2_fused``); ``min_excess2_plain``
is its plain PyTorch twin.  ``min_excess2`` routes a CUDA tensor to the
kernel and a CPU tensor to the plain form, and nothing else: a kernel that
fails to build or launch raises.  The render path culls with
``shell_cull`` (zero bias, the uniform cull_distance shell) or
``radii_cull`` (bias r_v^2, the per-vertex radii of ``cull_radii``).
"""

from __future__ import annotations

import torch

from ..ops import knn
from . import build


def min_excess2_plain(pts, refs, bias2):
    """Plain twin of the kernel: blocked expanded-form distances."""
    return knn.min_excess2(pts, refs, bias2)


def min_excess2_cuda(pts, refs, bias2):
    """pts (N,3), refs (M,3), bias2 (M,) float32 CUDA -> (N,) via K1."""
    build.check_tensors("min_excess2_cuda", pts=pts, refs=refs, bias2=bias2)
    n, m = pts.shape[0], refs.shape[0]
    if pts.shape != (n, 3) or refs.shape != (m, 3) or bias2.shape != (m,):
        raise ValueError(
            f"min_excess2_cuda: shapes {tuple(pts.shape)}, {tuple(refs.shape)}"
            f", {tuple(bias2.shape)}; want (N,3), (M,3), (M,)"
        )
    if n >= 2**31 // 3 or m >= 2**31 // 3:
        raise ValueError("min_excess2_cuda: extent too large for int32")
    out = torch.empty(n, dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    lib = build.library()
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.thp_min_excess2(pts.data_ptr(), refs.data_ptr(),
                                   bias2.data_ptr(), out.data_ptr(), n, m,
                                   stream)
    build.check(code, "min_excess2_cuda")
    min_excess2_cuda.launches += 1
    return out


min_excess2_cuda.launches = 0


def min_excess2(pts, refs, bias2):
    """(N,) min over refs of |p - r|^2 - bias2_r: K1 on the card, its plain
    twin on the CPU."""
    if pts.is_cuda:
        return min_excess2_cuda(pts, refs, bias2)
    if pts.device.type != "cpu":
        raise ValueError(f"min_excess2: no kernel for device {pts.device}")
    return min_excess2_plain(pts, refs, bias2)


def radii_cull(pts, verts, radii):
    """(N,) bool: some vertex v lies closer to the point than its radius
    r_v, as min_j(|p - v_j|^2 - r_j^2) < 0 (the JAX package's
    ``min_excess2`` branch of ``_cull``); radii (Nv,) float32."""
    return min_excess2(pts, verts, radii * radii) < 0.0


def shell_cull(pts, verts, cull_distance: float):
    """(N,) bool: the point lies closer than cull_distance to some vertex.

    On the card: K1 with zero bias, compared as d^2 < c^2.  On the CPU: the
    JAX package's exact form, sqrt(min d^2) < c (transhuman_tpu
    render/pipeline.py::_cull), so that the CPU parity is tight; the two
    predicates differ only for points within rounding of the threshold.
    """
    if pts.is_cuda:
        zeros = torch.zeros(verts.shape[0], dtype=torch.float32,
                            device=verts.device)
        return min_excess2_cuda(pts, verts, zeros) < cull_distance**2
    if pts.device.type != "cpu":
        raise ValueError(f"shell_cull: no kernel for device {pts.device}")
    return knn.min_dist(pts, verts) < cull_distance
