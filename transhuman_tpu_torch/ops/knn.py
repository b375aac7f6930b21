"""Brute-force nearest-neighbour ops, plain PyTorch.

Counterpart of ``transhuman_tpu/ops/knn.py``, with the same arithmetic form
(expanded ``|p|^2 + |r|^2 - 2 p.r`` distances, clamped at 0) so that the CPU
parity tests hold tightly.  These are the plain versions that the CUDA kernels
(kernels/cull.py, kernels/dparf.py) are checked against on the card.
"""

from __future__ import annotations

import torch


def pairwise_dist2(pts, refs):
    """Squared euclidean distances. pts (N,3), refs (R,3) -> (N,R), >= 0."""
    p2 = torch.sum(pts * pts, dim=-1, keepdim=True)
    r2 = torch.sum(refs * refs, dim=-1)
    cross = pts @ refs.T
    return torch.clamp_min(p2 + r2[None, :] - 2.0 * cross, 0.0)


def topk_min(d, k: int):
    """Smallest-k values and indices per row of d (N, C), ascending, ties
    broken to the lowest index (iterative argmin; torch.topk leaves the order
    of ties unspecified)."""
    cur = d.clone()
    rows = torch.arange(d.shape[0], device=d.device)
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmin(cur, dim=-1)
        vals.append(cur[rows, i])
        idxs.append(i)
        cur[rows, i] = float("inf")
    return torch.stack(vals, -1), torch.stack(idxs, -1)


def dparf_dense_weights(d2, k: int, alpha: float, aux=None):
    """Top-k extraction + softmax(-dist/alpha) in one loop over k.

    d2 (N, C) squared distances.  Returns (w_dense (N, C) rows summing to 1
    with k nonzeros, dist (N, k) euclidean ascending, aux_k (N, k, A) =
    aux[idx] or None, w_knn (N, k), idx (N, k) the neighbours).  w_knn is
    the same normalised weight that w_dense scatters, so the token and PE
    aggregations cannot diverge.
    The softmax runs unnormalised against the nearest distance,
    exp(-(d_i - d_0)/alpha) <= 1, and normalises at the end.
    """
    n, _ = d2.shape
    rows = torch.arange(n, device=d2.device)
    cur = d2.clone()
    w_dense = torch.zeros_like(d2)
    u_sum = torch.zeros(n, dtype=d2.dtype, device=d2.device)
    d0 = None
    dists, us, auxs, idxs = [], [], [], []
    for _ in range(k):
        a = torch.argmin(cur, dim=-1)
        idxs.append(a)
        v = cur[rows, a]
        d_i = torch.sqrt(torch.clamp_min(v, 1e-12))
        if d0 is None:
            d0 = d_i
        u = torch.exp(-(d_i - d0) / alpha)
        w_dense[rows, a] += u
        u_sum = u_sum + u
        dists.append(d_i)
        us.append(u)
        if aux is not None:
            auxs.append(aux[a])
        cur[rows, a] = float("inf")
    w_dense = w_dense / u_sum[:, None]
    w_knn = torch.stack(us, -1) / u_sum[:, None]
    aux_k = torch.stack(auxs, dim=1) if aux is not None else None
    return w_dense, torch.stack(dists, -1), aux_k, w_knn, torch.stack(idxs,
                                                                      -1)


def min_dist(pts, refs, ref_block: int = 1024):
    """Distance to the nearest ref per point, (N,).  Blocked over refs so the
    (N, R) matrix never exists whole."""
    best = torch.full(pts.shape[:1], float("inf"), dtype=pts.dtype,
                      device=pts.device)
    for s in range(0, refs.shape[0], ref_block):
        d2 = pairwise_dist2(pts, refs[s:s + ref_block])
        best = torch.minimum(best, d2.min(dim=-1).values)
    return torch.sqrt(best)


def min_excess2(pts, refs, bias2, ref_block: int = 1024):
    """min over refs of (|p - r|^2 - bias2_r), (N,).  ``< 0`` with bias2 =
    r_v^2 is the per-vertex radii cull; bias2 = 0 gives min d^2."""
    best = torch.full(pts.shape[:1], float("inf"), dtype=pts.dtype,
                      device=pts.device)
    for s in range(0, refs.shape[0], ref_block):
        d2 = pairwise_dist2(pts, refs[s:s + ref_block])
        e = d2 - bias2[None, s:s + ref_block]
        best = torch.minimum(best, e.min(dim=-1).values)
    return best
