"""K4 wrapper: the forward feature gather, a weighted gather of rows.

``feature_gather_cuda`` launches ``csrc/gather.cu``, which replaces the
Pallas gathers of ``tools/profile_gather_ab.py`` (``pallas_gather``,
``_sp_call``), ``tools/probe_block_gather.py::block_gather``,
``tools/probe_block_gather2.py::make_block_gather``,
``tools/probe_dma_gather.py::gather_a/b/c`` and
``tools/probe_dma_gather2.py::attempt``.  ``feature_gather_plain`` is its
plain PyTorch twin: T indexing gathers and a weighted sum.
``feature_gather`` routes a CUDA tensor to the kernel and a CPU tensor to the
plain twin.

All take src (V, HW, C) float32 rows; ids (V, N) base row ids; w (V, N, T)
tap weights with T = 1 or 4; offsets, T non-negative ints; and return the
(V, N, C) float32 rows out[v, n] = sum_t w[v, n, t] * src[v, ids[v, n] +
offsets[t]].  A negative id gives a zero row and reads nothing; a
non-negative id with a tap outside [0, HW) is refused with IndexError.  The
bilinear feature fetch is the 4-tap form with offsets (0, dx, dy, dy + dx)
(``ops/sampling.py``); the unweighted 1-tap form is ``src[ids]``.  The
adjoint is K3 (``kernels/scatter.py``).
"""

from __future__ import annotations

import torch

from . import build


def _check_taps(name, ids, w, hw: int, offsets):
    """Refuse bad tap counts and ids whose taps leave [0, hw): the kernel
    trusts its ids.  The offsets are >= 0 and a negative id reads nothing,
    so only the largest id can break the range: one reduction, one host
    sync."""
    t = len(offsets)
    if t not in (1, 4) or w.shape[-1] != t:
        raise ValueError(f"{name}: {t} offsets and w {tuple(w.shape)}; want "
                         "1 or 4 taps, one weight each")
    if min(offsets) < 0:
        raise ValueError(f"{name}: offsets {tuple(offsets)} must be >= 0")
    if ids.numel() == 0:
        return
    hi = int(ids.max())
    if hi + max(offsets) >= hw:
        raise IndexError(
            f"{name}: the largest id is {hi}; with taps +{tuple(offsets)} "
            f"every id must lie in [0, {hw})")


def feature_gather_plain(src, ids, w, offsets):
    v, hw, c = src.shape
    offsets = tuple(int(o) for o in offsets)
    _check_taps("feature_gather_plain", ids, w, hw, offsets)
    valid = ids >= 0
    views = torch.arange(v, device=src.device)[:, None]
    out = None
    for t, off in enumerate(offsets):
        idx = torch.where(valid, ids.long() + off, 0)
        row = src[views, idx].float() * w[..., t:t + 1].float()
        out = row if out is None else out + row
    return torch.where(valid[..., None], out, 0.0)


def feature_gather_cuda(src, ids, w, offsets):
    """K4 on CUDA tensors: src and w float32, ids int32, all contiguous."""
    build.check_tensors("feature_gather_cuda", int32=("ids",), src=src,
                        ids=ids, w=w)
    if src.dim() != 3 or ids.dim() != 2 or w.dim() != 3:
        raise ValueError(
            f"feature_gather_cuda: src {tuple(src.shape)}, ids "
            f"{tuple(ids.shape)}, w {tuple(w.shape)}; want (V, HW, C), "
            "(V, N), (V, N, T)")
    v, hw, c = src.shape
    n = ids.shape[1]
    offsets = tuple(int(o) for o in offsets)
    if ids.shape[0] != v or w.shape[:2] != (v, n):
        raise ValueError(
            f"feature_gather_cuda: ids {tuple(ids.shape)}, w "
            f"{tuple(w.shape)}; want ({v}, N), ({v}, N, T)")
    _check_taps("feature_gather_cuda", ids, w, hw, offsets)
    if max(v * hw, v * n) * c >= 2**31:
        raise ValueError("feature_gather_cuda: extent too large for int32")
    out = torch.empty((v, n, c), dtype=torch.float32, device=src.device)
    if n == 0:
        return out
    off4 = offsets + (0,) * (4 - len(offsets))
    lib = build.library()
    with torch.cuda.device(src.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.thp_feature_gather(
            src.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(), v,
            n, c, hw, len(offsets), *off4, stream)
    build.check(code, "feature_gather_cuda")
    feature_gather_cuda.launches += 1
    return out


feature_gather_cuda.launches = 0


def feature_gather(src, ids, w, offsets):
    """K4 for a CUDA tensor, the plain twin for a CPU tensor."""
    if src.is_cuda:
        return feature_gather_cuda(src.contiguous(),
                                   ids.to(torch.int32).contiguous(),
                                   w.float().contiguous(), offsets)
    if src.device.type != "cpu":
        raise ValueError(f"feature_gather: no kernel for device {src.device}")
    return feature_gather_plain(src, ids, w, offsets)
