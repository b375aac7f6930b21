"""K3 wrapper: the d_feat backward of the bilinear feature fetch.

``dfeat_scatter_cuda`` sorts the base texel ids of each view and launches
``csrc/scatter.cu``, which replaces
``transhuman_tpu/experiments/streamscatter.py::dfeat_scatter_sorted``.
``dfeat_scatter_plain`` is its plain PyTorch twin: four ``index_add_``
calls, the same sum as the XLA path of the JAX package's sampling backward
(``transhuman_tpu/ops/sampling.py::_sfm_bwd``).  ``dfeat_scatter`` routes a
CUDA tensor to the kernel and a CPU tensor to the plain twin.

All take ids (V, N) base texel ids, pre-clamped so that every tap id
ids + {0, dx, dy, dy + dx} lies in [0, hw) (both routes raise IndexError
otherwise); g (V, N, C) cotangent rows;
w4 (V, N, 4) tap weights ((1-wx)(1-wy), wx(1-wy), (1-wx)wy, wx wy); and
return the (V, hw, C) float32 map out[v, ids + tap] += w4[..., tap] * g.
"""

from __future__ import annotations

import torch

from . import build


def _check_tap_range(name, lo: int, hi: int, hw: int, dx: int, dy: int):
    """Refuse base ids in [lo, hi] with a tap outside [0, hw): the kernel
    trusts its ids, and the plain twin's flattened views would carry such a
    tap into the neighbouring view's map."""
    if lo < 0 or hi + dx + dy >= hw:
        raise IndexError(
            f"{name}: base ids span [{lo}, {hi}]; with taps +{dx}, +{dy} "
            f"they must lie in [0, {hw})")


def dfeat_scatter_plain(ids, g, w4, hw: int, dx: int, dy: int):
    v, n, c = g.shape
    if ids.numel():
        _check_tap_range("dfeat_scatter_plain", int(ids.min()),
                         int(ids.max()), hw, dx, dy)
    out = torch.zeros((v * hw, c), dtype=torch.float32, device=g.device)
    flat = (ids.long() + hw * torch.arange(v, device=g.device)[:, None])
    flat = flat.reshape(v * n)
    rows = g.reshape(v * n, c).float()
    w = w4.reshape(v * n, 4).float()
    for col, off in enumerate((0, dx, dy, dy + dx)):
        out.index_add_(0, flat + off, rows * w[:, col:col + 1])
    return out.reshape(v, hw, c)


def dfeat_scatter_cuda(ids, g, w4, hw: int, dx: int, dy: int):
    """K3 on CUDA tensors: ids int32, g and w4 float32, all contiguous."""
    build.check_tensors("dfeat_scatter_cuda", int32=("ids",), ids=ids, g=g,
                        w4=w4)
    if g.dim() != 3:
        raise ValueError(
            f"dfeat_scatter_cuda: g {tuple(g.shape)} must be (V, N, C)")
    v, n, c = g.shape
    if ids.shape != (v, n) or w4.shape != (v, n, 4):
        raise ValueError(
            f"dfeat_scatter_cuda: ids {tuple(ids.shape)}, w4 "
            f"{tuple(w4.shape)}; want ({v}, {n}), ({v}, {n}, 4)")
    if not 1 <= v <= 65535 or hw < 1 or min(dx, dy) < 0:
        raise ValueError(
            f"dfeat_scatter_cuda: V={v}, hw={hw}, dx={dx}, dy={dy} out of "
            "range")
    if max(v * n, hw) * c >= 2**31:
        raise ValueError("dfeat_scatter_cuda: extent too large for int32")
    out = torch.zeros((v, hw, c), dtype=torch.float32, device=g.device)
    if n == 0:
        return out
    # glue, like the JAX package's argsort: equal ids become runs
    ids_sorted, order = torch.sort(ids, dim=1, stable=True)
    # one host sync: the ends of the sorted rows
    lo, hi = torch.stack([ids_sorted[:, 0].min(),
                          ids_sorted[:, -1].max()]).tolist()
    _check_tap_range("dfeat_scatter_cuda", lo, hi, hw, dx, dy)
    order = order.to(torch.int32)
    lib = build.library()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.thp_dfeat_scatter(
            ids_sorted.data_ptr(), order.data_ptr(), g.data_ptr(),
            w4.data_ptr(), out.data_ptr(), v, n, c, hw, dx, dy, stream)
    build.check(code, "dfeat_scatter_cuda")
    dfeat_scatter_cuda.launches += 1
    return out


dfeat_scatter_cuda.launches = 0


def dfeat_scatter(ids, g, w4, hw: int, dx: int, dy: int):
    """K3 for a CUDA tensor, the four index_add_ calls for a CPU tensor."""
    if g.is_cuda:
        return dfeat_scatter_cuda(ids.to(torch.int32).contiguous(),
                                  g.contiguous(), w4.contiguous(), hw, dx,
                                  dy)
    if g.device.type != "cpu":
        raise ValueError(f"dfeat_scatter: no kernel for device {g.device}")
    return dfeat_scatter_plain(ids, g, w4, hw, dx, dy)
