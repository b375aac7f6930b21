"""K3 wrapper: the d_feat backward of the bilinear feature fetch.

``dfeat_scatter_cuda`` sorts the base texel ids of each view, cuts the runs
of equal ids into segments (one host sync reads their count and the ids'
range) and launches ``csrc/scatter.cu``, which replaces
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

``dfeat_scatter_bf16_cuda`` (its own launch count) is K3's bfloat16 form:
g bf16 rows in, a bf16 map out, equal bit for bit to the float32 form's map
on the widened rows cast once; its plain twin is the float32 twin then one
``.to(torch.bfloat16)``.  ``dfeat_scatter`` routes a bf16 g to it and
returns the map in g's dtype on either route.
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
    """The float32 sums of the widened rows, returned in g's dtype."""
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
    return out.reshape(v, hw, c).to(g.dtype)


SEG = 64  # sorted positions per segment at most: csrc/scatter.cu's SEG


def _dfeat_launch(name, entry, dtype, ids, g, w4, hw, dx, dy):
    """Check the tensors (g of ``dtype``), sort and cut the segments, zero
    the map in g's dtype and launch the K3 entry; the map and whether it
    launched."""
    build.check_tensors(name, {"ids": torch.int32, "g": dtype}, ids=ids, g=g,
                        w4=w4)
    if g.dim() != 3:
        raise ValueError(f"{name}: g {tuple(g.shape)} must be (V, N, C)")
    v, n, c = g.shape
    if ids.shape != (v, n) or w4.shape != (v, n, 4):
        raise ValueError(
            f"{name}: ids {tuple(ids.shape)}, w4 "
            f"{tuple(w4.shape)}; want ({v}, {n}), ({v}, {n}, 4)")
    if not 1 <= v <= 65535 or hw < 1 or min(dx, dy) < 0:
        raise ValueError(
            f"{name}: V={v}, hw={hw}, dx={dx}, dy={dy} out of range")
    if max(v * n, v * hw) * c >= 2**31:
        raise ValueError(f"{name}: extent too large for int32")
    dev = g.device
    if n == 0:
        return torch.zeros((v, hw, c), dtype=dtype, device=dev), False
    # glue, like the JAX package's argsort: equal ids become runs, cut into
    # segments of at most SEG positions; seg_end counts segment starts
    ids_sorted, order = torch.sort(ids, dim=1, stable=True)
    starts = torch.ones_like(ids_sorted, dtype=torch.bool)
    starts[:, 1:] = ids_sorted[:, 1:] != ids_sorted[:, :-1]
    starts[:, ::SEG] = True
    seg_end = starts.reshape(-1).cumsum(0, dtype=torch.int32)
    order = order.to(torch.int32)
    ranges = torch.zeros((v * hw, 2), dtype=torch.int32, device=dev)
    lib = build.library()
    with torch.cuda.device(dev):
        # one host sync: the ends of the sorted rows and the segment count,
        # copied to the host behind an event; the map's zero-fill (the rows
        # no tap touches; the kernel writes the others) is queued after it,
        # so the card fills while the host waits and sizes the scratch
        ends = torch.empty(3, dtype=torch.int32, pin_memory=True)
        ends.copy_(torch.stack([ids_sorted[:, 0].min(),
                                ids_sorted[:, -1].max(), seg_end[-1]]),
                   non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        out = torch.zeros((v, hw, c), dtype=dtype, device=dev)
        ready.synchronize()
        lo, hi, nseg = ends.tolist()
        _check_tap_range(name, lo, hi, hw, dx, dy)
        seg_start = torch.empty(nseg, dtype=torch.int32, device=dev)
        sums = torch.empty((nseg, 4, c), dtype=torch.float32, device=dev)
        code = getattr(lib, entry)(
            ids_sorted.data_ptr(), seg_end.data_ptr(), order.data_ptr(),
            g.data_ptr(), w4.data_ptr(), seg_start.data_ptr(),
            ranges.data_ptr(), sums.data_ptr(), out.data_ptr(), v, n, c, hw,
            dx, dy, nseg, SEG, torch.cuda.current_stream().cuda_stream)
    build.check(code, name)
    return out, True


def dfeat_scatter_cuda(ids, g, w4, hw: int, dx: int, dy: int):
    """K3 on CUDA tensors: ids int32, g and w4 float32, all contiguous.
    No atomics: the same bits on every call."""
    out, launched = _dfeat_launch("dfeat_scatter_cuda", "thp_dfeat_scatter",
                                  torch.float32, ids, g, w4, hw, dx, dy)
    dfeat_scatter_cuda.launches += launched
    return out


dfeat_scatter_cuda.launches = 0


def dfeat_scatter_bf16_cuda(ids, g, w4, hw: int, dx: int, dy: int):
    """K3's bfloat16 form: g bf16 (V, N, C), ids int32, w4 float32 ->
    the (V, hw, C) bf16 map, equal bit for bit to
    ``dfeat_scatter_cuda(ids, g.float(), w4, ...).to(torch.bfloat16)``; no
    atomics, the same bits on every call."""
    out, launched = _dfeat_launch("dfeat_scatter_bf16_cuda",
                                  "thp_dfeat_scatter_bf16", torch.bfloat16,
                                  ids, g, w4, hw, dx, dy)
    dfeat_scatter_bf16_cuda.launches += launched
    return out


dfeat_scatter_bf16_cuda.launches = 0


def dfeat_scatter(ids, g, w4, hw: int, dx: int, dy: int):
    """K3 for a CUDA tensor (its bf16 form for a bf16 g), the four
    index_add_ calls for a CPU tensor; the map in g's dtype."""
    if g.is_cuda:
        fn = (dfeat_scatter_bf16_cuda if g.dtype == torch.bfloat16
              else dfeat_scatter_cuda)
        return fn(ids.to(torch.int32).contiguous(), g.contiguous(),
                  w4.contiguous(), hw, dx, dy)
    if g.device.type != "cpu":
        raise ValueError(f"dfeat_scatter: no kernel for device {g.device}")
    return dfeat_scatter_plain(ids, g, w4, hw, dx, dy)
