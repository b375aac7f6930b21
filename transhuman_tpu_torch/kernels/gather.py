"""K4 wrappers: the forward feature gather, a weighted gather of rows.

``feature_gather_cuda`` and ``feature_sample_cuda`` launch the two forms of
``csrc/gather.cu``, which replaces the Pallas gathers of
``tools/profile_gather_ab.py`` (``pallas_gather``, ``_sp_call``),
``tools/probe_block_gather.py::block_gather``,
``tools/probe_block_gather2.py::make_block_gather``,
``tools/probe_dma_gather.py::gather_a/b/c`` and
``tools/probe_dma_gather2.py::attempt``.  ``feature_gather_plain`` and
``feature_sample_plain`` are their plain PyTorch twins; ``feature_gather``
and ``feature_sample`` route a CUDA tensor to the kernel and a CPU tensor to
the twin.  Both forms count their launches under ``feature_gather_cuda``.

The id form takes src (V, HW, C) float32 rows; ids (V, N) base row ids;
w (V, N, T) tap weights with T = 1 or 4; offsets, T non-negative ints; and
returns the (V, N, C) float32 rows out[v, n] = sum_t w[v, n, t] * src[v,
ids[v, n] + offsets[t]].  A negative id gives a zero row and reads nothing;
a non-negative id with a tap outside [0, HW) is refused with IndexError.
The unweighted 1-tap form is ``src[ids]``.

The sampling form is the bilinear fetch of ``ops/sampling.py``: the 4-tap
form on the taps and weights that ``_sample_taps`` and ``_bilinear_w4``
derive from image coordinates uv (V, N, 2), which the kernel derives itself
with the same float32 operations (both live here, beside the kernel that
must match them bit for bit); its base texels lie in the map by
construction, so it checks nothing and never waits for the card.  The
adjoint of both is K3 (``kernels/scatter.py``).

The sampling form has a bfloat16 form, ``feature_sample_bf16_cuda`` (its
own launch count): a bf16 map in, bf16 rows out, the float32 form's sums on
the widened map narrowed once, so its plain twin is the float32 twin on the
widened map, then one ``.to(torch.bfloat16)``.  ``feature_sample`` routes a
bf16 map to it.
"""

from __future__ import annotations

import torch

from . import build


def _sample_taps(shape, uv, image_shape):
    """For feature maps of shape (V, Hf, Wf, C): (fx, fy) unclamped
    feature-pixel coordinates, base (V,N) texel ids, weights wx, wy (V,N)
    relative to the (possibly clamped) base texel, and the tap offsets dx,
    dy.  K4's sampling form (csrc/gather.cu) repeats these float32
    operations in this order."""
    v, hf, wf, c = shape
    h_img, w_img = image_shape
    fx = uv[..., 0] * (wf / w_img)
    fy = uv[..., 1] * (hf / h_img)
    cx = torch.clamp(fx, 0.0, wf - 1)
    cy = torch.clamp(fy, 0.0, hf - 1)
    x0 = torch.floor(cx).long()
    y0 = torch.floor(cy).long()
    if wf > 1:
        x0 = torch.clamp_max(x0, wf - 2)
    if hf > 1:
        y0 = torch.clamp_max(y0, hf - 2)
    wx = cx - x0.to(cx.dtype)
    wy = cy - y0.to(cy.dtype)
    dx = 1 if wf > 1 else 0
    dy = wf if hf > 1 else 0
    return fx, fy, y0 * wf + x0, wx, wy, dx, dy


def _bilinear_w4(wx, wy):
    """(V,N,4) weights of the taps base + (0, dx, dy, dy + dx)."""
    return torch.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy,
                        wx * wy], dim=-1)


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
    """K4's id form on CUDA tensors: src and w float32, ids int32, all
    contiguous."""
    build.check_tensors("feature_gather_cuda", {"ids": torch.int32},
                        src=src, ids=ids, w=w)
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
    """K4's id form for a CUDA tensor, the plain twin for a CPU tensor."""
    if src.is_cuda:
        return feature_gather_cuda(src.contiguous(),
                                   ids.to(torch.int32).contiguous(),
                                   w.float().contiguous(), offsets)
    if src.device.type != "cpu":
        raise ValueError(f"feature_gather: no kernel for device {src.device}")
    return feature_gather_plain(src, ids, w, offsets)


def feature_sample_plain(feat, uv, image_shape):
    """The bilinear fetch as the port's CPU route computes it: the taps and
    weights of _sample_taps and _bilinear_w4, then the 4-tap plain gather,
    in float32 on the widened map; a bf16 map gives those rows narrowed
    once (the bf16 form's twin)."""
    v, hf, wf, c = feat.shape
    _, _, base, wx, wy, dx, dy = _sample_taps(feat.shape, uv, image_shape)
    out = feature_gather_plain(feat.reshape(v, hf * wf, c), base,
                               _bilinear_w4(wx, wy), (0, dx, dy, dy + dx))
    return out.to(feat.dtype)


def _sample_launch(name, entry, dtype, feat, uv, image_shape):
    """Check the tensors (feat of ``dtype``), allocate the (V, N, C) rows in
    it and launch the sampling-form entry; True if it launched."""
    build.check_tensors(name, {"feat": dtype}, feat=feat, uv=uv)
    if feat.dim() != 4 or uv.dim() != 3 or uv.shape[::2] != (feat.shape[0],
                                                             2):
        raise ValueError(
            f"{name}: feat {tuple(feat.shape)}, uv "
            f"{tuple(uv.shape)}; want (V, Hf, Wf, C), (V, N, 2)")
    v, hf, wf, c = feat.shape
    n = uv.shape[1]
    h_img, w_img = image_shape
    if max(v * hf * wf, v * n) * c >= 2**31:
        raise ValueError(f"{name}: extent too large for int32")
    out = torch.empty((v, n, c), dtype=feat.dtype, device=feat.device)
    if n == 0:
        return out, False
    # ctypes rounds the scales to float32, as torch rounds a Python scalar
    # multiplying a float32 tensor
    lib = build.library()
    with torch.cuda.device(feat.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = getattr(lib, entry)(
            feat.data_ptr(), uv.data_ptr(), out.data_ptr(), v, n, c, hf, wf,
            wf / w_img, hf / h_img, stream)
    build.check(code, name)
    return out, True


def feature_sample_cuda(feat, uv, image_shape):
    """K4's sampling form on CUDA tensors: feat (V, Hf, Wf, C) and uv
    (V, N, 2), float32, contiguous.  One launch; no host sync."""
    out, launched = _sample_launch("feature_sample_cuda",
                                   "thp_feature_sample", torch.float32, feat,
                                   uv, image_shape)
    feature_gather_cuda.launches += launched
    return out


def feature_sample_bf16_cuda(feat, uv, image_shape):
    """K4's sampling form for a bfloat16 map: feat (V, Hf, Wf, C) bf16, uv
    (V, N, 2) float32, contiguous CUDA tensors -> (V, N, C) bf16, equal bit
    for bit to ``feature_sample_cuda(feat.float(), uv,
    image_shape).to(torch.bfloat16)``.  One launch; no host sync."""
    out, launched = _sample_launch("feature_sample_bf16_cuda",
                                   "thp_feature_sample_bf16", torch.bfloat16,
                                   feat, uv, image_shape)
    feature_sample_bf16_cuda.launches += launched
    return out


feature_sample_bf16_cuda.launches = 0


def feature_sample(feat, uv, image_shape):
    """K4's sampling form for a CUDA tensor (the bf16 form for a bf16 map),
    the plain twin for a CPU tensor: feat (V, Hf, Wf, C), uv (V, N, 2) image
    pixels, image_shape (H_img, W_img) -> (V, N, C) in feat's dtype."""
    if feat.is_cuda:
        fn = (feature_sample_bf16_cuda if feat.dtype == torch.bfloat16
              else feature_sample_cuda)
        return fn(feat.contiguous(), uv.contiguous(), image_shape)
    if feat.device.type != "cpu":
        raise ValueError(f"feature_sample: no kernel for device {feat.device}")
    return feature_sample_plain(feat, uv, image_shape)
