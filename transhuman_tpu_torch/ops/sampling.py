"""Camera projection and bilinear feature-map sampling with its backward.

Counterpart of ``transhuman_tpu/ops/sampling.py``: the reference's
``F.grid_sample(align_corners=True, padding_mode="border")`` written directly
in feature-pixel space.  uv is scaled to feature pixels on each axis (x by W,
y by H), clamped to [0, size-1], the base texel is clamped to size-2, and the
2x2 patch is interpolated.  ``sample_feature_map`` is an autograd Function
like the JAX package's ``custom_vjp``.  Its forward is K4's sampling form
(kernels/gather.py): on the card one launch from uv to features, with no
prelude and no host sync.  Its d_feat is the K3 scatter (kernels/scatter.py),
K4's adjoint, on the taps the backward recomputes from the saved uv; each
runs its kernel on the card and its plain twin on the CPU.  Its d_uv is
plain PyTorch.

``sample_half_pixel`` and ``depth_visibility`` are the depth-map mode's
vertex visibility (half-pixel, zero-padded sampling of each view's depth
map at the vertices' projections), plain PyTorch as the JAX package's are
plain JAX.
"""

from __future__ import annotations

import torch

from ..kernels import gather
from ..kernels.gather import _bilinear_w4, _sample_taps
from ..kernels.scatter import dfeat_scatter


def project_points(xyz, K, R, T):
    """World points -> (uv (V,N,2) pixels, z_cam (V,N)).

    xyz (N,3) or (V,N,3); K, R (V,3,3); T (V,3) or (V,3,1).  |z| < 1e-6 is
    clamped away from 0, so a point on a camera's principal plane projects
    far outside the image instead of to NaN.
    """
    T = T.reshape(T.shape[0], 3)
    if xyz.dim() == 2:
        cam = torch.einsum("vab,nb->vna", R, xyz) + T[:, None, :]
    else:
        cam = torch.einsum("vab,vnb->vna", R, xyz) + T[:, None, :]
    pix = torch.einsum("vab,vnb->vna", K, cam)
    z = pix[..., 2:3]
    z_safe = torch.where(
        z.abs() < 1e-6,
        torch.where(z < 0, torch.full_like(z, -1e-6), torch.full_like(z, 1e-6)),
        z,
    )
    return pix[..., :2] / z_safe, cam[..., 2]


def _gather4(feat, base, dx, dy):
    """The four tap rows (V,N,C) each at base + {0, dx, dy, dy + dx}."""
    v, hf, wf, c = feat.shape
    flat = feat.reshape(v, hf * wf, c)
    views = torch.arange(v, device=feat.device)[:, None]
    return [flat[views, base + off] for off in (0, dx, dy, dy + dx)]


class _SampleFeatureMap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, uv, image_shape):
        out = gather.feature_sample(feat, uv, image_shape)
        # the backward recomputes the taps from uv (_sample_taps gives the
        # kernel's taps); it needs feat only for d_uv.  Without a gradient
        # asked for, nothing is saved
        if any(ctx.needs_input_grad):
            ctx.meta = (feat.shape, feat.dtype, image_shape)
            ctx.save_for_backward(
                uv, feat if ctx.needs_input_grad[1] else None)
        return out

    @staticmethod
    def backward(ctx, g):
        uv, feat = ctx.saved_tensors
        shape, fdtype, (h_img, w_img) = ctx.meta
        v, hf, wf, c = shape
        fx, fy, base, wx, wy, dx, dy = _sample_taps(shape, uv, (h_img, w_img))
        d_feat = d_uv = None
        if ctx.needs_input_grad[0]:
            # g in the map's dtype: K3's bf16 form sums a bf16 g in float32
            # and writes the bf16 map; the plain twin sums in float32
            d_feat = dfeat_scatter(base, g, _bilinear_w4(wx, wy).float(),
                                   hf * wf, dx, dy)
            d_feat = d_feat.reshape(shape).to(fdtype)
        if ctx.needs_input_grad[1]:
            # through the lerp weights, as _sfm_bwd (clip boundaries count
            # as interior; the clamped set has measure zero); border-clamped
            # coordinates get zero positional gradient
            gf = g.float()
            in_x = (fx > 0.0) & (fx < wf - 1)
            in_y = (fy > 0.0) & (fy < hf - 1)
            p00, p01, p10, p11 = (p.float() for p in
                                  _gather4(feat, base, dx, dy))
            wxf, wyf = wx[..., None].float(), wy[..., None].float()
            d_fx = torch.sum(((p01 - p00) * (1 - wyf)
                              + (p11 - p10) * wyf) * gf, dim=-1)
            d_fy = torch.sum(((p10 - p00) * (1 - wxf)
                              + (p11 - p01) * wxf) * gf, dim=-1)
            d_uv = torch.stack([d_fx * in_x * (wf / w_img),
                                d_fy * in_y * (hf / h_img)], dim=-1)
            d_uv = d_uv.to(wx.dtype)
        return d_feat, d_uv, None


def sample_feature_map(feat, uv, image_shape):
    """feat (V,Hf,Wf,C) NHWC float32 or bfloat16; uv (V,N,2) float32 image
    pixels (x, y); image_shape (H_img, W_img) -> (V,N,C) in feat's dtype,
    border-clamped, align_corners semantics (K4 on the card, its bf16 form
    for a bf16 map).  Differentiable in feat (K3 on the card) and uv (d_uv
    float32); where no gradient is asked for, nothing is saved."""
    return _SampleFeatureMap.apply(feat, uv, tuple(image_shape))


def sample_half_pixel(feat, uv, image_shape):
    """Bilinear sampling with half-pixel (align_corners=False) and
    zero-padding semantics: the convention of the reference's depth-map
    lookup (``get_relative_depth``, if_clight_renderer.py:75-93, which
    normalises uv / S * 2 - 1 into a default grid_sample).  The JAX
    package's ``sample_half_pixel``; plain PyTorch on any device.

    feat (V, Hf, Wf, C); uv (V, N, 2) original-image pixels (x, y);
    image_shape (H_img, W_img) -> (V, N, C).
    """
    v, hf, wf, c = feat.shape
    h_img, w_img = image_shape
    fx = uv[..., 0] * (wf / w_img) - 0.5
    fy = uv[..., 1] * (hf / h_img) - 0.5
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx = (fx - x0).to(feat.dtype)[..., None]
    wy = (fy - y0).to(feat.dtype)[..., None]
    x0i, y0i = x0.long(), y0.long()
    flat = feat.reshape(v, hf * wf, c)

    def tap(yi, xi):
        valid = (yi >= 0) & (yi < hf) & (xi >= 0) & (xi < wf)
        idx = yi.clamp(0, hf - 1) * wf + xi.clamp(0, wf - 1)
        vals = torch.gather(flat, 1, idx[..., None].expand(-1, -1, c))
        return vals * valid[..., None].to(feat.dtype)

    top = tap(y0i, x0i) * (1 - wx) + tap(y0i, x0i + 1) * wx
    bot = tap(y0i + 1, x0i) * (1 - wx) + tap(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy


def depth_visibility(depth_maps, verts_world, K, R, T, det: float = 0.07):
    """Vertex visibility from per-view depth maps (the reference's
    depth_map + depth_vizmap mode, if_clight_renderer.py:75-93,128-133; the
    JAX package's ``depth_visibility``): a vertex is visible in a view when
    its camera depth is at most ``det`` behind the surface depth sampled at
    its projection.

    depth_maps (V, Hd, Wd); verts_world (Nv, 3) -> (V, Nv) float32 {0, 1}.
    """
    uv, z = project_points(verts_world, K, R, T)
    hd, wd = depth_maps.shape[1:3]
    surf = sample_half_pixel(depth_maps[..., None], uv, (hd, wd))[..., 0]
    return (z <= surf + det).float()
