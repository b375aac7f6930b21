"""Camera projection and bilinear feature-map sampling with its backward.

Counterpart of ``transhuman_tpu/ops/sampling.py``: the reference's
``F.grid_sample(align_corners=True, padding_mode="border")`` written directly
in feature-pixel space.  uv is scaled to feature pixels on each axis (x by W,
y by H), clamped to [0, size-1], the base texel is clamped to size-2, and the
2x2 patch is interpolated.  ``sample_feature_map`` is an autograd Function
like the JAX package's ``custom_vjp``.  Its forward is the 4-tap weighted
row gather K4 (kernels/gather.py) with the bilinear weights; its d_feat is
the K3 scatter (kernels/scatter.py), K4's adjoint; each runs its kernel on
the card and its plain twin on the CPU.  Its d_uv is plain PyTorch.
"""

from __future__ import annotations

import torch


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


def _sample_taps(feat, uv, image_shape):
    """(fx, fy) unclamped feature-pixel coordinates, base (V,N) texel ids,
    weights wx, wy (V,N) relative to the (possibly clamped) base texel, and
    the tap offsets dx, dy."""
    v, hf, wf, c = feat.shape
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


def _gather4(feat, base, dx, dy):
    """The four tap rows (V,N,C) each at base + {0, dx, dy, dy + dx}."""
    v, hf, wf, c = feat.shape
    flat = feat.reshape(v, hf * wf, c)
    views = torch.arange(v, device=feat.device)[:, None]
    return [flat[views, base + off] for off in (0, dx, dy, dy + dx)]


class _SampleFeatureMap(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, uv, image_shape):
        from ..kernels.gather import feature_gather

        fx, fy, base, wx, wy, dx, dy = _sample_taps(feat, uv, image_shape)
        v, hf, wf, c = feat.shape
        out = feature_gather(feat.reshape(v, hf * wf, c), base,
                             _bilinear_w4(wx, wy), (0, dx, dy, dy + dx))
        need_uv = ctx.needs_input_grad[1]
        h_img, w_img = image_shape
        ctx.meta = (feat.shape, feat.dtype, dx, dy, wf / w_img, hf / h_img)
        # border-clamped coordinates get zero positional gradient
        in_x = (fx > 0.0) & (fx < wf - 1) if need_uv else None
        in_y = (fy > 0.0) & (fy < hf - 1) if need_uv else None
        ctx.save_for_backward(base.to(torch.int32), wx, wy,
                              feat if need_uv else None, in_x, in_y)
        return out

    @staticmethod
    def backward(ctx, g):
        from ..kernels.scatter import dfeat_scatter

        base, wx, wy, feat, in_x, in_y = ctx.saved_tensors
        (v, hf, wf, c), fdtype, dx, dy, sx, sy = ctx.meta
        gf = g.float()
        d_feat = d_uv = None
        if ctx.needs_input_grad[0]:
            d_feat = dfeat_scatter(base, gf, _bilinear_w4(wx, wy).float(),
                                   hf * wf, dx, dy)
            d_feat = d_feat.reshape(v, hf, wf, c).to(fdtype)
        if ctx.needs_input_grad[1]:
            # through the lerp weights, as _sfm_bwd (clip boundaries count
            # as interior; the clamped set has measure zero)
            p00, p01, p10, p11 = (p.float() for p in
                                  _gather4(feat, base.long(), dx, dy))
            wxf, wyf = wx[..., None].float(), wy[..., None].float()
            d_fx = torch.sum(((p01 - p00) * (1 - wyf)
                              + (p11 - p10) * wyf) * gf, dim=-1)
            d_fy = torch.sum(((p10 - p00) * (1 - wxf)
                              + (p11 - p01) * wxf) * gf, dim=-1)
            d_uv = torch.stack([d_fx * in_x * sx, d_fy * in_y * sy], dim=-1)
            d_uv = d_uv.to(wx.dtype)
        return d_feat, d_uv, None


def sample_feature_map(feat, uv, image_shape):
    """feat (V,Hf,Wf,C) NHWC; uv (V,N,2) image pixels (x, y); image_shape
    (H_img, W_img) -> (V,N,C) float32, border-clamped, align_corners
    semantics (K4 on the card).  Differentiable in feat (K3 on the card) and
    uv."""
    return _SampleFeatureMap.apply(feat, uv, tuple(image_shape))
