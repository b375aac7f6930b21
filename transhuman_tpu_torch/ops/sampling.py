"""Camera projection and bilinear feature-map sampling (forward only).

Counterpart of ``transhuman_tpu/ops/sampling.py``: the reference's
``F.grid_sample(align_corners=True, padding_mode="border")`` written directly
in feature-pixel space.  uv is scaled to feature pixels on each axis (x by W,
y by H), clamped to [0, size-1], the base texel is clamped to size-2, and the
2x2 patch is interpolated.  The gather is plain tensor indexing: the JAX
package leaves it to XLA as well.  Its backward (the K3 scatter) comes with
training.
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


def sample_feature_map(feat, uv, image_shape):
    """feat (V,Hf,Wf,C) NHWC; uv (V,N,2) image pixels (x, y); image_shape
    (H_img, W_img) -> (V,N,C), border-clamped, align_corners semantics."""
    v, hf, wf, c = feat.shape
    h_img, w_img = image_shape
    fx = torch.clamp(uv[..., 0] * (wf / w_img), 0.0, wf - 1)
    fy = torch.clamp(uv[..., 1] * (hf / h_img), 0.0, hf - 1)
    x0 = torch.floor(fx).long()
    y0 = torch.floor(fy).long()
    if wf > 1:
        x0 = torch.clamp_max(x0, wf - 2)
    if hf > 1:
        y0 = torch.clamp_max(y0, hf - 2)
    # weights relative to the (possibly clamped) base texel
    wx = (fx - x0.to(fx.dtype))[..., None]
    wy = (fy - y0.to(fy.dtype))[..., None]
    dx = 1 if wf > 1 else 0
    dy = wf if hf > 1 else 0
    flat = feat.reshape(v, hf * wf, c)
    views = torch.arange(v, device=feat.device)[:, None]
    base = y0 * wf + x0  # (V, N)
    p00 = flat[views, base]
    p01 = flat[views, base + dx]
    p10 = flat[views, base + dy]
    p11 = flat[views, base + dy + dx]
    top = p00 * (1 - wx) + p01 * wx
    bot = p10 * (1 - wx) + p11 * wx
    return top * (1 - wy) + bot * wy
