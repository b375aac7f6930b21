"""Ray sampling and alpha compositing (counterpart of
transhuman_tpu/render/volume.py; reference ``get_sampling_points`` and
``raw2outputs``)."""

from __future__ import annotations

from typing import Optional

import torch


def sample_along_rays(ray_o, ray_d, near, far, n_samples: int,
                      generator: Optional[torch.Generator] = None):
    """Stratified points along rays: (pts (R,S,3), z_vals (R,S)).

    Deterministic linspace depths without a generator (evaluation); with
    one, each depth is jittered uniformly inside its midpoint interval."""
    t = torch.linspace(0.0, 1.0, n_samples, dtype=ray_o.dtype,
                       device=ray_o.device)
    z_vals = near[:, None] * (1.0 - t) + far[:, None] * t
    if generator is not None:
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        u = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                       device=z_vals.device)
        z_vals = lower + (upper - lower) * u
    pts = ray_o[:, None, :] + ray_d[:, None, :] * z_vals[..., None]
    return pts, z_vals


def composite(raw, z_vals, ray_d, white_bkgd: bool = False,
              raw_noise_std: float = 0.0,
              generator: Optional[torch.Generator] = None):
    """NeRF alpha compositing of raw (R,S,4) = [rgb logits, sigma].

    The last interval is 1e10 long and each transmittance factor is
    1 - alpha + 1e-10, as in the reference.  With raw_noise_std > 0 and a
    generator, N(0, raw_noise_std^2) noise is added to sigma (training
    regularisation; the caller gives a generator of its own, so the draw
    is independent of the sampling jitter).  Returns rgb_map (R,3),
    acc_map (R,), depth_map (R,), weights (R,S).  raw may come in the
    model's compute dtype (bf16); it is upcast here and the compositing is
    float32."""
    raw = raw.float()
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(ray_d, dim=-1, keepdim=True)
    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0 and generator is not None:
        sigma = sigma + torch.randn(sigma.shape, generator=generator,
                                    dtype=sigma.dtype,
                                    device=sigma.device) * raw_noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha + 1e-10],
                  dim=-1),
        dim=-1,
    )[:, :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb_map": rgb_map, "acc_map": acc_map, "depth_map": depth_map,
            "weights": weights}
