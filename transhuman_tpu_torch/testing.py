"""Synthetic scene for tests and the on-card smoke run (counterpart of
transhuman_tpu/testing.py::synthetic_setup): the seeded SMPL stand-in, k-means
clusters, V cameras on a circle and random weights from a seeded generator."""

from __future__ import annotations

import numpy as np
import torch

from .geometry.clusters import ClusterSpec
from .geometry.smpl import SMPLModel
from .models.network import TransHumanNet
from .render.pipeline import FrameInputs, RenderPipeline

# The random network's density bias: a positive constant makes the culled
# shell around the body visibly opaque (acc near 1 on body rays) instead of
# the near-zero density that small random weights give.
SYNTHETIC_DENSITY_BIAS = 10.0


def init_weights(model: torch.nn.Module, generator: torch.Generator):
    """Deterministic random weights: N(0, 1/fan_in) for every matrix and
    kernel, ones for normalisation scales, zeros for biases and the mask
    token, and the density bias above."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") or name.endswith("mask_token"):
                p.zero_()
            elif p.dim() == 1:  # BatchStatNorm / LayerNorm scale
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                w = torch.randn(p.shape, generator=generator) / fan_in**0.5
                p.copy_(w)
        model.alpha_fc.bias.fill_(SYNTHETIC_DENSITY_BIAS)
    return model


def synthetic_scene(n_views: int = 3, image_hw: tuple = (512, 512),
                    n_verts: int = 6890, n_clusters: int = 300,
                    seed: int = 0):
    """(frame, smpl, cluster): the seeded body, its k-means clusters and V
    cameras on a circle, with images from ``np.random.default_rng(seed)``;
    frame tensors on the CPU."""
    rng = np.random.default_rng(seed)
    h, w = image_hw
    smpl = SMPLModel.synthetic(n_verts=n_verts)
    cluster = ClusterSpec.from_kmeans(smpl.v_template, n_clusters,
                                      iters=3 if n_verts < 1000 else 8)
    verts, _, T = smpl(np.zeros(72), np.zeros(10))
    # cameras 2.5 m from the origin on a circle, facing it
    focal = 0.9 * max(h, w)
    K = np.tile(np.array([[[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]]],
                         np.float32), (n_views, 1, 1))
    Rs, Ts = [], []
    for i in range(n_views):
        th = 2 * np.pi * i / max(n_views, 1)
        c, s = np.cos(th), np.sin(th)
        Rm = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]], np.float32)
        Rs.append(Rm)
        Ts.append(-Rm @ np.array([-2.5 * s, 0.0, -2.5 * c], np.float32))
    R, Tc = np.stack(Rs), np.stack(Ts).astype(np.float32)
    f32 = torch.from_numpy
    frame = FrameInputs(
        images=f32(rng.random((n_views, h, w, 3), dtype=np.float32)),
        vizmaps=torch.ones((n_views, n_verts)),
        K=f32(K), R=f32(R), T=f32(Tc),
        verts_world=f32(verts), tar_verts_smpl=f32(verts),
        blend_rot=f32(np.ascontiguousarray(T[:, :3, :3])),
        Rh=torch.eye(3), Th=torch.zeros(3),
    )
    return frame, smpl, cluster


def synthetic_setup(n_views: int = 3, image_hw: tuple = (512, 512),
                    n_verts: int = 6890, n_clusters: int = 300,
                    n_samples: int = 64, chunk_rays: int = 512,
                    embed_dim: int = 192, vit_depth: int = 12,
                    vit_heads: int = 3, knn_k: int = 7, seed: int = 0,
                    *, device, compute_dtype=torch.float32):
    """(model, pipe, frame, smpl, cluster): model on ``device`` (a keyword
    with no default) in
    ``compute_dtype`` with random weights from
    ``torch.Generator().manual_seed(seed)``, frame on the CPU (numpy inputs
    from ``np.random.default_rng(seed)``)."""
    frame, smpl, cluster = synthetic_scene(n_views, image_hw, n_verts,
                                           n_clusters, seed)
    model = TransHumanNet(embed_dim=embed_dim, vit_depth=vit_depth,
                          vit_heads=vit_heads, knn_k=knn_k,
                          compute_dtype=compute_dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(device).eval()
    pipe = RenderPipeline(model, cluster, smpl.v_template,
                          n_samples=n_samples, chunk_rays=chunk_rays,
                          device=device)
    return model, pipe, frame, smpl, cluster


def synthetic_rays(n_rays: int, seed: int = 0, spread: float = 0.12):
    """Rays from a frontal camera toward the synthetic body at the origin
    (the JAX package's testing.synthetic_rays, the same numpy draws); CPU
    tensors."""
    from .render.pipeline import RayBundle

    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((n_rays, 3)).astype(np.float32) * spread
    dirs[:, 2] += 1.0
    return RayBundle(
        ray_o=torch.tensor([0.0, 0.0, -2.5]).repeat(n_rays, 1),
        ray_d=torch.from_numpy(dirs),
        near=torch.full((n_rays,), 1.2),
        far=torch.full((n_rays,), 3.8),
        mask=torch.ones(n_rays, dtype=torch.bool),
    )
