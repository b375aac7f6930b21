"""The frame render: painting -> TransHE -> cull -> DPaRF/NeRF decode ->
compositing (counterpart of transhuman_tpu/render/pipeline.py).

* ``prologue``, once per frame: encode the V input views, project the SMPL
  vertices into each, sample the holder map there, mask by visibility (the
  frame's vizmaps, or with its depth_maps ``depth_visibility``: a vertex
  within 0.07 m behind each view's surface), mean-pool into cluster tokens
  and refine them with TransHE.
* ``render_frame``: sample every ray, then per chunk of ``chunk_rays`` rays
  cull the points farther than ``cull_distance`` from the target-pose body
  (kernel K1 on the card), decode only the survivors (pixel-feature fetch,
  DPaRF binding in kernel K2, the heads), scatter their raw outputs back into
  zeros, and composite.  The compaction is dynamic (boolean indexing), as in
  the reference; a culled point contributes raw = 0 exactly as in the JAX
  package's dense render (``render_frame_dense`` with ``compact_ratio=None``),
  which is the parity target.  The JAX package's static-shape machinery
  (compaction capacity, ray padding) has no job here.
* ``render_sigma``: the density over a flat grid of points for mesh
  reconstruction: one cull of every point (K1), one compaction, the
  survivors decoded in fixed chunks with a zero view code, no host sync
  between the chunks.
* ``render_train``: every ray of a train sample in one differentiable
  evaluation, with the invalid rays masked (the JAX package's
  ``render_train``); its backward runs kernel K3 for both feature-map
  fetches and K2's token gradient on the card.  ``render_train_batch``
  renders a batch of samples with one encoder pass over all their views,
  so that BatchNorm pools its statistics over the batch.  With
  ``train_cull`` the points the cull drops are not decoded (their raw is 0
  and gets no gradient); with ``remat`` the decode is recomputed in the
  backward instead of kept.

The cull keeps a point closer than ``cull_distance`` to the body, or, with
``vertex_radii`` (``cull_radii``'s npz), closer to some vertex v than r_v.

The serving entry points run under ``torch.no_grad``; they and the train
path share the undecorated bodies ``_prologue`` and ``_query_points``.

In the model's compute dtype bfloat16, the maps, the painted vertices, the
cluster tokens and the raw outputs are bf16 (the pool matrix is cast for the
token pooling, as the JAX package casts it); the cluster centres and
rotations, the sample points and the cull stay float32.  The JAX package's
bf16 cull computes in bf16 on the TPU; here K1 is float32 in both modes.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, fields
from functools import partial
from typing import Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..geometry.clusters import ClusterSpec, normalize_positions
from ..kernels.cull import radii_cull, shell_cull
from ..models.embedder import embed_viewdir
from ..ops.sampling import (depth_visibility, project_points,
                             sample_feature_map)
from ..weights import reference_pe_table
from .volume import composite, sample_along_rays


def fold_in(seed: int, data: int) -> int:
    """A seed derived from (seed, data), decorrelated from both (the role of
    ``jax.random.fold_in``; numpy's SeedSequence hash, not JAX's bits)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(
        1, np.uint64)[0] >> 1)


class _TensorFields:
    def to(self, device):
        """A copy with every tensor field moved to ``device`` (None fields
        stay None)."""
        return type(self)(**{
            f.name: (None if getattr(self, f.name) is None
                     else getattr(self, f.name).to(device))
            for f in fields(self)})


@dataclass
class FrameInputs(_TensorFields):
    """One frame's inputs; V reference views, Nv SMPL vertices."""

    images: torch.Tensor  # (V, H, W, 3) float, background masked out
    vizmaps: torch.Tensor  # (V, Nv) float {0,1} vertex visibility per view
    K: torch.Tensor  # (V, 3, 3) intrinsics at render resolution
    R: torch.Tensor  # (V, 3, 3) world -> camera rotations
    T: torch.Tensor  # (V, 3) translations
    verts_world: torch.Tensor  # (Nv, 3) painting-frame vertices, world
    tar_verts_smpl: torch.Tensor  # (Nv, 3) target-pose vertices, SMPL coords
    blend_rot: torch.Tensor  # (Nv, 3, 3) rotation blocks of blend matrices
    Rh: torch.Tensor  # (3, 3) target world -> SMPL rotation
    Th: torch.Tensor  # (3,) target world -> SMPL translation
    # per-view depth maps (depth_map with depth_vizmap): the prologue takes
    # the vertex visibility from them in place of vizmaps
    depth_maps: Optional[torch.Tensor] = None  # (V, Hd, Wd) float32
    # the transform_can_smpl augmentation (data/aug.py): set on training
    # frames when rot_ratio > 0, all three or none; eval frames carry none
    aug_center: Optional[torch.Tensor] = None  # (3,)
    aug_rot: Optional[torch.Tensor] = None  # (3, 3) xz rotation
    aug_trans: Optional[torch.Tensor] = None  # (3,)


def to_smpl(frame: FrameInputs, pts_world):
    """World -> SMPL coordinates of the target pose, then the frame's
    augmentation when it carries one (the JAX package's to_smpl)."""
    pts = (pts_world - frame.Th) @ frame.Rh
    if frame.aug_rot is not None:
        pts = ((pts - frame.aug_center) @ frame.aug_rot.T + frame.aug_center
               + frame.aug_trans)
    return pts


@dataclass
class RayBundle(_TensorFields):
    ray_o: torch.Tensor  # (R, 3)
    ray_d: torch.Tensor  # (R, 3)
    near: torch.Tensor  # (R,)
    far: torch.Tensor  # (R,)
    mask: torch.Tensor  # (R,) bool, False for rays that render nothing


@dataclass
class Prologue:
    """Per-frame quantities shared by every chunk of rays."""

    tokens: torch.Tensor  # (V, C, D) TransHE-refined cluster tokens
    pixel_map: torch.Tensor  # (V, H, W, 384), in the compute dtype
    centers: torch.Tensor  # (C, 3) cluster centres, SMPL coords
    rot: torch.Tensor  # (C, 3, 3) pooled blend rotations


def validate_radii(vertex_radii, n_verts: int):
    """(Nv,) float32 per-vertex cull radii, or None for None: the JAX
    package's ``_validate_radii``, with its errors."""
    if vertex_radii is None:
        return None
    vr = np.asarray(vertex_radii, np.float32).reshape(-1)
    if vr.shape[0] != n_verts:
        raise ValueError(
            f"vertex_radii has {vr.shape[0]} entries for {n_verts} vertices")
    if (vr <= 0).any() or not np.isfinite(vr).all():
        raise ValueError("vertex_radii must be positive and finite")
    return vr


class RenderPipeline:
    """The render of one frame, closing over the model and the static
    cluster/PE tables, which live on ``device``."""

    def __init__(self, model, cluster: ClusterSpec, canonical_verts,
                 n_samples: int = 64, chunk_rays: int = 512,
                 cull_distance: float = 0.1, white_bkgd: bool = False,
                 raw_noise_std: float = 0.0, device="cpu", pe_table=None,
                 vertex_radii=None, remat: bool = False,
                 train_cull: bool = False):
        self.model = model
        self.device = torch.device(device)
        self.n_samples = n_samples
        self.chunk_rays = chunk_rays
        self.cull_distance = cull_distance
        self.n_verts = np.asarray(canonical_verts).shape[0]
        self.vertex_radii = vertex_radii
        self.remat = remat
        self.train_cull = train_cull
        self.white_bkgd = white_bkgd
        self.raw_noise_std = raw_noise_std
        self.pool = torch.as_tensor(cluster.pool_matrix, dtype=torch.float32,
                                    device=self.device)  # (C, Nv)
        # TransHE's positional code: the canonical cluster centroids in the
        # reference's fixed [-1.5, 1.5]^3 box, through the stored table, or
        # the table a checkpoint carries (a converted official one's)
        if pe_table is None:
            canon = cluster.pool_matrix @ np.asarray(canonical_verts,
                                                     np.float32)
            pe_table = reference_pe_table(normalize_positions(canon, 1.5),
                                          model.embed_dim)
        self.pe_can = torch.as_tensor(np.asarray(pe_table, np.float32),
                                      device=self.device)  # (C, D)
        self.last_frame_stats = {"points": 0, "survivors": 0}

    @property
    def vertex_radii(self):
        """(Nv,) float32 per-vertex cull radii on the device, or None (the
        cull_distance shell)."""
        return self._vertex_radii

    @vertex_radii.setter
    def vertex_radii(self, radii):
        vr = validate_radii(radii, self.n_verts)
        self._vertex_radii = (None if vr is None
                              else torch.as_tensor(vr, device=self.device))

    def clone(self, **overrides):
        """A shallow copy with attributes replaced (``vertex_radii``
        validated); an unknown attribute raises, as the JAX package's
        ``clone`` does."""
        out = copy.copy(self)
        for k, v in overrides.items():
            if not hasattr(self, k):
                raise AttributeError(
                    f"RenderPipeline.clone: unknown attribute {k!r}")
            setattr(out, k, v)
        return out

    @torch.no_grad()
    def prologue(self, frame: FrameInputs) -> Prologue:
        return self._prologue(frame)

    def encode_batch(self, frames):
        """[(holder_map, pixel_map)] of each frame, from one encoder pass
        over the views of them all: BatchNorm, which lives only in the
        encoder, then reduces over every view of the batch.  Each sample
        has the same V x H x W, so that pooled mean and mean square are the
        mean of the per-sample ones, which is what the JAX step's
        ``pmean`` over its vmapped 'batch' axis takes."""
        shapes = sorted({tuple(f.images.shape) for f in frames})
        if len(shapes) != 1:
            raise ValueError("the samples of a batch must have images of one "
                             f"shape (V, H, W, 3); got {shapes}")
        holder, pixel = self.model.encode_views(
            torch.cat([f.images for f in frames]))
        v = shapes[0][0]
        return list(zip(holder.split(v), pixel.split(v)))

    def _prologue(self, frame: FrameInputs, maps=None) -> Prologue:
        """maps: the frame's (holder_map, pixel_map) when encode_batch made
        them; None encodes the frame's views alone."""
        holder_map, pixel_map = (self.model.encode_views(frame.images)
                                 if maps is None else maps)
        uv = self.fetch_uv(frame, frame.verts_world)
        latent = sample_feature_map(holder_map, uv, frame.images.shape[1:3])
        vizmaps = frame.vizmaps
        if frame.depth_maps is not None:
            vizmaps = depth_visibility(frame.depth_maps, frame.verts_world,
                                       frame.K, frame.R, frame.T)
        holder = latent * vizmaps[..., None].to(latent.dtype)
        tokens = self.model.refine_tokens(self.pool.to(latent.dtype) @ holder,
                                          self.pe_can)
        centers = self.pool @ frame.tar_verts_smpl
        rot = torch.einsum("cv,vij->cij", self.pool, frame.blend_rot)
        return Prologue(tokens=tokens.contiguous(), pixel_map=pixel_map,
                        centers=centers.contiguous(), rot=rot.contiguous())

    @staticmethod
    def fetch_uv(frame: FrameInputs, pts_world, pts_mask=None):
        """(V, N, 2) image coordinates at which the feature maps are sampled
        for the points pts_world (N, 3): the painting fetch at the vertices,
        the pixel fetch at the ray samples.  Points with pts_mask False
        decode to 0 whatever they fetch, so their fetches collapse onto one
        texel, as the JAX package does."""
        uv, _ = project_points(pts_world, frame.K, frame.R, frame.T)
        if pts_mask is not None:
            uv = torch.where(pts_mask[None, :, None], uv,
                             torch.zeros_like(uv))
        return uv

    def _cull(self, pts_smpl, verts_smpl):
        """(N,) bool: within the vertex radii of the body when the pipe has
        them, else closer than cull_distance to it (K1 on the card)."""
        if self.vertex_radii is not None:
            return radii_cull(pts_smpl.contiguous(), verts_smpl.contiguous(),
                              self.vertex_radii)
        return shell_cull(pts_smpl.contiguous(), verts_smpl.contiguous(),
                          self.cull_distance)

    @torch.no_grad()
    def query_points(self, frame: FrameInputs, pro: Prologue, pts_world,
                     viewdir_embed):
        """pts_world (N,3), viewdir_embed (N,27) -> raw (N,4)."""
        return self._query_points(frame, pro, pts_world, viewdir_embed)

    def _query_points(self, frame, pro, pts_world, viewdir_embed,
                      pts_mask=None):
        """As query_points; points with pts_mask False decode to 0."""
        pts_smpl = to_smpl(frame, pts_world)
        uv = self.fetch_uv(frame, pts_world, pts_mask)
        pixel_feat = sample_feature_map(pro.pixel_map, uv,
                                        frame.images.shape[1:3])
        return self.model.query(pts_smpl.contiguous(), pro.centers, pro.rot,
                                pro.tokens, pixel_feat, viewdir_embed,
                                pts_mask)

    def render_train(self, frame: FrameInputs, rays: RayBundle,
                     seed: Optional[int] = None, sample_jitter: bool = True):
        """Every ray in one differentiable evaluation (the JAX package's
        ``render_train``, the reference's <= 2400-ray branch).

        With a seed, the depths are jittered (when sample_jitter) from a
        generator seeded with it, and raw_noise_std density noise is drawn
        from a second generator seeded with ``fold_in(seed, 1)``, so the two
        draws are independent (JAX: ``fold_in(rng, 1)``).  Returns the
        composite's dict (rgb_map (R,3), acc_map, depth_map, weights), and
        with train_cull JAX's ``overflow`` (1,), always 0 here."""
        return self.render_train_batch([frame], [rays], [seed],
                                       sample_jitter)[0]

    def render_train_batch(self, frames, rays, seeds,
                           sample_jitter: bool = True):
        """render_train of each sample of a batch (lists of equal length),
        the encoder run once over the views of them all (encode_batch).
        last_frame_stats then counts the batch's points and the points it
        decoded."""
        outs, points, survivors = [], 0, 0
        for frame, r, seed, maps in zip(frames, rays, seeds,
                                        self.encode_batch(frames)):
            out, n, kept = self._render_train(frame, r, seed, sample_jitter,
                                              maps)
            outs.append(out)
            points += n
            survivors += kept
        self.last_frame_stats = {"points": points, "survivors": survivors}
        return outs

    def _render_train(self, frame, rays, seed, sample_jitter, maps):
        """(render_train's dict, points, points decoded) of one sample."""
        pts, z_vals, pts_mask, vde = self.train_points(rays, seed,
                                                       sample_jitter)
        pro = self._prologue(frame, maps)
        decode = self._query_points
        if self.remat:
            # keep only the decode's inputs and output; its activations are
            # recomputed in the backward (K4 and K2 run again there)
            decode = partial(checkpoint, self._query_points,
                             use_reentrant=False)
        n = pts.shape[0]
        if self.train_cull:
            # the JAX package's train cull: only the points the cull keeps
            # are decoded, one nonzero (a host sync) per sample; their raw
            # goes back into zeros out of place, so a culled point's raw is
            # exactly 0 and its gradient exactly 0
            keep = self._cull(to_smpl(frame, pts),
                              frame.tar_verts_smpl) & pts_mask
            idx = torch.nonzero(keep)[:, 0]
            kept, mask = idx.numel(), None
            if kept == 0:
                # one masked point decodes to 0 and keeps the loss's graph
                idx, mask = idx.new_zeros(1), keep[:1]
            raw_c = decode(frame, pro, pts[idx], vde[idx], mask)
            raw = torch.zeros((n, 4), dtype=raw_c.dtype,
                              device=pts.device).index_copy(0, idx, raw_c)
        else:
            raw, kept = decode(frame, pro, pts, vde, pts_mask), n
        noise = None
        if seed is not None:
            noise = torch.Generator(device=pts.device).manual_seed(
                fold_in(seed, 1))
        out = composite(raw.reshape(z_vals.shape + (4,)), z_vals,
                        rays.ray_d, self.white_bkgd, self.raw_noise_std,
                        noise)
        if self.train_cull:
            out["overflow"] = torch.zeros(1, device=pts.device)
        return out, n, kept

    @torch.no_grad()
    def train_cull_fraction(self, frame: FrameInputs, rays: RayBundle):
        """The train cull's survivor fraction of one sample's points (a 0-d
        tensor), at the unjittered depths: the JAX package's
        ``train_cull_fraction``."""
        pts, _ = sample_along_rays(rays.ray_o, rays.ray_d, rays.near,
                                   rays.far, self.n_samples)
        n = pts.shape[0] * self.n_samples
        keep = self._cull(to_smpl(frame, pts.reshape(n, 3)),
                          frame.tar_verts_smpl)
        return (keep & rays.mask.repeat_interleave(self.n_samples)).sum() / n

    def train_points(self, rays: RayBundle, seed: Optional[int] = None,
                     sample_jitter: bool = True):
        """The points render_train decodes for R rays of S samples, the
        depths jittered as it jitters them: (pts_world (R*S, 3), z_vals
        (R, S), the ray mask per point (R*S,), the view-direction code per
        point (R*S, 27))."""
        jitter = None
        if seed is not None and sample_jitter:
            jitter = torch.Generator(device=rays.ray_o.device).manual_seed(
                seed)
        pts, z_vals = sample_along_rays(rays.ray_o, rays.ray_d, rays.near,
                                        rays.far, self.n_samples, jitter)
        r, s = z_vals.shape
        viewdir = rays.ray_d / torch.linalg.norm(rays.ray_d, dim=-1,
                                                 keepdim=True)
        vde = embed_viewdir(viewdir, self.model.view_freqs)
        vde = vde[:, None, :].expand(r, s, vde.shape[-1]).reshape(r * s, -1)
        pts_mask = rays.mask[:, None].expand(r, s).reshape(-1)
        return pts.reshape(r * s, 3), z_vals, pts_mask, vde

    @torch.no_grad()
    def render_frame(self, frame: FrameInputs, rays: RayBundle):
        """rgb_map (R,3), acc_map (R,), depth_map (R,) for R rays of any
        count; rays with mask False render zeros."""
        r, s, cr = rays.ray_o.shape[0], self.n_samples, self.chunk_rays
        pro = self.prologue(frame)
        viewdir = rays.ray_d / torch.linalg.norm(rays.ray_d, dim=-1,
                                                 keepdim=True)
        vde = embed_viewdir(viewdir, self.model.view_freqs)  # (R, 27)
        pts, z_vals = sample_along_rays(rays.ray_o, rays.ray_d, rays.near,
                                        rays.far, s)
        # the decode's rows as it returns them (the composite upcasts)
        raw = torch.zeros((r * s, 4), dtype=self.model.compute_dtype,
                          device=pts.device)
        n_survivors = 0
        for a in range(0, r, cr):
            b = min(a + cr, r)
            flat = pts[a:b].reshape(-1, 3)
            keep = self._cull(to_smpl(frame, flat), frame.tar_verts_smpl)
            keep &= rays.mask[a:b].repeat_interleave(s)
            idx = torch.nonzero(keep)[:, 0]
            if idx.numel() == 0:
                continue
            n_survivors += idx.numel()
            raw[a * s + idx] = self.query_points(frame, pro, flat[idx],
                                                 vde[a + idx // s])
        self.last_frame_stats = {"points": r * s, "survivors": n_survivors}
        out = composite(raw.reshape(r, s, 4), z_vals, rays.ray_d,
                        self.white_bkgd)
        m = rays.mask.to(out["acc_map"].dtype)
        return {
            "rgb_map": out["rgb_map"] * m[:, None],
            "acc_map": out["acc_map"] * m,
            "depth_map": out["depth_map"] * m,
        }

    @torch.no_grad()
    def render_sigma(self, frame: FrameInputs, pts_world):
        """sigma (N,), the raw density pre-activation at pts_world (N, 3)
        (mesh reconstruction; the JAX package's ``render_sigma_dense``).

        One cull of every point (one K1 launch on the card; slabs of a chunk
        on the CPU, where the plain distance matrix would not fit), one
        ``nonzero``, then the survivors decoded in chunks of ``chunk_rays *
        n_samples`` points with no host sync between them, and scattered
        into zeros: a culled point's sigma is exactly 0.  sigma is float32
        in every compute dtype.  The view code is a
        zero vector, as the JAX package's (sigma does not read it)."""
        n, cp = pts_world.shape[0], self.chunk_rays * self.n_samples
        pro = self._prologue(frame)
        slab = max(n, 1) if pts_world.is_cuda else cp
        keep = torch.cat([self._cull(to_smpl(frame, pts_world[a:a + slab]),
                                     frame.tar_verts_smpl)
                          for a in range(0, max(n, 1), slab)])
        idx = torch.nonzero(keep)[:, 0]
        m = idx.numel()
        vde = torch.zeros((min(cp, m), 6 * self.model.view_freqs + 3),
                          dtype=pts_world.dtype, device=pts_world.device)
        sig = torch.empty(m, dtype=pts_world.dtype, device=pts_world.device)
        for a in range(0, m, cp):
            b = min(a + cp, m)
            raw = self._query_points(frame, pro, pts_world[idx[a:b]],
                                     vde[:b - a])
            sig[a:b] = raw[:, 3]  # upcast to float32 on assignment
        self.last_frame_stats = {"points": n, "survivors": m}
        return torch.zeros(n, dtype=sig.dtype,
                           device=sig.device).index_copy_(0, idx, sig)
