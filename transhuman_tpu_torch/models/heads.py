"""DPaRF point binding, view fusion and NeRF heads (counterpart of
transhuman_tpu/models/heads.py).

Point features are (V, N, C).  The reference's 1x1 Conv1d layers keep their
names and (out, in, 1) weights, so the state dict is the reference layout,
and are applied as matrix products over C.  The reference registers these
layers on the network itself, not under a submodule, so ``ViewFusion`` and
``NeRFHeads`` are bases of ``TransHumanNet`` rather than children of it:
each base adds its layers under their reference names.  Every layer runs in
the compute dtype (``layers.linear``), and so does the raw output; the
binding's token sum comes out of K2 in it, its code in float32, cast at the
concatenation as the JAX package casts it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.dparf import dparf
from .layers import linear


def dparf_representation(pts_smpl, cluster_centers, cluster_rot, tokens,
                         k: int = 7, dist_alpha: float = 0.5,
                         n_freqs: int = 10,
                         knn_sigma: Optional[float] = None):
    """Deformable partial radiance field code of each point.

    pts_smpl (N,3), cluster_centers (C,3), cluster_rot (C,3,3), tokens (V,C,D).
    Returns (human_rep (V, N, D + 3 + 6 n_freqs), keep (N,) bool or None);
    keep is the truncation dist_0 < knn_sigma when knn_sigma is given.  On a
    CUDA tensor the whole binding is kernel K2; on the CPU the plain
    composition.  Differentiable in the tokens (kernels/dparf.py)."""
    tok, pe, dist, _, _ = dparf(pts_smpl, cluster_centers, cluster_rot, tokens,
                          k, dist_alpha, n_freqs)
    keep = None if knn_sigma is None else dist[:, 0] < knn_sigma
    v, n, _ = tok.shape
    pe = pe.to(tok.dtype)
    rep = torch.cat([tok, pe[None].expand(v, n, pe.shape[-1])], dim=-1)
    return rep, keep


def _dense(conv: nn.Conv1d, x, dtype):
    """A reference Conv1d(kernel 1) applied over the last axis of x, in
    dtype."""
    return linear(x, conv.weight[..., 0], conv.bias, dtype)


class KeyValueEmbed(nn.Module):
    """The reference's key/value projection pair (``spatial_key_value_*``)."""

    def __init__(self, dim: int, att_dim: int, out_dim: int):
        super().__init__()
        self.key_embed = nn.Conv1d(dim, att_dim, 1)
        self.value_embed = nn.Conv1d(dim, out_dim, 1)


class ViewFusion(nn.Module):
    """Per-point single-head cross-attention over the input views: keys and
    values from the pixel features, query keys and values from the human
    representation; softmax over the source view; residual add."""

    def __init__(self, dim: int = 256, att_dim: int = 128,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.att_dim = att_dim
        self.compute_dtype = compute_dtype
        self.spatial_key_value_0 = KeyValueEmbed(dim, att_dim, dim)  # pixel
        self.spatial_key_value_1 = KeyValueEmbed(dim, att_dim, dim)  # holder

    def fuse(self, holder, pixel):
        """holder, pixel (V, N, dim) -> (V, N, dim)."""
        pix, hold = self.spatial_key_value_0, self.spatial_key_value_1
        dt = self.compute_dtype
        key = _dense(pix.key_embed, pixel, dt)
        val = _dense(pix.value_embed, pixel, dt)
        qkey = _dense(hold.key_embed, holder, dt)
        qval = _dense(hold.value_embed, holder, dt)
        # scores[n, i, j] = key_i . qkey_j, softmax over the source view i
        scores = torch.einsum("inc,jnc->nij", key, qkey) * self.att_dim**-0.5
        attn = torch.softmax(scores, dim=1)
        return qval + torch.einsum("inc,nij->jnc", val, attn)

    def forward(self, holder, pixel):
        return self.fuse(holder, pixel)


class NeRFHeads(ViewFusion):
    """Fusion + density and colour decoding: (V,N,*) point features -> raw
    (N, 4) = [rgb logits, sigma]."""

    def __init__(self, rep_dim: int = 255, pixel_dim: int = 384,
                 view_dim: int = 27, hidden: int = 256, rgb_hidden: int = 128,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(hidden, 128, compute_dtype)
        self.fc_0 = nn.Conv1d(rep_dim, hidden, 1)
        self.alpha_res_0 = nn.Conv1d(pixel_dim, hidden, 1)
        self.fc_1 = nn.Conv1d(hidden, hidden, 1)
        self.fc_2 = nn.Conv1d(hidden, hidden, 1)
        self.fc_3 = nn.Conv1d(hidden, hidden, 1)
        self.alpha_fc = nn.Conv1d(hidden, 1, 1)
        self.feature_fc = nn.Conv1d(hidden, hidden, 1)
        self.rgb_res_0 = nn.Conv1d(pixel_dim, hidden, 1)
        self.view_fc = nn.Conv1d(hidden + view_dim, rgb_hidden, 1)
        self.rgb_res_1 = nn.Conv1d(pixel_dim, rgb_hidden, 1)
        self.fc_4 = nn.Conv1d(rgb_hidden, rgb_hidden, 1)
        self.rgb_fc = nn.Conv1d(rgb_hidden, 3, 1)

    def decode(self, human_rep, pixel_feat, viewdir_embed, pts_mask=None):
        """human_rep (V,N,R), pixel_feat (V,N,384), viewdir_embed (N,27),
        pts_mask optional (N,) bool (False -> raw 0)."""
        v, n, _ = human_rep.shape
        dt = self.compute_dtype
        net_hold = F.relu(_dense(self.fc_0, human_rep, dt))
        net_pix = F.relu(_dense(self.alpha_res_0, pixel_feat, dt))
        net = self.fuse(net_hold, net_pix)
        net = F.relu(_dense(self.fc_1, net, dt))
        inter = F.relu(_dense(self.fc_2, net, dt))

        # density: average the views, then the MLP
        opa = F.relu(_dense(self.fc_3, inter.mean(dim=0), dt))
        sigma = _dense(self.alpha_fc, opa, dt)  # (N, 1)

        # colour: pixel-feature residuals and the view direction
        feat = (_dense(self.feature_fc, inter, dt)
                + _dense(self.rgb_res_0, pixel_feat, dt))
        vdir = viewdir_embed.to(dt)[None].expand(v, n, viewdir_embed.shape[-1])
        feat = F.relu(_dense(self.view_fc, torch.cat([feat, vdir], dim=-1),
                             dt))
        feat = feat + _dense(self.rgb_res_1, pixel_feat, dt)
        feat = F.relu(_dense(self.fc_4, feat.mean(dim=0), dt))
        rgb = _dense(self.rgb_fc, feat, dt)  # (N, 3)

        raw = torch.cat([rgb, sigma], dim=-1)
        if pts_mask is not None:
            raw = torch.where(pts_mask[:, None], raw, torch.zeros_like(raw))
        return raw

    def forward(self, human_rep, pixel_feat, viewdir_embed, pts_mask=None):
        return self.decode(human_rep, pixel_feat, viewdir_embed, pts_mask)
