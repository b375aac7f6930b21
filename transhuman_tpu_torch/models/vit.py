"""TransHE: a ViT over the ~300 cluster tokens (counterpart of
transhuman_tpu/models/vit.py).

Pre-LN blocks (LayerNorm eps 1e-6), qkv with bias, exact-GELU MLP of ratio 4,
a final LayerNorm.  Attention is a plain matmul and softmax, as in the JAX
package.  The positional code is either the (B, C, 3) centroids, embedded
here (``embed_vit_pos``), or a stored (B, C, D) table; the render path adds
the stored reference table (``weights.reference_pe_table``): at embed 192 its
top band is pi * 2^31, where any reformulation of the reference's f32 ops
gives other values, so the table is computed once with the reference's op
sequence and added as is.  Names follow the reference state dict
(``blocks.0.attn.qkv``, ``norm``).  In a lower compute dtype the Linears and
LayerNorms return it (the LayerNorms from float32 statistics), and
attention, softmax and GELU run on it; the residual stream keeps the
tokens' dtype promoted with it, as Flax's does (the render path's tokens
are in the compute dtype already).  A Linear may be swapped for a
tensor-parallel one (``parallel/tp.py``), which holds a shard of the
weight: attention then runs on the heads its qkv shard holds.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .embedder import embed_vit_pos
from .layers import layer_norm, linear

VARIANTS = {  # embed_dim, num_heads
    "tiny": (192, 3),
    "small": (384, 6),
    "base": (768, 12),
}


def _linear(layer: nn.Module, x, dtype):
    """A Linear in ``dtype``; a tensor-parallel one applies itself."""
    if isinstance(layer, nn.Linear):
        return linear(x, layer.weight, layer.bias, dtype)
    return layer(x, dtype)


def add_position(tokens, pe, mask, mask_token, embed_dim: int):
    """TransHE's prologue: masked tokens take mask_token, then the
    positional code ((B, C, 3) centroids, embedded here, or a (B, C, D)
    table) is added in the tokens' dtype."""
    if mask is not None:
        tokens = torch.where(mask[..., None], mask_token.to(tokens.dtype),
                             tokens)
    if pe.shape[-1] != embed_dim:
        pe = embed_vit_pos(pe, embed_dim)
    return tokens + pe.to(tokens.dtype)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x, dtype):
        b, n, _ = x.shape
        hd = self.head_dim
        # (b, n, 3, heads, hd): every head, or the heads of a qkv shard
        q, k, v = _linear(self.qkv, x, dtype).reshape(
            b, n, 3, -1, hd).unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * hd**-0.5
        attn = torch.softmax(attn, dim=-1)
        y = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, -1)
        return _linear(self.proj, y, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, dtype):
        y = F.gelu(_linear(self.fc1, x, dtype), approximate="none")
        return _linear(self.fc2, y, dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x, dtype):
        x = x + self.attn(layer_norm(self.norm1, x, dtype), dtype)
        return x + self.mlp(layer_norm(self.norm2, x, dtype), dtype)


class TransHE(nn.Module):
    def __init__(self, embed_dim: int = 192, depth: int = 12,
                 num_heads: int = 3, mlp_ratio: int = 4,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.mlp_ratio = mlp_ratio
        self.compute_dtype = compute_dtype
        # the reference's token-masking weight; it never masks at inference
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    @property
    def depth(self) -> int:
        return len(self.blocks)

    def forward(self, tokens, pe, mask=None):
        """tokens (B,C,D); pe (B,C,3) normalised canonical centroids or a
        stored (B,C,D) table; mask an optional (B,C) bool, True where the
        token takes mask_token (JAX ``TransHE.__call__``)."""
        dt = self.compute_dtype
        x = add_position(tokens, pe, mask, self.mask_token, self.embed_dim)
        for blk in self.blocks:
            x = blk(x, dt)
        return layer_norm(self.norm, x, dt)
