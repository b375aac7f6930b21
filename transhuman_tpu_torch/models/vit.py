"""TransHE: a ViT over the ~300 cluster tokens (counterpart of
transhuman_tpu/models/vit.py).

Pre-LN blocks (LayerNorm eps 1e-6), qkv with bias, exact-GELU MLP of ratio 4,
a final LayerNorm.  Attention is a plain matmul and softmax, as in the JAX
package.  The positional code is the stored reference table
(``weights.reference_pe_table``): at embed 192 its top band is pi * 2^31,
where any reformulation of the reference's f32 ops gives other values, so the
table is computed once with the reference's op sequence and added as is.
Names follow the reference state dict (``blocks.0.attn.qkv``, ``norm``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

VARIANTS = {  # embed_dim, num_heads
    "tiny": (192, 3),
    "small": (384, 6),
    "base": (768, 12),
}


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        hd = c // self.num_heads
        q, k, v = self.qkv(x).reshape(b, n, 3, self.num_heads, hd).unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * hd**-0.5
        attn = torch.softmax(attn, dim=-1)
        y = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return self.proj(y)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, dim * mlp_ratio)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TransHE(nn.Module):
    def __init__(self, embed_dim: int = 192, depth: int = 12,
                 num_heads: int = 3, mlp_ratio: int = 4):
        super().__init__()
        self.embed_dim = embed_dim
        # the reference's token-masking weight; it never masks at inference
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio) for _ in range(depth)
        )
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, tokens, pe):
        """tokens (B,C,D); pe (B,C,D) stored table."""
        if pe.shape[-1] != self.embed_dim:
            raise ValueError(
                f"TransHE takes a stored (.., {self.embed_dim}) PE table, got "
                f"{tuple(pe.shape)}"
            )
        x = tokens + pe
        for blk in self.blocks:
            x = blk(x)
        return self.norm(x)
