"""Shared building blocks (counterpart of transhuman_tpu/models/layers.py).

These take NCHW tensors, the layout the encoder uses inside; the encoder's
public inputs and outputs stay NHWC like the JAX package's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class BatchStatNorm(nn.Module):
    """BatchNorm that always normalises by the statistics of the batch it is
    given, at evaluation too: the reference runs its BatchNorms in train mode
    everywhere.  ``nn.BatchNorm2d`` in ``eval()`` would use running averages
    instead, so it is not used.  Parameters keep BatchNorm's names."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, x):  # (N, C, H, W)
        red = (0, 2, 3)
        mean = x.mean(dim=red)
        mean2 = (x * x).mean(dim=red)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        return x * inv[None, :, None, None] + shift[None, :, None, None]


def upsample_align_corners(x, out_hw):
    """Bilinear align-corners resize of NCHW x to out_hw."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=True)


def max_pool_3x3_s2(x):
    """MaxPool2d(kernel 3, stride 2, padding 1) on NCHW x."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
