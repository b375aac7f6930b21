"""Multi-scale CNN image encoder (counterpart of transhuman_tpu/models/encoder.py).

ResNet-18 stem and its first two residual stages; every stage's map is
upsampled (align corners) to the input size and concatenated with a 1x1
"color" conv of the image: 64 + 64 + 128 + 128 = 384 channels of pixel-aligned
features.  A 1x1 reduction to ``embed_dim`` gives the holder map that paints
the SMPL vertices.  Submodule names follow the reference state dict
(``model.layer1.0.conv1``, ``upsample_color``, ``reduction_layer``).  Every
convolution runs in the compute dtype and the maps come out in it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (
    BatchStatNorm,
    conv,
    max_pool_3x3_s2,
    upsample_align_corners,
)


class BasicBlock(nn.Module):
    """ResNet-v1 basic block: 3x3 conv-bn-relu, 3x3 conv-bn, shortcut, relu."""

    def __init__(self, cin: int, cout: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.conv1 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.bn1 = BatchStatNorm(cout)
        self.conv2 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.bn2 = BatchStatNorm(cout)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, cout, 1, stride, bias=False), BatchStatNorm(cout)
            )

    def forward(self, x):
        dt = self.compute_dtype
        y = F.relu(self.bn1(conv(self.conv1, x, dt)))
        y = self.bn2(conv(self.conv2, y, dt))
        idt = x
        if self.downsample is not None:
            idt = self.downsample[1](conv(self.downsample[0], x, dt))
        return F.relu(y + idt)


class ResNetStages(nn.Module):
    """The parts of torchvision's resnet18 that the encoder runs."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchStatNorm(64)
        self.layer1 = nn.Sequential(BasicBlock(64, 64, compute_dtype=dt),
                                    BasicBlock(64, 64, compute_dtype=dt))
        self.layer2 = nn.Sequential(BasicBlock(64, 128, 2, compute_dtype=dt),
                                    BasicBlock(128, 128, compute_dtype=dt))


class SpatialEncoder(nn.Module):
    """images (V,H,W,3) -> holder_map (V,H,W,embed_dim), pixel_map (V,H,W,384)."""

    def __init__(self, embed_dim: int = 192,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.model = ResNetStages(compute_dtype)
        self.upsample_color = nn.Conv2d(3, 128, 1)
        self.reduction_layer = nn.Conv2d(384, embed_dim, 1)

    def forward(self, images):
        dt = self.compute_dtype
        h, w = images.shape[1:3]
        x = images.permute(0, 3, 1, 2)
        m = self.model
        y = F.relu(m.bn1(conv(m.conv1, x, dt)))
        latents = [y]  # (V, 64, H/2, W/2)
        y = m.layer1(max_pool_3x3_s2(y))
        latents.append(y)  # (V, 64, H/4, W/4)
        y = m.layer2(y)
        latents.append(y)  # (V, 128, H/8, W/8)
        latents = [upsample_align_corners(lat, (h, w)) for lat in latents]
        pixel = torch.cat(latents + [conv(self.upsample_color, x, dt)], dim=1)
        holder = conv(self.reduction_layer, pixel, dt)
        return (holder.permute(0, 2, 3, 1).contiguous(),
                pixel.permute(0, 2, 3, 1).contiguous())
