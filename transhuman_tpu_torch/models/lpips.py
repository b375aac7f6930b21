"""LPIPS perceptual distance with the VGG16 backbone (counterpart of
transhuman_tpu/models/lpips.py; the reference vendors it at
``third_parties/lpips``): inputs in [-1, 1] are shifted and scaled by the
ImageNet statistics, run through VGG16's five conv stages (2x2 max-pools
between them, dropping an odd last row or column), each stage's features
unit-normalised over the channels, their squared differences weighted by the
learned non-negative ``lin`` heads, averaged over space and summed over the
stages.

The module stays outside ``TransHumanNet``: its weights are not in the
model's state dict (a reference ``.pth`` still loads strictly), they are
float32 whatever the model's compute dtype (the JAX package closes over f32
numpy arrays), frozen (``requires_grad=False``) and in no optimizer; the
distance passes gradients to its inputs only.  The convolutions are
``F.conv2d``: the JAX package computes them with ``lax.conv``, outside any
Pallas kernel.  Weights come from the JAX package's converted ``.npz``
layout (``tools/convert_lpips.py``): HWIO kernels, transposed here to
OIHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# VGG16 feature-extractor conv plan: (#convs, channels) per stage
VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def conv_names():
    return [f"conv{si}_{ci}" for si, (n, _) in enumerate(VGG16_STAGES)
            for ci in range(n)]


def load_lpips_params(path: str, backbone: str = "") -> dict:
    """The converted ``.npz`` (tools/convert_lpips.py) as numpy arrays:
    either a full file (13 VGG16 convs + 5 lin heads) or a lins-only file
    merged with the conv tensors of ``backbone``.  A lins-only file without
    a backbone, and a file without the lin heads, are errors: LPIPS needs
    both the pretrained backbone and its calibration heads."""
    with np.load(path) as z:
        params = {k: np.asarray(z[k]) for k in z.files}
    if backbone:
        with np.load(backbone) as z:
            params.update({k: np.asarray(z[k]) for k in z.files
                           if k.startswith("conv")})
    missing = [f"{c}_{t}" for c in conv_names() for t in ("w", "b")
               if f"{c}_{t}" not in params]
    if missing:
        raise ValueError(
            f"LPIPS weights at {path!r} are lins-only ({len(missing)} conv "
            "tensors missing). Convert the torchvision VGG16 IMAGENET1K "
            "`features` state_dict with tools/convert_lpips.py and pass it "
            "as `backbone=` (or cfg.lpips_backbone).")
    missing_lins = [f"lin{si}" for si in range(len(VGG16_STAGES))
                    if f"lin{si}" not in params]
    if missing_lins:
        raise ValueError(
            f"LPIPS weights at {path!r} lack the learned calibration heads "
            f"({', '.join(missing_lins)}). A backbone-only npz is not a "
            "usable LPIPS: convert the reference's "
            "third_parties/lpips/weights/v0.1/vgg.pth with "
            "tools/convert_lpips.py and pass it as the main path (the "
            "backbone npz goes in `backbone=`).")
    return params


def _unit_norm(x, eps: float = 1e-10):
    """Channel unit norm with the vendored double eps:
    ``x / (sqrt(sum(x^2) + eps) + eps)`` (third_parties/lpips/__init__.py)."""
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True) + eps) + eps)


class LPIPS(nn.Module):
    """distance(x, y): (B, H, W, 3) in [-1, 1] -> (B,), in float32."""

    def __init__(self, params: dict):
        super().__init__()
        for name in conv_names():
            w = np.transpose(np.asarray(params[f"{name}_w"], np.float32),
                             (3, 2, 0, 1))  # HWIO -> OIHW
            self.register_parameter(f"{name}_w", nn.Parameter(
                torch.from_numpy(np.ascontiguousarray(w)),
                requires_grad=False))
            self.register_parameter(f"{name}_b", nn.Parameter(
                torch.from_numpy(np.array(params[f"{name}_b"], np.float32)),
                requires_grad=False))
        for si in range(len(VGG16_STAGES)):
            self.register_parameter(f"lin{si}", nn.Parameter(
                torch.from_numpy(np.array(params[f"lin{si}"],
                                          np.float32).reshape(-1)),
                requires_grad=False))
        self.register_buffer("shift", torch.from_numpy(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.from_numpy(_SCALE).view(1, 3, 1, 1))

    @classmethod
    def from_npz(cls, path: str, backbone: str = "") -> "LPIPS":
        return cls(load_lpips_params(path, backbone))

    def stages(self, x):
        """x (B, 3, H, W) in [-1, 1] -> the 5 post-ReLU stage activations."""
        x = (x - self.shift) / self.scale
        outs = []
        for si, (n_convs, _) in enumerate(VGG16_STAGES):
            for ci in range(n_convs):
                x = F.relu(F.conv2d(x, getattr(self, f"conv{si}_{ci}_w"),
                                    getattr(self, f"conv{si}_{ci}_b"),
                                    padding=1))
            outs.append(x)
            if si < len(VGG16_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return outs

    def forward(self, x, y):
        b = x.shape[0]
        both = torch.cat([x, y]).to(torch.float32).permute(0, 3, 1, 2)
        total = 0.0
        for si, f in enumerate(self.stages(both)):
            d = torch.square(_unit_norm(f[:b]) - _unit_norm(f[b:]))
            w = getattr(self, f"lin{si}").view(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * w, dim=1), dim=(1, 2))
        return total


def lpips_module(cfg, device):
    """The frozen LPIPS of cfg.lpips_weights (+ cfg.lpips_backbone) on
    device, or None when cfg.lpips_weights is empty."""
    if not cfg.lpips_weights:
        return None
    return LPIPS.from_npz(cfg.lpips_weights, cfg.lpips_backbone).to(
        device).eval()
