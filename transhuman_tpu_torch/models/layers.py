"""Shared building blocks (counterpart of transhuman_tpu/models/layers.py).

These take NCHW tensors, the layout the encoder uses inside; the encoder's
public inputs and outputs stay NHWC like the JAX package's.  ``linear`` and
``conv`` cast their input, weight and bias to the compute dtype, as Flax's
``promote_dtype`` does for a layer with ``dtype`` set; in float32 the casts
are no-ops.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


def linear(x, weight, bias, dtype):
    """F.linear in ``dtype``: a Flax Dense with that dtype."""
    return F.linear(x.to(dtype), weight.to(dtype), _cast(bias, dtype))


def conv(module: nn.Conv2d, x, dtype):
    """``module`` applied in ``dtype``: a Flax Conv with that dtype."""
    return module._conv_forward(x.to(dtype), module.weight.to(dtype),
                                _cast(module.bias, dtype))


def layer_norm(module: nn.LayerNorm, x, dtype):
    """``module`` with float32 statistics, returned in ``dtype``: a Flax
    LayerNorm with that dtype."""
    return F.layer_norm(x.float(), module.normalized_shape, module.weight,
                        module.bias, module.eps).to(dtype)


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
        """Statistics and the affine map in float32; the result in x's
        dtype (the compute dtype of the conv before it)."""
        xf = x.float()
        red = (0, 2, 3)
        mean = xf.mean(dim=red)
        mean2 = (xf * xf).mean(dim=red)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        inv = torch.rsqrt(var + self.eps) * self.weight
        shift = self.bias - mean * inv
        y = xf * inv[None, :, None, None] + shift[None, :, None, None]
        return y.to(x.dtype)


def interp_matrix(n_out: int, n_in: int, device=None,
                  dtype=torch.float32):
    """(n_out, n_in) align-corners linear interpolation matrix in dtype,
    formed on ``device`` (no host copy, so no wait for the card) with the
    JAX package's layers._interp_matrix operations: float64 positions, the
    fractions rounded to float32."""
    if n_in == 1:
        return torch.ones((n_out, 1), dtype=dtype, device=device)
    pos = (torch.arange(n_out, dtype=torch.float64, device=device)
           * (n_in - 1) / max(n_out - 1, 1))
    lo = torch.floor(pos).long()
    hi = torch.clamp_max(lo + 1, n_in - 1)
    w = (pos - lo).float()
    rows = torch.arange(n_out, device=device)
    m = torch.zeros((n_out, n_in), dtype=torch.float32, device=device)
    m.index_put_((rows, lo), 1.0 - w, accumulate=True)
    m.index_put_((rows, hi), w, accumulate=True)
    return m.to(dtype)


def upsample_align_corners(x, out_hw):
    """Bilinear align-corners resize of NCHW x to out_hw.  float32 through
    F.interpolate; a lower precision as the JAX package computes it there:
    two products with the interpolation matrices rounded to x's dtype,
    each rounded to it (F.interpolate would blend in float32 and round
    once)."""
    if tuple(x.shape[2:]) == tuple(out_hw):
        return x
    if x.dtype == torch.float32:
        return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                             align_corners=True)
    (h_in, w_in), (h_out, w_out) = x.shape[2:], out_hw
    x = torch.matmul(interp_matrix(h_out, h_in, x.device, x.dtype), x)
    return torch.matmul(x, interp_matrix(w_out, w_in, x.device, x.dtype).t())


def max_pool_3x3_s2(x):
    """MaxPool2d(kernel 3, stride 2, padding 1) on NCHW x."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
