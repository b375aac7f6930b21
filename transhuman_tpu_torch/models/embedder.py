"""Sin/cos frequency encodings (counterpart of transhuman_tpu/models/embedder.py).

For each frequency f the code holds sin(f*x) over the whole input vector,
then cos(f*x): [x?, sin(f0 x), cos(f0 x), sin(f1 x), ...].
"""

from __future__ import annotations

import numpy as np
import torch


def freq_encode(x, num_freqs: int, freq_factor: float = 1.0,
                include_input: bool = True):
    """x (..., D) -> (..., [D +] 2*num_freqs*D), f_k = freq_factor * 2**k."""
    # the bands are formed in float64 and rounded once, as the JAX package does
    freqs = torch.tensor(freq_factor * 2.0 ** np.arange(num_freqs),
                         dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., F, D)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., F, 2, D)
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def embed_viewdir(d, num_freqs: int = 4):
    """View-direction code: 27-d at 4 frequencies."""
    return freq_encode(d, num_freqs, freq_factor=1.0, include_input=True)


def embed_dparf(x, num_freqs: int = 10):
    """DPaRF local-coordinate code: pi-scaled frequencies, input first; 63-d."""
    return freq_encode(x, num_freqs, freq_factor=float(np.pi),
                       include_input=True)


def embed_vit_pos(x, embed_dim: int):
    """TransHE's positional code of the normalised canonical cluster
    centroids: pi-scaled frequencies, no input, embed_dim // 6 frequencies
    -> embed_dim channels."""
    if embed_dim % 6 != 0:
        raise ValueError(
            f"embed_vit_pos requires embed_dim % 6 == 0, got {embed_dim} "
            "(each frequency contributes sin+cos over 3 coords).")
    return freq_encode(x, embed_dim // 6, freq_factor=float(np.pi),
                       include_input=False)
