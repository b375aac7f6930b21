"""Weights carried across: the reference state-dict layout and the TransHE
PE table.

``TransHumanNet``'s parameters carry the reference checkpoint's key names
(``encoder.model.conv1.weight``, ``ViT.blocks.0.attn.qkv.weight``,
``fc_0.weight`` ...).  A reference-layout state dict (an official ``.pth``,
or ``tools/export_checkpoint.py``'s output) also holds tensors that no
forward reads; :func:`load_reference_state_dict` drops exactly those
(``DEAD_KEY_PATTERNS``) and loads the rest with ``strict=True``, so a missing
or unknown live tensor is an error.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .tools.convert_checkpoint import DROP_PATTERNS, convert_state_dict
from .tools.export_checkpoint import export_state_dict

# dead in the reference forward: its unused SparseConvNet, ResNet stages 3-4
# and fc, ViT.cls_token, BatchNorm running statistics (BN always runs on batch
# statistics) and the PE modules' constant buffers
DEAD_KEY_PATTERNS = tuple(DROP_PATTERNS)


def live_state_dict(sd: dict) -> dict:
    """Strip ``module.``/``net.`` prefixes and drop the dead keys."""
    out = {}
    for k, v in sd.items():
        k = re.sub(r"^(module\.|net\.)+", "", k)
        if any(re.search(p, k) for p in DEAD_KEY_PATTERNS):
            continue
        out[k] = torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v
    return out


def load_reference_state_dict(model: torch.nn.Module, sd: dict):
    """Load a reference-layout state dict into ``model``, strictly."""
    model.load_state_dict(live_state_dict(sd), strict=True)


def load_checkpoint_file(model: torch.nn.Module, path: str) -> int:
    """Load a reference-layout ``.pth`` ({'net': state_dict, 'epoch': N} or
    a bare state dict) or a JAX package ``.ckpt`` into ``model`` (weights
    only); returns the epoch (-1 if absent)."""
    from .train.checkpoint import read_checkpoint

    ckpt = read_checkpoint(path, len(model.ViT.blocks))
    load_reference_state_dict(model, ckpt["net"])
    return ckpt["epoch"]


def state_dict_from_jax(params_np: dict, vit_depth: int) -> dict:
    """The JAX package's parameters (a nested dict of numpy arrays, i.e. the
    Flax ``params`` tree) as a reference-layout state dict of tensors, through
    the port's copy of the numpy-only mapping
    (``tools/export_checkpoint.py::export_state_dict``)."""
    sd = export_state_dict(params_np, vit_depth)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def jax_params_from_state_dict(sd: dict) -> dict:
    """The inverse of :func:`state_dict_from_jax`: a reference-layout state
    dict (parameters, or anything keyed and shaped like them, such as their
    gradients) as the JAX package's ``{'params': ...}`` tree of numpy
    arrays, through the port's copy of the numpy-only converter
    (``tools/convert_checkpoint.py::convert_state_dict``)."""
    return convert_state_dict(
        {k: v.detach().cpu().numpy() for k, v in sd.items()}, strict=True)


def reference_pe_table(pe_xyz_norm, embed_dim: int) -> np.ndarray:
    """TransHE positional-encoding table (C, embed_dim) with the reference's
    exact f32 op sequence (``vision_transformer.PositionalEncoding``:
    ``sin(addcmul(phases, x.repeat, freqs))``).  At embed 192 the top band is
    pi * 2^31, where any reordering of these ops gives other values; the
    reference weights were trained against these, so the table is stored and
    reused as is.  Equal bit for bit to
    ``transhuman_tpu/tools/convert_checkpoint.py::reference_pe_table``."""
    nf = embed_dim // 6
    x = torch.from_numpy(np.asarray(pe_xyz_norm, np.float32))
    freqs = np.pi * 2.0 ** torch.arange(nf, dtype=torch.float32)
    _freqs = torch.repeat_interleave(freqs, 2).view(1, -1, 1)
    _phases = torch.zeros(2 * nf)
    _phases[1::2] = np.pi * 0.5
    emb = x.unsqueeze(1).repeat(1, nf * 2, 1)
    emb = torch.sin(torch.addcmul(_phases.view(1, -1, 1), emb, _freqs))
    return emb.view(x.shape[0], -1).numpy()
