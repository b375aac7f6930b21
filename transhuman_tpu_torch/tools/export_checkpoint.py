"""The JAX package's Flax parameter tree -> a reference-layout state dict.

The port's own copy of the numpy-only mapping of
``transhuman_tpu/tools/export_checkpoint.py`` (``export_state_dict``, without
its command line), the inverse of ``convert_checkpoint.convert_state_dict``,
so that ``weights.state_dict_from_jax`` runs without the JAX package; a test
holds the two equal.

The emitted state dict carries the complete key inventory the reference
``Network()`` serializes (``official_key_inventory``): the mapped weights
(flax Dense (in, out) -> torch Conv1d/Linear (out, in[, 1]); flax conv HWIO
-> torch OIHW), the PE buffers rebuilt with the reference's formulas,
identity BatchNorm running stats, and zero-filled dead modules
(``xyzc_net.*``, resnet layer3/4/fc, ``ViT.cls_token``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .convert_checkpoint import official_key_inventory


def _conv2d_inv(w):  # HWIO -> OIHW
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _dense_inv(w, conv1d: bool):  # (in, out) -> (out, in[, 1])
    w = np.transpose(np.asarray(w), (1, 0))
    return w[:, :, None] if conv1d else w


def _get(tree, path):
    node = tree
    for p in path:
        node = node[p]
    return np.asarray(node, np.float32)


def _pe_buffers(n_freqs: int):
    """pixelNeRF PositionalEncoding registered buffers
    (vision_transformer.py:115-122)."""
    freqs = np.pi * 2.0 ** np.arange(n_freqs, dtype=np.float32)
    _freqs = np.repeat(freqs, 2).reshape(1, -1, 1)
    _phases = np.zeros(2 * n_freqs, np.float32)
    _phases[1::2] = np.pi * 0.5
    return _freqs, _phases.reshape(1, -1, 1)


def export_state_dict(params: Dict, vit_depth: int = 12) -> Dict[str, np.ndarray]:
    """params: flax param tree (the converter's `variables['params']`) ->
    complete reference state dict (numpy values; torch-ify at save)."""
    sd: Dict[str, np.ndarray] = {}

    def bn(src, dst):
        sd[dst + ".weight"] = _get(params, src + ("scale",))
        sd[dst + ".bias"] = _get(params, src + ("bias",))

    def conv(src, dst, bias=True):
        sd[dst + ".weight"] = _conv2d_inv(_get(params, src + ("kernel",)))
        if bias:
            sd[dst + ".bias"] = _get(params, src + ("bias",))

    def dense(src, dst, conv1d=True):
        sd[dst + ".weight"] = _dense_inv(_get(params, src + ("kernel",)), conv1d)
        sd[dst + ".bias"] = _get(params, src + ("bias",))

    # ---- encoder (inverse of convert_state_dict's encoder block)
    conv(("encoder", "conv1"), "encoder.model.conv1", bias=False)
    bn(("encoder", "bn1"), "encoder.model.bn1")
    for layer in ("layer1", "layer2"):
        for b in range(2):
            src = ("encoder", f"{layer}_{b}")
            dst = f"encoder.model.{layer}.{b}"
            conv(src + ("conv1",), dst + ".conv1", bias=False)
            bn(src + ("bn1",), dst + ".bn1")
            conv(src + ("conv2",), dst + ".conv2", bias=False)
            bn(src + ("bn2",), dst + ".bn2")
            if "down_conv" in params["encoder"][f"{layer}_{b}"]:
                conv(src + ("down_conv",), dst + ".downsample.0", bias=False)
                bn(src + ("down_bn",), dst + ".downsample.1")
    conv(("encoder", "color_conv"), "encoder.upsample_color")
    conv(("encoder", "reduction"), "encoder.reduction_layer")

    # ---- TransHE ViT
    sd["ViT.mask_token"] = _get(params, ("transhe", "mask_token"))
    for i in range(vit_depth):
        src = ("transhe", f"block_{i}")
        dst = f"ViT.blocks.{i}"
        sd[dst + ".norm1.weight"] = _get(params, src + ("norm1", "scale"))
        sd[dst + ".norm1.bias"] = _get(params, src + ("norm1", "bias"))
        dense(src + ("attn", "qkv"), dst + ".attn.qkv", conv1d=False)
        dense(src + ("attn", "proj"), dst + ".attn.proj", conv1d=False)
        sd[dst + ".norm2.weight"] = _get(params, src + ("norm2", "scale"))
        sd[dst + ".norm2.bias"] = _get(params, src + ("norm2", "bias"))
        dense(src + ("mlp_fc1",), dst + ".mlp.fc1", conv1d=False)
        dense(src + ("mlp_fc2",), dst + ".mlp.fc2", conv1d=False)
    sd["ViT.norm.weight"] = _get(params, ("transhe", "norm", "scale"))
    sd["ViT.norm.bias"] = _get(params, ("transhe", "norm", "bias"))

    # ---- heads (inverse of the converter's head_map; all torch Conv1d)
    head_map = {
        "fc_0": ("holder_in",),
        "alpha_res_0": ("pixel_in",),
        "spatial_key_value_0.key_embed": ("fusion", "pix_key"),
        "spatial_key_value_0.value_embed": ("fusion", "pix_value"),
        "spatial_key_value_1.key_embed": ("fusion", "hold_key"),
        "spatial_key_value_1.value_embed": ("fusion", "hold_value"),
        "fc_1": ("fc_1",),
        "fc_2": ("fc_2",),
        "fc_3": ("fc_3",),
        "alpha_fc": ("alpha_out",),
        "feature_fc": ("feature_fc",),
        "rgb_res_0": ("rgb_res0",),
        "view_fc": ("view_fc",),
        "rgb_res_1": ("rgb_res1",),
        "fc_4": ("fc_4",),
        "rgb_fc": ("rgb_out",),
    }
    for dst, src in head_map.items():
        dense(("heads",) + src, dst, conv1d=True)

    # ---- complete the inventory: buffers, running stats, dead modules
    embed_dim = sd["ViT.norm.weight"].shape[0]
    for name, nf in (
        ("ViT.PE", embed_dim // 6),
        ("encoder.PE_color", 10),
        ("PE_relative", 10),
    ):
        fr, ph = _pe_buffers(nf)
        sd[name + "._freqs"] = fr
        sd[name + "._phases"] = ph

    for k, shape in official_key_inventory(vit_depth).items():
        if k in sd:
            continue
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros((), np.int64)
        elif k.endswith("running_var"):
            sd[k] = np.ones(shape, np.float32)
        elif k.endswith("running_mean"):
            sd[k] = np.zeros(shape, np.float32)
        else:  # xyzc_net.*, resnet layer3/4, ViT.cls_token — dead code
            sd[k] = np.zeros(shape, np.float32)
    return sd
