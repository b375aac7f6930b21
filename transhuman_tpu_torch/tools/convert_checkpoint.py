"""The reference state dict -> the JAX package's Flax parameter tree.

The port's own copy of the numpy-only mapping of
``transhuman_tpu/tools/convert_checkpoint.py`` (``convert_state_dict`` and
``official_key_inventory``, without its command line), so that
``weights.jax_params_from_state_dict`` runs without the JAX package; a test
holds the two equal.

Key mapping (reference module -> flax param path):
  encoder.model.conv1/bn1/layer1/layer2  -> encoder/{conv1,bn1,layer{L}_{B}/*}
  encoder.upsample_color                 -> encoder/color_conv
  encoder.reduction_layer                -> encoder/reduction
  ViT.blocks.N.{norm1,attn,norm2,mlp}    -> transhe/block_N/*
  ViT.norm, ViT.mask_token               -> transhe/{norm,mask_token}
  fc_0 / alpha_res_0                     -> heads/{holder_in,pixel_in}
  spatial_key_value_0.{key,value}_embed  -> heads/fusion/{pix_key,pix_value}
  spatial_key_value_1.{key,value}_embed  -> heads/fusion/{hold_key,hold_value}
  fc_1 fc_2 fc_3 alpha_fc                -> heads/{fc_1,fc_2,fc_3,alpha_out}
  feature_fc rgb_res_0 view_fc rgb_res_1 fc_4 rgb_fc
                                         -> heads/{feature_fc,rgb_res0,view_fc,
                                                   rgb_res1,fc_4,rgb_out}

Dropped: xyzc_net.* (SparseConvNet), encoder.model.layer3/4 + fc, BatchNorm
running stats, ViT.cls_token, positional-encoding buffers (all dead in the
reference forward).  Layout transforms: torch Conv2d OIHW -> flax HWIO;
torch Linear/Conv1d (out,in[,1]) -> flax Dense (in,out).
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

DROP_PATTERNS = [
    r"^xyzc_net\.",
    r"^encoder\.model\.(layer3|layer4|fc)\.",
    r"running_mean$",
    r"running_var$",
    r"num_batches_tracked$",
    r"^ViT\.cls_token$",
    r"_freqs$",
    r"_phases$",
    r"^encoder\.PE_color\.",
]


def _conv2d(w):  # OIHW -> HWIO
    return np.transpose(np.asarray(w), (2, 3, 1, 0))


def _dense(w):  # (out, in) or (out, in, 1) -> (in, out)
    w = np.asarray(w)
    if w.ndim == 3:
        w = w[:, :, 0]
    return np.transpose(w, (1, 0))


def _set(tree: Dict, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = np.asarray(value, np.float32)


def official_key_inventory(vit_depth: int = 12) -> Dict[str, tuple]:
    """The COMPLETE state-dict key inventory of the reference `Network()`
    (cross_transformer.py:84-128) at the official config's real shapes
    (train_or_eval.yaml: vit_depth=12, embed_size=192, KNN_FREQ=10,
    img_feat_size=256) — every tensor `torch.save` would emit, including the
    modules this converter deliberately drops (xyzc_net.*, resnet layer3/4,
    BN running stats, PE buffers).  This is the conversion drill's oracle:
    `convert_state_dict(sd, strict=True)` over a state dict with exactly
    these keys must succeed with zero unknown keys.

    spconv SubMConv3d/SparseConv3d weights are assumed in
    spconv-2.x (out, kx, ky, kz, in) layout; they are dropped either way.
    """
    inv: Dict[str, tuple] = {}
    d = 192  # vit_tiny embed dim (vision_transformer.py:404-406)

    # --- ViT (vision_transformer.py:309-341; PE buffers :115-122)
    inv["ViT.cls_token"] = (1, 1, d)
    inv["ViT.mask_token"] = (1, 1, d)
    inv["ViT.PE._freqs"] = (1, 2 * (d // 6), 1)
    inv["ViT.PE._phases"] = (1, 2 * (d // 6), 1)
    for i in range(vit_depth):
        b = f"ViT.blocks.{i}"
        inv[f"{b}.norm1.weight"] = (d,)
        inv[f"{b}.norm1.bias"] = (d,)
        inv[f"{b}.attn.qkv.weight"] = (3 * d, d)
        inv[f"{b}.attn.qkv.bias"] = (3 * d,)
        inv[f"{b}.attn.proj.weight"] = (d, d)
        inv[f"{b}.attn.proj.bias"] = (d,)
        inv[f"{b}.norm2.weight"] = (d,)
        inv[f"{b}.norm2.bias"] = (d,)
        inv[f"{b}.mlp.fc1.weight"] = (4 * d, d)
        inv[f"{b}.mlp.fc1.bias"] = (4 * d,)
        inv[f"{b}.mlp.fc2.weight"] = (d, 4 * d)
        inv[f"{b}.mlp.fc2.bias"] = (d,)
    inv["ViT.norm.weight"] = (d,)
    inv["ViT.norm.bias"] = (d,)

    # --- encoder: full torchvision resnet18 minus fc/avgpool (encoder.py:
    # 77-84: `model.fc = nn.Sequential()`), plus the color/reduction convs
    # and the unused PE_color buffers (encoder.py:93-97)
    def bn(name, ch):
        inv[f"{name}.weight"] = (ch,)
        inv[f"{name}.bias"] = (ch,)
        inv[f"{name}.running_mean"] = (ch,)
        inv[f"{name}.running_var"] = (ch,)
        inv[f"{name}.num_batches_tracked"] = ()

    inv["encoder.model.conv1.weight"] = (64, 3, 7, 7)
    bn("encoder.model.bn1", 64)
    chans = {"layer1": (64, 64), "layer2": (64, 128),
             "layer3": (128, 256), "layer4": (256, 512)}
    for layer, (cin, cout) in chans.items():
        for blk in range(2):
            base = f"encoder.model.{layer}.{blk}"
            c_in = cin if blk == 0 else cout
            inv[f"{base}.conv1.weight"] = (cout, c_in, 3, 3)
            bn(f"{base}.bn1", cout)
            inv[f"{base}.conv2.weight"] = (cout, cout, 3, 3)
            bn(f"{base}.bn2", cout)
            if blk == 0 and cin != cout:  # layers 2-4 downsample
                inv[f"{base}.downsample.0.weight"] = (cout, c_in, 1, 1)
                bn(f"{base}.downsample.1", cout)
    inv["encoder.reduction_layer.weight"] = (d, 256 + 128, 1, 1)
    inv["encoder.reduction_layer.bias"] = (d,)
    inv["encoder.PE_color._freqs"] = (1, 20, 1)
    inv["encoder.PE_color._phases"] = (1, 20, 1)
    inv["encoder.upsample_color.weight"] = (128, 3, 1, 1)
    inv["encoder.upsample_color.bias"] = (128,)

    # --- cross-attention key/value embeds (cross_transformer.py:31-40)
    for i in (0, 1):
        inv[f"spatial_key_value_{i}.key_embed.weight"] = (128, 256, 1)
        inv[f"spatial_key_value_{i}.key_embed.bias"] = (128,)
        inv[f"spatial_key_value_{i}.value_embed.weight"] = (256, 256, 1)
        inv[f"spatial_key_value_{i}.value_embed.bias"] = (256,)

    # --- xyzc_net SparseConvNet, dead code but serialized
    # (cross_transformer.py:355-372; helper convs :440-500)
    def sp_bn(name, ch):
        bn(name, ch)

    def sp_seq(base, cin, cout, n_convs):
        # SparseSequential indices: conv at 0/3/6, BN at 1/4/7 (ReLU empty)
        for j in range(n_convs):
            c = cin if j == 0 else cout
            inv[f"{base}.{3 * j}.weight"] = (cout, 3, 3, 3, c)
            sp_bn(f"{base}.{3 * j + 1}", cout)

    sp_seq("xyzc_net.conv0", d, 64, 2)
    sp_seq("xyzc_net.down0", 64, 64, 1)
    sp_seq("xyzc_net.conv1", 64, 64, 2)
    sp_seq("xyzc_net.down1", 64, 64, 1)
    sp_seq("xyzc_net.conv2", 64, 64, 3)
    sp_seq("xyzc_net.down2", 64, 128, 1)
    sp_seq("xyzc_net.conv3", 128, 128, 3)
    sp_seq("xyzc_net.down3", 128, 128, 1)
    sp_seq("xyzc_net.conv4", 128, 128, 3)

    # --- DPaRF PE buffers + the NeRF head Conv1ds
    # (cross_transformer.py:107-128; KNN_FREQ=10 -> fc_0 in = 192+63)
    inv["PE_relative._freqs"] = (1, 20, 1)
    inv["PE_relative._phases"] = (1, 20, 1)
    heads = {
        "fc_0": (256, d + 63), "fc_1": (256, 256), "fc_2": (256, 256),
        "alpha_fc": (1, 256), "feature_fc": (256, 256),
        "view_fc": (128, 283), "rgb_fc": (3, 128), "fc_3": (256, 256),
        "fc_4": (128, 128), "alpha_res_0": (256, 384),
        "rgb_res_0": (256, 384), "rgb_res_1": (128, 384),
    }
    for name, (o, i) in heads.items():
        inv[f"{name}.weight"] = (o, i, 1)
        inv[f"{name}.bias"] = (o,)
    return inv


def convert_state_dict(sd: Dict[str, "np.ndarray"], strict: bool = False) -> Dict:
    """sd: reference state_dict (tensors or ndarrays) -> {'params': {...}}.

    strict=True raises on any key that is neither mapped nor on the
    documented drop list (the official-checkpoint drill)."""
    sd = {
        re.sub(r"^(module\.|net\.)+", "", k): np.asarray(
            v.detach().cpu().numpy() if hasattr(v, "detach") else v
        )
        for k, v in sd.items()
    }
    params: Dict = {}
    dropped, unknown = [], []

    def bn(dst, src):
        _set(params, dst + ("scale",), sd[src + ".weight"])
        _set(params, dst + ("bias",), sd[src + ".bias"])

    def conv(dst, src, bias=True):
        _set(params, dst + ("kernel",), _conv2d(sd[src + ".weight"]))
        if bias:
            _set(params, dst + ("bias",), sd[src + ".bias"])

    def dense(dst, src):
        _set(params, dst + ("kernel",), _dense(sd[src + ".weight"]))
        _set(params, dst + ("bias",), sd[src + ".bias"])

    # ---- encoder
    conv(("encoder", "conv1"), "encoder.model.conv1", bias=False)
    bn(("encoder", "bn1"), "encoder.model.bn1")
    for layer, blocks in (("layer1", 2), ("layer2", 2)):
        for b in range(blocks):
            base = f"encoder.model.{layer}.{b}"
            dst = ("encoder", f"{layer}_{b}")
            conv(dst + ("conv1",), base + ".conv1", bias=False)
            bn(dst + ("bn1",), base + ".bn1")
            conv(dst + ("conv2",), base + ".conv2", bias=False)
            bn(dst + ("bn2",), base + ".bn2")
            if f"{base}.downsample.0.weight" in sd:
                conv(dst + ("down_conv",), base + ".downsample.0", bias=False)
                bn(dst + ("down_bn",), base + ".downsample.1")
    conv(("encoder", "color_conv"), "encoder.upsample_color")
    conv(("encoder", "reduction"), "encoder.reduction_layer")

    # ---- TransHE ViT
    _set(params, ("transhe", "mask_token"), np.asarray(sd["ViT.mask_token"]))
    depth = 1 + max(
        int(m.group(1))
        for k in sd
        if (m := re.match(r"ViT\.blocks\.(\d+)\.", k))
    )
    for i in range(depth):
        base = f"ViT.blocks.{i}"
        dst = ("transhe", f"block_{i}")
        _set(params, dst + ("norm1", "scale"), sd[base + ".norm1.weight"])
        _set(params, dst + ("norm1", "bias"), sd[base + ".norm1.bias"])
        dense(dst + ("attn", "qkv"), base + ".attn.qkv")
        dense(dst + ("attn", "proj"), base + ".attn.proj")
        _set(params, dst + ("norm2", "scale"), sd[base + ".norm2.weight"])
        _set(params, dst + ("norm2", "bias"), sd[base + ".norm2.bias"])
        dense(dst + ("mlp_fc1",), base + ".mlp.fc1")
        dense(dst + ("mlp_fc2",), base + ".mlp.fc2")
    _set(params, ("transhe", "norm", "scale"), sd["ViT.norm.weight"])
    _set(params, ("transhe", "norm", "bias"), sd["ViT.norm.bias"])

    # ---- heads
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
    for src, dst in head_map.items():
        dense(("heads",) + dst, src)

    # ---- audit unmapped keys
    consumed = set()

    def mark(prefixes):
        for k in sd:
            if any(k.startswith(p) for p in prefixes):
                consumed.add(k)

    mark(["encoder.model.conv1", "encoder.model.bn1", "encoder.model.layer1",
          "encoder.model.layer2", "encoder.upsample_color",
          "encoder.reduction_layer", "ViT.", "fc_", "alpha_", "feature_fc",
          "rgb_", "view_fc", "spatial_key_value_"])
    for k in sd:
        if k in consumed:
            continue
        if any(re.search(p, k) for p in DROP_PATTERNS):
            dropped.append(k)
        else:
            unknown.append(k)
    if unknown:
        if strict:
            raise ValueError(
                f"{len(unknown)} keys neither mapped nor on the drop list: "
                f"{unknown[:10]}"
            )
        print(f"WARNING: {len(unknown)} unmapped keys, e.g. {unknown[:5]}")
    return {"params": params}
