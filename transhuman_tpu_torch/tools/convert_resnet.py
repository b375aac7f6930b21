"""Import torchvision ResNet-18 ImageNet weights into the encoder (the
port's jax-free copy of transhuman_tpu/tools/convert_resnet.py; a test holds
the two equal).

    python -m transhuman_tpu_torch.tools.convert_resnet resnet18.pth out.npz

``convert`` writes the JAX package's npz layout: Flax paths
(``layer1_0/conv1/kernel``) with HWIO kernels, so one file serves both
packages.  ``apply_pretrained`` copies such a file onto the port's encoder,
whose parameters carry the reference's names with OIHW kernels, through the
mapping of ``tools/export_checkpoint.py``.  The encoder uses only the stem
and layer1/layer2; the reduction and colour convs have no pretrained source
and keep their init (reference behaviour: torchvision pretrained=True,
encoder.py:77-79).
"""

from __future__ import annotations

import numpy as np
import torch


def convert(sd: dict) -> dict:
    """torchvision resnet18 state_dict -> flat {path: array} for the encoder."""

    def c(w):  # OIHW -> HWIO
        return np.transpose(np.asarray(w), (2, 3, 1, 0))

    out = {
        "conv1/kernel": c(sd["conv1.weight"]),
        "bn1/scale": np.asarray(sd["bn1.weight"]),
        "bn1/bias": np.asarray(sd["bn1.bias"]),
    }
    for layer in ("layer1", "layer2"):
        for b in range(2):
            base = f"{layer}.{b}"
            dst = f"{layer}_{b}"
            out[f"{dst}/conv1/kernel"] = c(sd[f"{base}.conv1.weight"])
            out[f"{dst}/bn1/scale"] = np.asarray(sd[f"{base}.bn1.weight"])
            out[f"{dst}/bn1/bias"] = np.asarray(sd[f"{base}.bn1.bias"])
            out[f"{dst}/conv2/kernel"] = c(sd[f"{base}.conv2.weight"])
            out[f"{dst}/bn2/scale"] = np.asarray(sd[f"{base}.bn2.weight"])
            out[f"{dst}/bn2/bias"] = np.asarray(sd[f"{base}.bn2.bias"])
            if f"{base}.downsample.0.weight" in sd:
                out[f"{dst}/down_conv/kernel"] = c(
                    sd[f"{base}.downsample.0.weight"])
                out[f"{dst}/down_bn/scale"] = np.asarray(
                    sd[f"{base}.downsample.1.weight"])
                out[f"{dst}/down_bn/bias"] = np.asarray(
                    sd[f"{base}.downsample.1.bias"])
    return out


_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_MODULE = {"down_conv": "downsample.0", "down_bn": "downsample.1"}


def reference_name(path: str) -> str:
    """An npz path (``layer1_0/down_bn/scale``) -> the encoder parameter's
    reference name (``encoder.model.layer1.0.downsample.1.weight``)."""
    *mods, leaf = path.split("/")
    parts = []
    for m in mods:
        if m.startswith("layer"):
            layer, block = m.rsplit("_", 1)
            parts += [layer, block]
        else:
            parts.append(_MODULE.get(m, m))
    return "encoder.model." + ".".join(parts) + "." + _LEAF[leaf]


def apply_pretrained(model: torch.nn.Module, flat: dict) -> torch.nn.Module:
    """Copy converted encoder weights (npz paths, HWIO kernels) into the
    port model's encoder, in place; a name or shape that does not match is
    an error."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for path, arr in flat.items():
            name = reference_name(path)
            a = np.asarray(arr, np.float32)
            if a.ndim == 4:
                a = np.transpose(a, (3, 2, 0, 1))  # HWIO -> OIHW
            if name not in params:
                raise KeyError(f"{path}: the encoder has no {name}")
            p = params[name]
            if tuple(p.shape) != a.shape:
                raise ValueError(f"{path}: {a.shape} != {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return model


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.convert_resnet")
    p.add_argument("input")
    p.add_argument("output")
    args = p.parse_args(argv)
    sd = torch.load(args.input, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() for k, v in sd.items()}
    out = convert(sd)
    np.savez(args.output, **out)
    print(f"wrote {args.output} ({len(out)} arrays)")


if __name__ == "__main__":
    main()
