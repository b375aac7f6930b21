"""Convert torchvision VGG16 + LPIPS linear-head weights to the LPIPS
``.npz`` layout that both packages read (the port's jax-free copy of
transhuman_tpu/tools/convert_lpips.py; a test holds the two equal).

Full conversion (backbone + calibration heads in one .npz):
    python -m transhuman_tpu_torch.tools.convert_lpips \\
        --vgg vgg16_features.pth --lins lpips_vgg_lins.pth out.npz

Lins-only (the reference vendors the heads at
third_parties/lpips/weights/v0.1/vgg.pth; the VGG16 backbone merges in at
load time through ``lpips_backbone``):
    python -m transhuman_tpu_torch.tools.convert_lpips \\
        --lins /path/to/vgg.pth lins_only.npz

``--vgg`` is a torchvision VGG16 ``features`` state dict (keys '0.weight',
'2.weight', ... for the 13 convs); ``--lins`` is the LPIPS calibration state
dict (keys 'lin{i}.model.1.weight', shape (1, C, 1, 1)).  Kernels are
written HWIO, as the JAX package's LPIPS reads them.
"""

from __future__ import annotations

import numpy as np

from ..models.lpips import VGG16_STAGES

# torchvision vgg16.features conv layer indices, in stage order
VGG16_FEATURE_IDX = [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]]


def convert_lins(lins_sd: dict) -> dict:
    """LPIPS lin heads (1,C,1,1) -> flat non-negative per-channel weights."""
    out = {}
    for si, (_, ch) in enumerate(VGG16_STAGES):
        lw = None
        for k in (f"lin{si}.model.1.weight", f"lins.{si}.model.1.weight"):
            if k in lins_sd:
                lw = np.asarray(lins_sd[k])
                break
        assert lw is not None, f"no lin weight for stage {si}"
        lw = lw.reshape(-1).astype(np.float32)
        assert lw.shape == (ch,), f"stage {si}: {lw.shape} != ({ch},)"
        out[f"lin{si}"] = lw
    return out


def convert(vgg_sd: dict | None, lins_sd: dict) -> dict:
    """Full conversion; vgg_sd=None produces a lins-only weight dict."""
    out = convert_lins(lins_sd)
    if vgg_sd is None:
        return out
    for si, idxs in enumerate(VGG16_FEATURE_IDX):
        assert len(idxs) == VGG16_STAGES[si][0]
        for ci, li in enumerate(idxs):
            w = np.asarray(vgg_sd[f"{li}.weight"])  # OIHW
            b = np.asarray(vgg_sd[f"{li}.bias"])
            out[f"conv{si}_{ci}_w"] = np.transpose(w, (2, 3, 1, 0))
            out[f"conv{si}_{ci}_b"] = b
    return out


def load_torch_state_dict(path: str) -> dict:
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=False)
    sd = sd.get("state_dict", sd) if isinstance(sd, dict) else sd
    return {
        k.replace("features.", ""): v.numpy() if hasattr(v, "numpy") else v
        for k, v in sd.items()
    }


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m transhuman_tpu_torch.tools.convert_lpips")
    p.add_argument("--vgg", default=None,
                   help="torchvision VGG16 features .pth; omit for lins-only")
    p.add_argument("--lins", required=True)
    p.add_argument("output")
    args = p.parse_args(argv)

    vgg_sd = load_torch_state_dict(args.vgg) if args.vgg else None
    out = convert(vgg_sd, load_torch_state_dict(args.lins))
    np.savez(args.output, **out)
    kind = "full" if args.vgg else "lins-only"
    print(f"wrote {args.output} ({kind}, {len(out)} arrays)")


if __name__ == "__main__":
    main()
