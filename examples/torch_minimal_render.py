"""Minimal end-to-end novel-view render on synthetic data, in the PyTorch
port (the counterpart of examples/minimal_render.py).

Runs the full TransHuman pipeline -- ResNet view encoding, SMPL painting,
TransHE token refinement, the cull (K1), the pixel-feature fetch (K4),
DPaRF binding (K2), NeRF heads, compositing -- on a synthetic body and
random-init weights, then writes a PNG with the port's own encoder.  No
datasets or pretrained weights are needed; the same code path scales to
the real ZJU assets through the entry points (see README).  It runs on the
card by default (the hand-written kernels); ``--device cpu`` runs their
plain twins on the CPU.

    python examples/torch_minimal_render.py [out.png] [--device cpu]
"""

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from transhuman_tpu_torch.cli.common import configure_device  # noqa: E402
from transhuman_tpu_torch.testing import (  # noqa: E402
    synthetic_rays,
    synthetic_setup,
)
from transhuman_tpu_torch.utils.png import write_png  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("out", nargs="?", default="render.png")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--rays", type=int, default=1024)
    args = p.parse_args(argv)
    device = configure_device(args.device)
    _, pipe, frame, _, _ = synthetic_setup(
        image_hw=(64, 64), n_verts=400, n_clusters=32, n_samples=16,
        chunk_rays=64, embed_dim=48, vit_depth=2, vit_heads=2,
        device=device)
    side = int(args.rays ** 0.5)
    rays = synthetic_rays(side * side)
    with torch.no_grad():
        out = pipe.render_frame(frame.to(device), rays.to(device))
    rgb = out["rgb_map"].float().cpu().numpy().reshape(side, side, 3)
    if not np.isfinite(rgb).all():
        raise SystemExit("the render is not finite")
    write_png(args.out, np.clip(rgb * 255, 0, 255).astype(np.uint8))
    acc = float(out["acc_map"].float().mean())
    stats = pipe.last_frame_stats
    print(f"wrote {args.out}  ({side}x{side}, mean acc {acc:.3f}, decoded "
          f"{stats['survivors']} of {stats['points']} points)  [{device}]")
    return out


if __name__ == "__main__":
    main()
