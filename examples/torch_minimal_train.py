"""Minimal end-to-end training loop on synthetic data, in the PyTorch port
(the counterpart of examples/minimal_train.py).

Runs the real train step -- painting, TransHE, DPaRF (K2), the
pixel-feature fetch (K4) and its backward (K3), NeRF heads, compositing,
patch MSE loss, gradient clip, Adam -- on a tiny synthetic body, printing
the loss as it falls.  No datasets or pretrained weights are needed; the
same step scales to real ZJU assets and to data-, tensor- and ray-parallel
runs through the train entry point (scripts/torch/train.sh).  It runs on
the card by default; ``--device cpu`` runs the kernels' plain twins.

    python examples/torch_minimal_train.py [n_steps] [--device cpu]
"""

import argparse
import math
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from transhuman_tpu_torch.cli.common import (  # noqa: E402
    build_runtime,
    configure_device,
)
from transhuman_tpu_torch.config import Config  # noqa: E402
from transhuman_tpu_torch.data.synthetic import SyntheticDataset  # noqa
from transhuman_tpu_torch.geometry.smpl import SMPLModel  # noqa: E402
from transhuman_tpu_torch.render.pipeline import fold_in  # noqa: E402
from transhuman_tpu_torch.testing import init_weights  # noqa: E402
from transhuman_tpu_torch.train.step import (  # noqa: E402
    TrainState,
    make_optimizer,
    make_train_step,
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    p.add_argument("n_steps", nargs="?", type=int, default=30)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    device = configure_device(args.device)
    cfg = Config().merge_dict({
        "train_num_views": 2,
        "vit_depth": 2,
        "num_class": 16,
        "N_samples": 8,
        "patch": {"N_patches": 2, "size": 8},
        "kmeans_dir": "/nonexistent",  # k-means regenerated on the fly
    })
    smpl = SMPLModel.synthetic(n_verts=120)
    model, pipe, _, _ = build_runtime(cfg, device, smpl=smpl)
    init_weights(model, torch.Generator().manual_seed(cfg.seed))
    ds = SyntheticDataset(cfg, "train", n_frames=4, image_hw=(32, 32),
                          n_verts=120)
    ds.set_epoch(0)
    opt, sched = make_optimizer(model.parameters(), lr=5e-4,
                                warmup_epochs=1, decay_epochs=10**6,
                                iters_per_epoch=10**6)
    state = TrainState(model, opt, sched)
    step = make_train_step(pipe)
    losses = []
    for it in range(args.n_steps):
        batch = [ds.get_train_sample(it % len(ds)).to(device)]
        stats = step(state, batch, fold_in(cfg.seed, it))
        losses.append(stats["loss"])
        if it % 5 == 0 or it == args.n_steps - 1:
            print(f"step {it:3d}  " + "  ".join(
                f"{k}: {float(v):.4f}" for k, v in stats.items()))
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"a loss is not finite: {losses}")
    print(f"done [{device}] -- gradients flow end to end; see cli/train.py "
          "for the distributed, prefetched, checkpointed version of this "
          "loop.")
    return losses


if __name__ == "__main__":
    main()
