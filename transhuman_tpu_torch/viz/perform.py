"""Free-viewpoint frame writer (counterpart of
transhuman_tpu/viz/perform.py, the reference's ``if_nerf_perform``): the
predicted ray colours scattered into the full H x W frame, saved as a PNG."""

from __future__ import annotations

import os

import numpy as np

from ..registry import VISUALIZERS
from ..utils.png import write_png


@VISUALIZERS.register("perform")
class PerformVisualizer:
    def __init__(self, out_dir: str, white_bkgd: bool = False):
        self.out_dir = out_dir
        self.white_bkgd = white_bkgd
        os.makedirs(out_dir, exist_ok=True)

    def visualize(self, rgb_pred, mask_at_box, hw, frame_index: int,
                  human: str = "") -> str:
        """rgb_pred (R, 3) colours of the rays in the box; mask_at_box
        (H*W,); returns the path written."""
        h, w = hw
        img = np.full((h * w, 3), 1.0 if self.white_bkgd else 0.0, np.float32)
        img[np.asarray(mask_at_box)] = np.asarray(rgb_pred)
        d = os.path.join(self.out_dir, human) if human else self.out_dir
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"frame{frame_index:04d}.png")
        write_png(path, img.reshape(h, w, 3))
        return path
