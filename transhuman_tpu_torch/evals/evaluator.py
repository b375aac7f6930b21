"""Per-frame metrics, image dumps and summary files (counterpart of
transhuman_tpu/evals/evaluator.py, the reference's ``if_nerf`` evaluator),
without OpenCV.

MSE and PSNR over the masked ray colours; SSIM on the images cropped to the
bounding box of the rendered region, at data range 2.0 (the headline, the
reference's) and 1.0 (``ssim_dr1``); pred/gt/input PNGs per human;
``summarize`` writes the per-frame ``.npy`` arrays and ``summary.txt`` and
resets the lists.  LPIPS, when an ``lpips_fn`` is given
(``cli/run.py::make_eval_lpips_fn``), is taken on the bounding-box crop
itself: the port's shapes are dynamic, so the JAX package's zero-padded
size buckets (whose masked distance equals the unpadded one) have no job
here.  Without one the summary says ``n/a``, as the JAX evaluator's does.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..registry import EVALUATORS
from ..utils.png import write_png
from . import metrics


def bounding_rect(mask: np.ndarray):
    """(x, y, w, h) of the nonzero pixels of a 2-D mask, (0, 0, 0, 0) when
    there are none (``cv2.boundingRect``'s result)."""
    rows = np.flatnonzero(mask.any(axis=1))
    cols = np.flatnonzero(mask.any(axis=0))
    if rows.size == 0:
        return 0, 0, 0, 0
    return (int(cols[0]), int(rows[0]), int(cols[-1] - cols[0] + 1),
            int(rows[-1] - rows[0] + 1))


@EVALUATORS.register("if_nerf")
class Evaluator:
    def __init__(self, result_dir: str, lpips_fn=None,
                 save_images: bool = True, exp_name: str = "transhuman_tpu",
                 epoch: int = -1):
        """lpips_fn(a, b): (1, h, w, 3) numpy crops in [-1, 1] -> (1,)
        distances, or None (no LPIPS column)."""
        self.result_dir = result_dir
        self.lpips_fn = lpips_fn
        self.save_images = save_images
        self.exp_name = exp_name
        self.epoch = epoch
        self.mse, self.psnr, self.ssim, self.lpips = [], [], [], []
        self.ssim_dr1 = []

    @staticmethod
    def _reconstruct(rgb, mask_at_box, hw, white_bkgd=False):
        h, w = hw
        img = np.full((h * w, 3), 1.0 if white_bkgd else 0.0, np.float32)
        img[mask_at_box] = rgb
        return img.reshape(h, w, 3)

    def evaluate_frame(self, rgb_pred: np.ndarray, rgb_gt: np.ndarray,
                       mask_at_box: np.ndarray, hw: tuple,
                       human: str = "human", frame_index: int = 0,
                       cam_ind: int = 0,
                       input_imgs: Optional[np.ndarray] = None,
                       white_bkgd: bool = False) -> dict:
        """rgb_pred, rgb_gt (R, 3) for the rays in the box; mask_at_box
        (H*W,) bool; input_imgs (V, H, W, 3) or None."""
        x, y, w, h = bounding_rect(np.asarray(mask_at_box).reshape(hw))
        if len(rgb_pred) == 0 or min(h, w) < 7:
            # an empty mask or a box below the 7x7 SSIM window would give NaN
            # metrics; the reference's skimage raises on it too
            raise ValueError(
                f"degenerate eval frame: human={human} frame={frame_index} "
                f"cam={cam_ind} — mask_at_box has {int(np.sum(mask_at_box))} "
                f"pixels, bbox {w}x{h} (needs >= 7x7 for SSIM). The mask is "
                "empty or nearly so; check the dataset masks/bounds.")
        if self.lpips_fn is not None and min(h, w) < 16:
            # VGG16's four 2x2 pools leave nothing of a side under 16 px at
            # stage 5; checked before any metric is appended, so the lists
            # stay in step for a caller that catches and continues
            raise ValueError(
                f"LPIPS needs a crop >= 16px per side; got {w}x{h} for "
                f"human={human} frame={frame_index} cam={cam_ind}")

        frame_mse = metrics.mse(rgb_pred, rgb_gt)
        self.mse.append(frame_mse)
        self.psnr.append(metrics.psnr(rgb_pred, rgb_gt, from_mse=frame_mse))
        img_pred = self._reconstruct(rgb_pred, mask_at_box, hw, white_bkgd)
        img_gt = self._reconstruct(rgb_gt, mask_at_box, hw, white_bkgd)
        crop_pred = img_pred[y:y + h, x:x + w]
        crop_gt = img_gt[y:y + h, x:x + w]
        s_head, s_dr1 = metrics.ssim_multi(crop_pred, crop_gt, (2.0, 1.0))
        self.ssim.append(s_head)
        self.ssim_dr1.append(s_dr1)
        if self.lpips_fn is not None:
            lp = self.lpips_fn(crop_pred[None] * 2.0 - 1.0,
                               crop_gt[None] * 2.0 - 1.0)
            self.lpips.append(float(np.asarray(lp).reshape(())))

        if self.save_images:
            hdir = os.path.join(self.result_dir, human)
            for sub in ("pred", "gt", "input"):
                os.makedirs(os.path.join(hdir, sub), exist_ok=True)
            write_png(f"{hdir}/pred/frame{frame_index}_view{cam_ind}.png",
                      crop_pred)
            write_png(f"{hdir}/gt/frame{frame_index}_view{cam_ind}_gt.png",
                      crop_gt)
            if input_imgs is not None:
                for v, im in enumerate(input_imgs):
                    write_png(
                        f"{hdir}/input/frame{frame_index}_t_0_view_{v}.png",
                        im)
        return {"mse": self.mse[-1], "psnr": self.psnr[-1],
                "ssim": self.ssim[-1],
                "lpips": self.lpips[-1] if self.lpips else None}

    def summarize(self, write: bool = True) -> dict:
        if write:
            os.makedirs(self.result_dir, exist_ok=True)
            for name in ("mse", "psnr", "ssim", "lpips"):
                np.save(os.path.join(self.result_dir, f"{name}.npy"),
                        getattr(self, name))
        out = {
            "experiment": self.exp_name,
            "epoch": self.epoch,
            "mse": float(np.mean(self.mse)) if self.mse else None,
            "psnr": float(np.mean(self.psnr)) if self.psnr else None,
            "ssim": float(np.mean(self.ssim)) if self.ssim else None,
            "lpips": float(np.mean(self.lpips)) if self.lpips else None,
        }
        # loud in the summary, not a None that reads like "LPIPS = 0"
        text = dict(out)
        if self.lpips_fn is None and out["lpips"] is None:
            text["lpips"] = "n/a (no VGG weights — set cfg.lpips_weights)"
        if self.ssim_dr1:
            text["ssim(data_range=1.0)"] = float(np.mean(self.ssim_dr1))
        if write:
            with open(os.path.join(self.result_dir, "summary.txt"), "w") as f:
                f.writelines(f"{k}: {v}\n" for k, v in text.items())
        self.mse, self.psnr, self.ssim, self.lpips = [], [], [], []
        self.ssim_dr1 = []
        return out


def merge_across_processes(ev: Evaluator, positions, mesh) -> Evaluator:
    """Frame-sharded evaluation (cli/run.py): every rank's per-frame metric
    lists, gathered into each rank's evaluator in the frames' global order,
    so that ``summarize`` gives the single-process summary and ``.npy``
    files (JAX evaluator.merge_across_processes).  ``positions[i]`` is the
    FrameSampler position of the i-th frame this rank evaluated.  Every
    rank must call it; in one process it changes nothing."""
    from ..parallel.mesh import gather_positioned

    if mesh is None or mesh.size == 1:
        return ev
    for name in ("mse", "psnr", "ssim", "ssim_dr1", "lpips"):
        vals = getattr(ev, name)
        # lpips is either per-frame or absent (no weights) on every rank
        setattr(ev, name, gather_positioned(vals, positions[:len(vals)],
                                            mesh))
    return ev
