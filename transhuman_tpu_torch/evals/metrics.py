"""Image metrics with the reference's semantics (counterpart of
transhuman_tpu/evals/metrics.py, without OpenCV).

* PSNR: -10 log10(mse) over the masked ray set.
* SSIM: skimage ``structural_similarity`` (multichannel) semantics: 7x7
  uniform windows, sample covariance (N / (N - 1)), the map cropped by the
  window radius, the mean over channels; skimage's data_range 2.0 for float
  inputs, which the reference's published numbers use (1.0 is the strictly
  correct value for [0, 1] images).
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view


def mse(pred: np.ndarray, gt: np.ndarray) -> float:
    return float(np.mean((pred - gt) ** 2))


def psnr(pred: np.ndarray, gt: np.ndarray, *, from_mse=None) -> float:
    """-10 log10(mse); from_mse reuses a mean squared error already taken."""
    m = mse(pred, gt) if from_mse is None else from_mse
    return float(-10.0 * np.log10(m))


def _box_mean_valid(x: np.ndarray, win: int) -> np.ndarray:
    """Mean over every win x win window that lies inside x: (H-win+1,
    W-win+1).  These are exactly the values the cropped SSIM map keeps, so
    no border rule is needed; each window sum is a pairwise sum of win
    terms, as accurate as a direct box filter."""
    rows = sliding_window_view(x, win, axis=0).sum(axis=-1)
    return sliding_window_view(rows, win, axis=1).sum(axis=-1) / (win * win)


def ssim_multi(pred: np.ndarray, gt: np.ndarray, data_ranges=(2.0,),
               win_size: int = 7, K1: float = 0.01, K2: float = 0.03):
    """SSIM at several data ranges from one set of window moments (the
    range enters only through C1 and C2); a list aligned with
    ``data_ranges``.  Raises ValueError when an image side is below
    ``win_size``, as skimage does."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if min(pred.shape[:2], default=0) < win_size:
        raise ValueError(
            f"ssim: image extent {pred.shape[:2]} is smaller than the "
            f"{win_size}x{win_size} window (empty or degenerate crop)")
    if pred.ndim == 3:
        per_c = [ssim_multi(pred[..., c], gt[..., c], data_ranges, win_size,
                            K1, K2) for c in range(pred.shape[-1])]
        return [float(np.mean([pc[i] for pc in per_c]))
                for i in range(len(data_ranges))]
    np_win = win_size * win_size
    cov_norm = np_win / (np_win - 1)
    ux = _box_mean_valid(pred, win_size)
    uy = _box_mean_valid(gt, win_size)
    uxx = _box_mean_valid(pred * pred, win_size)
    uyy = _box_mean_valid(gt * gt, win_size)
    uxy = _box_mean_valid(pred * gt, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    out = []
    for data_range in data_ranges:
        C1 = (K1 * data_range) ** 2
        C2 = (K2 * data_range) ** 2
        S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
            (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
        out.append(float(S.mean()))
    return out


def ssim(pred: np.ndarray, gt: np.ndarray, data_range: float = 2.0,
         win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    """pred/gt: (H, W) or (H, W, C) float images (see ssim_multi)."""
    return ssim_multi(pred, gt, (data_range,), win_size, K1, K2)[0]
