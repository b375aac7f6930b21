"""Deterministic colour jitter for training images (counterpart of
transhuman_tpu/data/jitter.py, with the same seeded draws and op order; its
HSV step goes through ``imgproc.rgb_to_hsv`` / ``hsv_to_rgb``).

The ranges are the reference's torchvision ColorJitter (brightness
(0.2, 2), contrast (0.3, 2), saturation (0.2, 2), hue (-0.5, 0.5),
``can_smpl.py:278-285``), drawn from a numpy RNG seeded by index + epoch x
seed; the ops run in a random order on the float [0, 1] image after the
resize, as the JAX package does.
"""

from __future__ import annotations

import numpy as np

from .imgproc import hsv_to_rgb, rgb_to_hsv

BRIGHTNESS = (0.2, 2.0)
CONTRAST = (0.3, 2.0)
SATURATION = (0.2, 2.0)
HUE = (-0.5, 0.5)


def _blend_(img, other, f):
    """img <- clip(f*img + (1-f)*other) in place; other is scalar or array."""
    np.multiply(img, f, out=img)
    if isinstance(other, np.ndarray):
        img += (1.0 - f) * other
    elif other != 0.0:
        img += (1.0 - f) * other
    np.clip(img, 0.0, 1.0, out=img)
    return img


_GRAY = np.array([0.299, 0.587, 0.114], np.float32)


def color_jitter(img: np.ndarray, seed: int) -> np.ndarray:
    """img: (H, W, 3) float32 RGB in [0, 1] -> jittered float32 RGB; the
    input array is not modified."""
    rng = np.random.default_rng(seed)
    img = img.astype(np.float32, copy=True)
    b = rng.uniform(*BRIGHTNESS)
    c = rng.uniform(*CONTRAST)
    s = rng.uniform(*SATURATION)
    h = rng.uniform(*HUE)
    for op in rng.permutation(4):
        if op == 0:
            _blend_(img, 0.0, b)
        elif op == 1:
            mean = float((img @ _GRAY).mean())
            _blend_(img, mean, c)
        elif op == 2:
            gray = (img @ _GRAY)[..., None]
            _blend_(img, gray, s)
        else:
            hsv = rgb_to_hsv(img)  # H in [0, 360)
            hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
            img = hsv_to_rgb(hsv)
    return img
