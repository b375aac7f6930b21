"""8-bit RGB PNG files with the standard library alone (zlib), for the
server's ``?format=png`` replies and the evaluator's and visualizer's
frames; the card's machine has no OpenCV."""

from __future__ import annotations

import struct
import zlib

import numpy as np


# PNG colour type by channel count: grey, RGB
_COLOUR_TYPE = {1: 0, 3: 2}


def encode_png(rgb: np.ndarray) -> bytes:
    """(H,W,3) float in [0,1] -> 8-bit RGB PNG bytes, each value clipped
    after scaling by 255 and truncated (as the reference's
    ``cv2.imwrite(np.clip(x * 255, 0, 255).astype(np.uint8))``).  (H,W)
    and (H,W,1) give a grey PNG; uint8 input is written as it is."""
    img = rgb if rgb.dtype == np.uint8 else np.clip(
        rgb * 255, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                         _COLOUR_TYPE[c], 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_png(rgb))
