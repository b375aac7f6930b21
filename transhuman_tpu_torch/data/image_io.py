"""Image files of the ZJU-MoCap layout without OpenCV, PIL or imageio: JPEG
frames through the port's own decoder (``native/imgcodec.cc``) and PNG masks
through the standard library's zlib and the codec's row unfilter.

``imread_rgb`` returns what the JAX package's ``_imread_rgb`` returns
(``cv2.imread`` + ``cvtColor`` BGR -> RGB: libjpeg-turbo's default decode).
``read_png`` returns what ``imageio.v2.imread`` returns for the colour types
and depths a mask comes in (a palette applied to RGB, a 1-bit image as
bool, 2- and 4-bit grey scaled to 8 bits, 16-bit grey as uint16, other
16-bit samples cut to their high byte as Pillow reads them), and
``read_mask_png`` what ``_load_mask`` computes from it: ``!= 0``, then
channel 0.  A palette entry whose red is 0 therefore reads as background.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..native import build as codec

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise FileNotFoundError(f"unreadable image: {path} ({e})") from e


def decode_jpeg(data: bytes, what: str = "JPEG") -> np.ndarray:
    """(H, W, 3) RGB uint8 of a JPEG in memory; a grey JPEG is replicated
    to three channels.  ValueError naming ``what`` and the marker for a
    coding the decoder refuses."""
    h, w = ctypes.c_int(), ctypes.c_int()
    codec.call("thc_jpeg_info", data, len(data), ctypes.byref(h),
               ctypes.byref(w), what=what)
    out = np.empty((h.value, w.value, 3), np.uint8)
    codec.call("thc_jpeg_decode", data, len(data), out.ctypes.data,
               h.value, w.value, what=what)
    return out


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) RGB uint8 of a JPEG file; FileNotFoundError with the path
    for a missing or unreadable file."""
    data = _read(path)
    if data[:2] != b"\xff\xd8":
        raise FileNotFoundError(f"unreadable image: {path} (not a JPEG)")
    return decode_jpeg(data, path)


def decode_png(data: bytes, what: str = "PNG") -> np.ndarray:
    """The array ``imageio.v2.imread`` gives for a PNG in memory (see the
    module docstring); ValueError naming ``what`` for an interlaced or
    malformed file."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    pos, idat, plte, ihdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{what}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{what}: Adam7-interlaced PNG (IHDR interlace "
                         f"{interlace}) is not supported")
    if ctype not in _CHANNELS or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"{what}: PNG colour type {ctype} at bit depth "
                         f"{depth} (IHDR) is not supported")
    if ctype == 3 and plte is None:
        raise ValueError(f"{what}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    rowbytes = (w * bits + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    rows = np.empty((h, rowbytes), np.uint8)
    codec.call("thc_png_unfilter", raw, len(raw), h,
               rowbytes, max(1, bits // 8), rows.ctypes.data, what=what)
    if depth < 8:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
        samples = samples.reshape(h, rowbytes * per)[:, :w]
    elif depth == 16:
        samples = rows.view(">u2").reshape(h, w * ch)
        samples = (samples.astype(np.uint16) if ctype == 0
                   else (samples >> 8).astype(np.uint8))
    else:
        samples = rows
    img = samples.reshape(h, w, ch)
    if ctype == 3:
        # Pillow's palette stays RGB with a tRNS chunk, and imageio applies
        # it as it is
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte
        return pal[img[..., 0]]
    if ch == 1:
        img = img[..., 0]
        if depth == 1:
            return img.astype(bool)
        if depth < 8:
            return (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return np.ascontiguousarray(img)


def read_png(path: str) -> np.ndarray:
    return decode_png(_read(path), path)


def read_mask_png(path: str) -> np.ndarray:
    """(H, W) uint8 {0, 1}: ``(imageio.v2.imread(path) != 0)``, channel 0
    of a multi-channel image."""
    m = (read_png(path) != 0).astype(np.uint8)
    return m[..., 0] if m.ndim == 3 else m
