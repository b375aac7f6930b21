"""Image files of the ZJU-MoCap layout without OpenCV, PIL or imageio: JPEG
frames through the port's own decoder (``native/imgcodec.cc``), PNG
frames and masks through the standard library's zlib and the codec's row
unfilter, and BMP, PxM, Sun raster and TIFF frames through
``image_formats.py``.

``imread_rgb`` returns what the JAX package's ``_imread_rgb`` returns
(``cv2.imread`` + ``cvtColor`` BGR -> RGB) for a file of any of those
formats, told apart by signature (``image_formats.py`` says what it reads
of the other four, and what it refuses by name): for a JPEG,
libjpeg-turbo's default decode (sequential or progressive, grey, YCbCr,
RGB, CMYK or YCCK, block smoothing of a truncated progressive file), then
the EXIF orientation; for a PNG, three
8-bit channels (grey replicated, a palette applied, alpha dropped, 1-, 2-
and 4-bit grey scaled to 8 bits, 16-bit samples cut to their high byte),
then the orientation of an ``eXIf`` chunk.
``read_png`` returns what ``imageio.v2.imread`` returns for the colour
types and depths a mask comes in (a palette applied to RGB, a 1-bit image
as bool, 2- and 4-bit grey scaled to 8 bits, 16-bit grey as uint16, other
16-bit samples cut to their high byte as Pillow reads them; no
orientation), and ``read_mask_png`` what ``_load_mask`` computes from it:
``!= 0``, then channel 0.  A palette entry whose red is 0 therefore reads
as background.  Both PNG readers take Adam7-interlaced files.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..native import build as codec
from . import image_formats

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8"
# PNG colour type -> samples per pixel, and the bit depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7 passes: first column, first row, column step, row step
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _read(path: str) -> bytes:
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError as e:
        raise FileNotFoundError(f"unreadable image: {path} ({e})") from e


def decode_jpeg(data: bytes, what: str = "JPEG") -> np.ndarray:
    """(H, W, 3) RGB uint8 of a JPEG in memory, EXIF-oriented (H and W
    swap for orientations 5-8); a grey JPEG is replicated to three
    channels.  ValueError naming ``what`` and the marker for a coding the
    decoder refuses."""
    h, w = ctypes.c_int(), ctypes.c_int()
    codec.call("thc_jpeg_info", data, len(data), ctypes.byref(h),
               ctypes.byref(w), what=what)
    out = np.empty((h.value, w.value, 3), np.uint8)
    codec.call("thc_jpeg_decode", data, len(data), out.ctypes.data,
               h.value, w.value, what=what)
    return out


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) RGB uint8 of a JPEG, PNG, BMP, PxM, Sun raster or TIFF
    file, as ``cv2.imread`` + BGR -> RGB reads it; FileNotFoundError with
    the path for a missing file, one of none of those signatures, or a
    format or coding refused by name."""
    data = _read(path)
    if data[:2] == JPEG_SIGNATURE:
        return decode_jpeg(data, path)
    if data[:8] == PNG_SIGNATURE:
        return decode_png_rgb(data, path)
    kind = image_formats.sniff(data)
    if kind is not None:
        try:
            return image_formats.decode(kind, data, path)
        except image_formats.Refused as e:
            raise FileNotFoundError(
                f"unreadable image: {path} ({e} is not read)") from None
    name = image_formats.refused_name(data)
    raise FileNotFoundError(
        f"unreadable image: {path} ("
        + (f"{name} is not read" if name else
           "not a JPEG, PNG, BMP, PxM, Sun raster or TIFF file") + ")")


def _png_parse(data: bytes, what: str):
    """(IHDR fields, PLTE (n, 3) or None, first eXIf body or None, samples
    (h, w, channels): uint8 below 16 bits, unscaled; uint16 at 16)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{what}: not a PNG file")
    pos, idat, plte, ihdr, exif = 8, [], None, None, None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3]
            plte = plte.reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"eXIf":
            # libpng keeps the first eXIf that starts as TIFF does
            if exif is None and body[:2] in (b"II", b"MM"):
                exif = body
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{what}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"{what}: PNG colour type {ctype} at bit depth "
                         f"{depth} (IHDR) is not supported")
    if interlace > 1:
        raise ValueError(f"{what}: PNG interlace method {interlace} (IHDR) "
                         "is not supported")
    if ctype == 3 and plte is None:
        raise ValueError(f"{what}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        samples = _unfilter(raw, h, w, ch, depth, what)
    else:
        # Adam7: each pass is a small image of its own, unfiltered with its
        # own row length (its first row has no row above), then scattered
        samples = np.zeros((h, w, ch), np.uint16 if depth == 16
                           else np.uint8)
        start = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            size = ph * ((pw * ch * depth + 7) // 8 + 1)
            samples[y0::dy, x0::dx] = _unfilter(raw[start:start + size], ph,
                                                pw, ch, depth, what)
            start += size
    return ihdr, plte, exif, samples


def _unfilter(raw: bytes, h: int, w: int, ch: int, depth: int,
              what: str) -> np.ndarray:
    """(h, w, ch) samples of h filtered rows of w pixels."""
    bits = ch * depth
    rowbytes = (w * bits + 7) // 8
    rows = np.empty((h, rowbytes), np.uint8)
    codec.call("thc_png_unfilter", raw, len(raw), h,
               rowbytes, max(1, bits // 8), rows.ctypes.data, what=what)
    if depth < 8:
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        samples = ((rows[:, :, None] >> shifts) & ((1 << depth) - 1))
        samples = samples.reshape(h, rowbytes * per)[:, :w]
    elif depth == 16:
        samples = rows.view(">u2").astype(np.uint16)
    else:
        samples = rows
    return samples.reshape(h, w, ch)


def _palette(plte: np.ndarray) -> np.ndarray:
    pal = np.zeros((256, 3), np.uint8)
    pal[:len(plte)] = plte
    return pal


def decode_png(data: bytes, what: str = "PNG") -> np.ndarray:
    """The array ``imageio.v2.imread`` gives for a PNG in memory (see the
    module docstring); ValueError naming ``what`` for a malformed file."""
    (_, _, depth, ctype, _, _, _), plte, _, img = _png_parse(data, what)
    if ctype == 3:
        # Pillow's palette stays RGB with a tRNS chunk, and imageio applies
        # it as it is
        return _palette(plte)[img[..., 0]]
    if depth == 16 and ctype != 0:
        img = (img >> 8).astype(np.uint8)
        if ctype == 4:  # Pillow reads 16-bit grey + alpha as RGBA
            img = img[..., [0, 0, 0, 1]]
    if img.shape[-1] == 1:
        img = img[..., 0]
        if depth == 1:
            return img.astype(bool)
        if depth < 8:
            return (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return np.ascontiguousarray(img)


def decode_png_rgb(data: bytes, what: str = "PNG") -> np.ndarray:
    """(H, W, 3) RGB uint8 of a PNG in memory, as ``cv2.imread`` + BGR ->
    RGB reads it (see the module docstring)."""
    (_, _, depth, ctype, _, _, _), plte, exif, img = _png_parse(data, what)
    if ctype == 3:
        rgb = _palette(plte)[img[..., 0]]
    else:
        if depth == 16:
            img = (img >> 8).astype(np.uint8)
        elif depth < 8:
            img = (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
        rgb = img[..., :3] if ctype in (2, 6) else np.repeat(img[..., :1], 3,
                                                             -1)
    rgb = np.ascontiguousarray(rgb)
    orientation = (codec.library().thc_exif_orientation(exif, len(exif))
                   if exif is not None else -1)
    if not 2 <= orientation <= 8:
        return rgb
    h, w = rgb.shape[:2]
    out = np.empty((w, h, 3) if orientation >= 5 else (h, w, 3), np.uint8)
    codec.library().thc_orient_rgb(rgb.ctypes.data, h, w, orientation,
                                   out.ctypes.data)
    return out


def read_png(path: str) -> np.ndarray:
    return decode_png(_read(path), path)


def read_mask_png(path: str) -> np.ndarray:
    """(H, W) uint8 {0, 1}: ``(imageio.v2.imread(path) != 0)``, channel 0
    of a multi-channel image."""
    m = (read_png(path) != 0).astype(np.uint8)
    return m[..., 0] if m.ndim == 3 else m
