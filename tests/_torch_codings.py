"""Image files in the codings the port's codec reads beyond baseline JPEG,
for tests/test_torch_codings.py, test_torch_zju.py and test_torch_tools.py:
progressive JPEGs from Pillow and OpenCV, a progressive file cut after k of
its scans, CMYK and YCCK JPEGs, an EXIF orientation spliced in, and PNGs of
any colour type and depth, Adam7-interlaced or not (neither Pillow nor
OpenCV writes Adam7), each row under one of the five filters."""

import io
import struct
import zlib

import cv2
import numpy as np
from PIL import Image

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# every (colour type, bit depth) PNG allows
PNG_TYPES = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
SAMPLINGS = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


# ------------------------------------------------------------------ JPEG
def pil_jpeg(img, quality=90, subsampling=0, mode=None, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img, mode=mode).save(b, "JPEG", quality=quality,
                                         subsampling=subsampling, **kw)
    return b.getvalue()


def cv2_progressive(rgb, quality=90, sampling="420", restart=0) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE,
              1, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLINGS[sampling]]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           params)
    assert ok
    return buf.tobytes()


def scan_ends(data: bytes) -> list:
    """The offset where each scan's entropy-coded data ends."""
    pos, ends = 2, []
    while pos < len(data):
        m = data[pos + 1]
        if m == 0xD9:
            break
        pos += 2 + struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if m == 0xDA:
            while not (data[pos] == 0xFF and data[pos + 1] != 0
                       and not 0xD0 <= data[pos + 1] <= 0xD7):
                pos += 1
            ends.append(pos)
    return ends


def cut_after_scans(data: bytes, k: int) -> bytes:
    """The JPEG's first k scans, then EOI (what a download cut short and
    closed gives)."""
    return data[:scan_ends(data)[k - 1]] + b"\xff\xd9"


def cmyk_jpeg(cmyk, variant="adobe", quality=90, progressive=False) -> bytes:
    """A 4-component JPEG from Pillow (Adobe APP14, transform 0: CMYK);
    variant "ycck" patches the transform byte to 2, "plain" drops the APP14
    segment (CMYK to libjpeg too)."""
    data = pil_jpeg(np.ascontiguousarray(cmyk), quality, 0, mode="CMYK",
                    progressive=progressive)
    i = data.index(b"Adobe")
    if variant == "ycck":
        return data[:i + 11] + b"\x02" + data[i + 12:]
    if variant == "plain":
        seg = i - 4
        n = struct.unpack(">H", data[seg + 2:seg + 4])[0]
        return data[:seg] + data[seg + 2 + n:]
    assert variant == "adobe"
    return data


def exif_tiff(orientation: int, little_endian: bool = True) -> bytes:
    """A TIFF block whose IFD0 holds one orientation tag (SHORT)."""
    f = "<" if little_endian else ">"
    ifd = struct.pack(f + "HHHIHH", 1, 0x0112, 3, 1, orientation, 0)
    return ((b"II*\0" if little_endian else b"MM\0*")
            + struct.pack(f + "I", 8) + ifd + b"\0\0\0\0")


def with_app1(data: bytes, payload: bytes) -> bytes:
    """The JPEG with an APP1 segment of payload right after SOI."""
    return (data[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2)
            + payload + data[2:])


def with_exif(data: bytes, orientation: int, little_endian=True) -> bytes:
    return with_app1(data, b"Exif\0\0" + exif_tiff(orientation,
                                                    little_endian))


# ------------------------------------------------------------------- PNG
def png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _pack(samples, depth) -> np.ndarray:
    """(h, n) samples -> (h, rowbytes) uint8 rows."""
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(len(samples), -1)
    if depth == 8:
        return samples.astype(np.uint8)
    per = 8 // depth
    h, n = samples.shape
    s = np.zeros((h, -(-n // per) * per), np.uint8)
    s[:, :n] = samples
    s = s.reshape(h, -1, per) << np.arange(8 - depth, -1, -depth,
                                            dtype=np.uint8)
    return s.sum(-1, dtype=np.uint16).astype(np.uint8)


def _filter(rows, bpp, first_filter) -> bytes:
    """Rows under filters first_filter, +1, ... (mod 5), the previous row
    of the first row zeros."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for y, row in enumerate(rows.astype(np.int32)):
        ft = (first_filter + y) % 5
        a = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 0:
            pred = np.zeros_like(row)
        elif ft == 1:
            pred = a
        elif ft == 2:
            pred = prev
        elif ft == 3:
            pred = (a + prev) >> 1
        else:
            p = a + prev - c
            pa, pb, pc = abs(p - a), abs(p - prev), abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, prev, c))
        out.append(bytes([ft]) + ((row - pred) & 255).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


def encode_png(samples, depth, ctype, interlace=False, palette=None,
               trns=None, chunks=b"", chunks_after=b"") -> bytes:
    """A PNG of (h, w, channels) integer samples at the bit depth and
    colour type; Adam7 with interlace.  chunks go before IDAT,
    chunks_after after it."""
    samples = np.asarray(samples)
    h, w, ch = samples.shape
    assert ch == PNG_CHANNELS[ctype]
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for k, (x0, y0, dx, dy) in enumerate(ADAM7):
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += _filter(_pack(sub.reshape(len(sub), -1), depth), bpp,
                               k)
    else:
        raw = _filter(_pack(samples.reshape(h, -1), depth), bpp, 0)
    out = PNG_SIGNATURE + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))) + chunks
    if palette is not None:
        out += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += png_chunk(b"tRNS", trns)
    return (out + png_chunk(b"IDAT", zlib.compress(raw)) + chunks_after
            + png_chunk(b"IEND", b""))


def random_png(rng, h, w, ctype, depth, interlace=False) -> bytes:
    """Seeded samples of every value at the depth; a palette of 2^depth
    entries (at most 256), with a tRNS chunk on every other call."""
    samples = rng.integers(0, 1 << depth, (h, w, PNG_CHANNELS[ctype]))
    palette = trns = None
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << depth, 3))
        if rng.random() < 0.5:
            trns = bytes(rng.integers(0, 256, min(3, 1 << depth)).tolist())
    return encode_png(samples, depth, ctype, interlace, palette, trns)
