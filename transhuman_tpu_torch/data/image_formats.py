"""The frame formats ``cv2.imread`` reads beside JPEG and PNG, decoded as
OpenCV 5 decodes them into (H, W, 3) RGB uint8 (its BGR result after
``COLOR_BGR2RGB``): BMP, PxM (PBM, PGM, PPM, PAM, PFM), Sun raster and TIFF.
Headers and plain raster layouts are read with numpy; the byte-serial
codings (BMP RLE4/RLE8, TIFF PackBits and LZW) run in ``native/imgcodec.cc``
and TIFF Deflate in the standard library's zlib, so no frame decode loops
over bytes in Python.

What OpenCV does, where it is not what the format's specification says:

* BMP: palette entries past the header's colour count are black; a pixel
  that a run-length end-of-line, delta or end-of-bitmap skips takes palette
  entry 0; 16-bit pixels are 5-5-5 unless bit-field masks read as 5-6-5,
  each channel shifted up (not replicated); 32-bit pixels are read as
  B, G, R, x whatever their masks say; 16-bit bit-field masks are read
  right after the info header, so a v4 or v5 header's own masks are not
  seen (cv2 refuses such a 5-6-5 bitmap, as the port does).
* PxM: binary samples are taken as they are (no scaling by the maxval),
  16-bit ones cut to their high byte; ASCII samples are clipped to the
  maxval and scaled to 8 bits (``v * 255 // maxval``), or cut to their high
  byte above a maxval of 255; P1 reads one digit a pixel; PAM RGB reaches
  the caller in B, G, R order; a PFM's floats are multiplied by 1 / |scale|
  in float32 and rounded half to even, with NaN, infinities and values out
  of int32's range reading 0, as ``cvRound`` gives them.
* TIFF: libtiff's RGBA image (``TIFFReadRGBAStrip``/``Tile``), which cv2
  uses for every 8-bit result: 16-bit colour and separate-plane samples
  scaled by ``(v + 128) // 257``, contiguous 16-bit grey cut to its high
  byte, an unassociated alpha multiplied in (``(v * a + 127) // 255``; for
  grey only in separate planes), MinIsWhite inverted except in separate
  planes, a colour map cut to its high byte unless every entry is below
  256; the horizontal predictor applies to LZW and Deflate only; the
  orientation tag turns the image as an EXIF orientation does.

Refused by name (FileNotFoundError naming the path and the format), each
where cv2.imread returns nothing or where the port does not decode it:
a gray PFM (``Pf``), PAM with 2 or 4 channels or a maxval of 1, Sun raster
run-length and RGB types, TIFF below 8 bits but for 1-bit grey and 4-bit
palettes, TIFF with JPEG or CCITT compression, float samples, more than 4
samples, orientations 5-8 on a non-square image (cv2 reads nothing), an
orientation other than 1 on tiles, BigTIFF, and the formats GIF,
Radiance HDR, WebP, AVIF and JPEG 2000.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from ..native import build as codec

# signature -> format name, for what is refused whole
REFUSED = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"),
           (b"#?RADIANCE", "Radiance HDR"), (b"#?RGBE", "Radiance HDR"),
           (b"\0\0\0\x0cjP  \r\n\x87\n", "JPEG 2000"),
           (b"\xff\x4f\xff\x51", "JPEG 2000 (codestream)"))


class Refused(Exception):
    """A file of a format or coding the port does not read (the caller
    raises FileNotFoundError with the path)."""


def sniff(data: bytes):
    """The name of the decoder for data's signature, or None."""
    if data[:2] == b"BM":
        return "bmp"
    if len(data) >= 2 and data[0:1] == b"P" and data[1:2] in b"1234567Ff":
        return "pxm"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "sun"
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return "tiff"
    return None


def refused_name(data: bytes):
    for sig, name in REFUSED:
        if data.startswith(sig):
            return name
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis"):
        return "AVIF"
    return None


def decode(kind: str, data: bytes, what: str) -> np.ndarray:
    """(H, W, 3) RGB uint8 of data, a file of kind sniff() named; raises
    Refused for a coding refused by name, ValueError for a malformed
    file."""
    img = {"bmp": decode_bmp, "pxm": decode_pxm, "sun": decode_sun,
           "tiff": decode_tiff}[kind](data, what)
    # a view of the file's bytes is read-only; the loader gets its own
    return img if img.flags.writeable else img.copy()


def _need(data: bytes, end: int, what: str, fmt: str):
    if len(data) < end:
        raise ValueError(f"{what}: {fmt} file ends early")


# ------------------------------------------------------------------- BMP
def decode_bmp(data: bytes, what: str = "BMP") -> np.ndarray:
    _need(data, 26, what, "BMP")
    off, size = struct.unpack_from("<II", data, 10)
    if size < 40:
        raise Refused(f"BMP with a {size}-byte (OS/2) header")
    _need(data, 14 + size, what, "BMP")
    w, h, _, bpp, comp = struct.unpack_from("<iiHHI", data, 18)
    clrused = struct.unpack_from("<I", data, 46)[0]
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"{what}: BMP of {w}x{h} pixels")
    pal = np.zeros((256, 3), np.uint8)
    if bpp <= 8:
        n = clrused if 0 < clrused <= 1 << bpp else 1 << bpp
        start = 14 + size
        _need(data, start + 4 * n, what, "BMP")
        entries = np.frombuffer(data, np.uint8, 4 * n, start).reshape(n, 4)
        pal[:n] = entries[:, 2::-1]
    if comp == 3 and bpp == 16:
        # OpenCV reads the masks after the whole info header, where a v4
        # or v5 header's pixels or palette begin
        _need(data, 26 + size, what, "BMP")
        r, g, b = struct.unpack_from("<III", data, 14 + size)
        if (r, g, b) == (0xF800, 0x7E0, 0x1F):
            bpp = 565
        elif (r, g, b) != (0x7C00, 0x3E0, 0x1F):
            raise Refused(f"16-bit BMP with bit-field masks {r:#x}, {g:#x}, "
                          f"{b:#x} (not 5-5-5 or 5-6-5)")
    elif comp == 3 and bpp != 32 or comp not in (0, 1, 2, 3) \
            or comp == 1 and bpp != 8 or comp == 2 and bpp != 4:
        raise Refused(f"BMP compression {comp} at {bpp} bits")
    if bpp not in (1, 4, 8, 16, 565, 24, 32):
        raise Refused(f"{bpp}-bit BMP")
    if comp in (1, 2):
        idx = np.empty((h, w), np.uint8)
        body = data[off:]
        codec.call("thc_bmp_rle", body, len(body), 8 if comp == 1 else 4, h,
                   w, idx.ctypes.data, what=what)
        rgb = pal[idx]
    else:
        bits = 16 if bpp == 565 else bpp
        stride = (w * bits + 31) // 32 * 4
        _need(data, off + stride * h, what, "BMP")
        rows = np.frombuffer(data, np.uint8, stride * h, off).reshape(h,
                                                                      stride)
        if bpp < 8:
            rgb = pal[_unpack_bits(rows, bpp, w)]
        elif bpp == 8:
            rgb = pal[rows[:, :w]]
        elif bits == 16:
            v = rows[:, :2 * w].copy().view("<u2")
            if bpp == 565:
                chans = (v >> 8 & 0xF8, v >> 3 & 0xFC, v << 3 & 0xF8)
            else:
                chans = (v >> 7 & 0xF8, v >> 2 & 0xF8, v << 3 & 0xF8)
            rgb = np.stack(chans, -1).astype(np.uint8)
        else:
            n = bpp // 8
            rgb = rows[:, :n * w].reshape(h, w, n)[..., 2::-1]
    if not top_down:
        rgb = rgb[::-1]
    return np.ascontiguousarray(rgb)


def _unpack_bits(rows: np.ndarray, bits: int, w: int) -> np.ndarray:
    """(h, w) samples of MSB-first packed rows of ``bits``-bit samples."""
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    v = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return v.reshape(rows.shape[0], -1)[:, :w]


# ------------------------------------------------------------------- PxM
_TOKEN = re.compile(rb"(?:\s|#[^\n\r]*)*(\d+)")
_COMMENT = re.compile(rb"#[^\n\r]*")


def _pnm_header(data: bytes, count: int, what: str):
    """count numbers after the magic (comments and whitespace between),
    and the offset after the single whitespace that ends the last."""
    pos, vals = 2, []
    for _ in range(count):
        m = _TOKEN.match(data, pos)
        if not m:
            raise ValueError(f"{what}: malformed PxM header")
        vals.append(int(m.group(1)))
        pos = m.end()
    return vals, pos + 1


def decode_pxm(data: bytes, what: str = "PxM") -> np.ndarray:
    magic = data[1:2]
    if magic == b"7":
        return _decode_pam(data, what)
    if magic in b"Ff":
        return _decode_pfm(data, what)
    kind = int(magic)
    bitmap = kind in (1, 4)
    (w, h, *rest), start = _pnm_header(data, 2 if bitmap else 3, what)
    maxval = 1 if bitmap else rest[0]
    if w <= 0 or h <= 0 or not 0 < maxval < 65536:
        raise ValueError(f"{what}: PxM of {w}x{h}, maxval {maxval}")
    ch = 3 if kind in (3, 6) else 1
    n = w * h * ch
    if kind in (1, 2, 3):  # ASCII
        body = _COMMENT.sub(b" ", data[start - 1:])
        if kind == 1:
            digits = np.frombuffer(body, np.uint8)
            digits = digits[(digits >= 48) & (digits <= 57)]
            if digits.size < n:
                raise ValueError(f"{what}: PBM data ends early")
            return np.repeat(np.where(digits[:n] > 48, 0, 255).astype(
                np.uint8).reshape(h, w, 1), 3, -1)
        toks = body.split()
        if len(toks) < n:
            raise ValueError(f"{what}: PxM data ends early")
        v = np.minimum(np.array(toks[:n], np.int64), maxval)
        if maxval < 256:
            v = v * 255 // maxval
        else:
            v = v >> 8
        img = v.astype(np.uint8)
    elif kind == 4:
        stride = (w + 7) // 8
        _need(data, start + stride * h, what, "PBM")
        rows = np.frombuffer(data, np.uint8, stride * h, start).reshape(
            h, stride)
        img = np.where(_unpack_bits(rows, 1, w) > 0, 0, 255).astype(
            np.uint8)
    else:
        img = _binary_samples(data, start, n, maxval, what)
    img = img.reshape(h, w, ch)
    return np.ascontiguousarray(img if ch == 3 else np.repeat(img, 3, -1))


def _binary_samples(data, start, n, maxval, what) -> np.ndarray:
    """n binary samples from start, as they are, 16-bit ones (big-endian)
    cut to their high byte."""
    wide = maxval > 255
    _need(data, start + n * (2 if wide else 1), what, "PxM")
    if wide:
        return (np.frombuffer(data, ">u2", n, start) >> 8).astype(np.uint8)
    return np.frombuffer(data, np.uint8, n, start)


def _decode_pam(data: bytes, what: str) -> np.ndarray:
    end = data.find(b"ENDHDR")
    if end < 0:
        raise ValueError(f"{what}: PAM header without ENDHDR")
    fields = {}
    for line in data[3:end].splitlines():
        parts = line.split(b"#")[0].split()
        if parts:
            fields[parts[0].upper()] = parts[1:]
    try:
        w, h, depth, maxval = (int(fields[k][0]) for k in
                               (b"WIDTH", b"HEIGHT", b"DEPTH", b"MAXVAL"))
    except (KeyError, IndexError, ValueError):
        raise ValueError(f"{what}: PAM header lacks WIDTH, HEIGHT, DEPTH or "
                         "MAXVAL") from None
    if depth not in (1, 3):
        # cv2 5.0 fills all but a row's first pixels from outside the
        # raster for these
        raise Refused(f"PAM with {depth} channels")
    if maxval == 1:
        raise Refused("PAM with a maxval of 1")
    if w <= 0 or h <= 0 or not 1 < maxval < 65536:
        raise ValueError(f"{what}: PAM of {w}x{h}, maxval {maxval}")
    start = data.index(b"\n", end) + 1
    img = _binary_samples(data, start, w * h * depth, maxval, what)
    img = img.reshape(h, w, depth)
    # PAM's RGB tuples reach the caller as B, G, R
    return np.ascontiguousarray(img[..., ::-1] if depth == 3
                                else np.repeat(img, 3, -1))


def _decode_pfm(data: bytes, what: str) -> np.ndarray:
    if data[1:2] == b"f":
        raise Refused("grey PFM (Pf)")
    m = re.match(rb"PF\s+(\d+)\s+(\d+)\s+(\S+)\s", data)
    if not m:
        raise ValueError(f"{what}: malformed PFM header")
    w, h, scale = int(m.group(1)), int(m.group(2)), float(m.group(3))
    if w <= 0 or h <= 0 or scale == 0:
        raise ValueError(f"{what}: PFM of {w}x{h}, scale {scale}")
    n = w * h * 3
    _need(data, m.end() + 4 * n, what, "PFM")
    f = np.frombuffer(data, "<f4" if scale < 0 else ">f4", n, m.end())
    f = f.astype(np.float32) * np.float32(1.0 / abs(scale))
    with np.errstate(invalid="ignore"):
        ok = np.isfinite(f) & (np.abs(f) < 2.0 ** 31)
        r = np.where(ok, np.rint(np.where(ok, f, 0)), 0)
    img = np.clip(r, 0, 255).astype(np.uint8).reshape(h, w, 3)
    return np.ascontiguousarray(img[::-1])


# ------------------------------------------------------------ Sun raster
def decode_sun(data: bytes, what: str = "Sun raster") -> np.ndarray:
    _need(data, 32, what, "Sun raster")
    _, w, h, depth, _, rtype, maptype, maplen = struct.unpack_from(">8I",
                                                                   data)
    if rtype not in (0, 1):
        # cv2 5.0 reads neither the run-length (2) nor the RGB (3) type
        raise Refused(f"Sun raster of type {rtype}")
    if depth not in (1, 8, 24, 32) or w == 0 or h == 0:
        raise ValueError(f"{what}: Sun raster of {w}x{h} at {depth} bits")
    pal = np.zeros((256, 3), np.uint8)
    if maptype == 1 and maplen > 0 and depth <= 8 \
            and maplen <= 3 << depth:
        n = maplen // 3
        _need(data, 32 + maplen, what, "Sun raster")
        pal[:n] = np.frombuffer(data, np.uint8, 3 * n, 32).reshape(3, n).T
    elif maptype == 0 and maplen == 0:
        if depth <= 8:
            levels = np.arange(1 << depth) * 255 // ((1 << depth) - 1)
            pal[:1 << depth] = levels[:, None]
    else:
        raise ValueError(f"{what}: Sun raster colour map of type {maptype}, "
                         f"{maplen} bytes")
    start = 32 + maplen
    stride = (w * depth + 15) // 16 * 2
    _need(data, start + stride * h, what, "Sun raster")
    rows = np.frombuffer(data, np.uint8, stride * h, start).reshape(h, stride)
    if depth == 1:
        return pal[_unpack_bits(rows, 1, w)]
    if depth == 8:
        return pal[rows[:, :w]]
    n = depth // 8
    # B, G, R; at 32 bits after a pad byte
    return np.ascontiguousarray(
        rows[:, :n * w].reshape(h, w, n)[..., :-4:-1])


# ------------------------------------------------------------------ TIFF
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h", 9: "i",
          16: "Q"}
_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4",
                 32771: "CCITT RLEW", 6: "old-style JPEG", 7: "JPEG",
                 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                 50000: "ZSTD", 50001: "WebP", 32946: None, 8: None,
                 1: None, 5: None, 32773: None}


def _ifd(data: bytes, what: str) -> dict:
    """The first IFD's tags: tag -> tuple of values (integer types)."""
    bo = "<" if data[:2] == b"II" else ">"
    version = struct.unpack_from(bo + "H", data, 2)[0]
    if version == 43:
        raise Refused("BigTIFF")
    _need(data, 8, what, "TIFF")
    pos = struct.unpack_from(bo + "I", data, 4)[0]
    _need(data, pos + 2, what, "TIFF")
    n = struct.unpack_from(bo + "H", data, pos)[0]
    _need(data, pos + 2 + 12 * n, what, "TIFF")
    tags = {}
    for i in range(n):
        tag, typ, count, val = struct.unpack_from(bo + "HHI4s", data,
                                                  pos + 2 + 12 * i)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(fmt) * count
        if size > 4:
            off = struct.unpack(bo + "I", val)[0]
            _need(data, off + size, what, "TIFF")
            raw = data[off:off + size]
        else:
            raw = val[:size]
        tags[tag] = struct.unpack(bo + fmt * count, raw)
    tags["bo"] = bo
    return tags


def decode_tiff(data: bytes, what: str = "TIFF") -> np.ndarray:
    t = _ifd(data, what)
    bo = t["bo"]

    def one(tag, default=None):
        v = t.get(tag)
        return default if v is None else v[0]

    w, h = one(256), one(257)
    if not w or not h:
        raise ValueError(f"{what}: TIFF without its width and height")
    spp = one(277, 1)
    bps = one(258, 1)
    if any(b != bps for b in t.get(258, ())):
        raise Refused("TIFF with samples of unequal widths")
    comp = one(259, 1)
    photo = one(262)
    planar = one(284, 1)
    predictor = one(317, 1)
    extra = t.get(338, ())
    if one(339, 1) not in (1, 2):
        raise Refused(f"TIFF with sample format {one(339)} (float or "
                      "complex samples)")
    if comp not in _COMPRESSIONS or _COMPRESSIONS[comp]:
        name = _COMPRESSIONS.get(comp) or f"{comp}"
        raise Refused(f"TIFF with {name} compression")
    orientation = one(274, 1)
    if not 1 <= orientation <= 8:
        raise Refused(f"TIFF with orientation {orientation}")
    if orientation != 1 and 322 in t:
        # cv2 turns each tile of libtiff's RGBA reading on its own
        raise Refused(f"tiled TIFF with orientation {orientation}")
    if orientation >= 5 and w != h:
        # cv2 turns the image as EXIF says, and reads nothing where the
        # turn swaps a non-square image's height and width
        raise Refused(f"TIFF with orientation {orientation} on a "
                      f"{w}x{h} image")
    if spp > 4:
        raise Refused(f"TIFF with {spp} samples a pixel")
    allowed = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8)}
    if photo not in allowed:
        raise Refused(f"TIFF with photometric interpretation {photo}")
    if bps not in allowed[photo]:
        raise Refused(f"TIFF of photometric interpretation {photo} at "
                      f"{bps} bits")
    colour = spp - len(extra) if photo == 2 else 1
    if photo == 2 and colour < 3 or photo != 2 and bps < 8 and spp > 1:
        raise Refused(f"TIFF with {spp} samples of {bps} bits at "
                      f"photometric interpretation {photo}")
    if predictor not in (1, 2) or predictor == 2 and bps < 8:
        raise Refused(f"TIFF predictor {predictor} at {bps} bits")
    separate = planar == 2 and spp > 1
    samples = _tiff_samples(data, t, w, h, spp, bps, comp,
                            predictor == 2 and comp in (5, 8, 32946),
                            separate, bo, what)
    rgb = _tiff_rgba(samples, t, photo, bps, spp, extra, separate)
    if orientation == 1:
        return rgb
    out = np.empty_like(rgb)
    codec.library().thc_orient_rgb(rgb.ctypes.data, h, w, orientation,
                                   out.ctypes.data)
    return out


def _tiff_samples(data, t, w, h, spp, bps, comp, predict, separate, bo,
                  what) -> np.ndarray:
    """(h, w, spp) samples, uint8 or uint16 (or (h, w, 1) below 8 bits,
    unpacked)."""
    tiled = 322 in t
    if tiled:
        cw, ch = t[322][0], t[323][0]
        offsets, counts = t.get(324), t.get(325)
    else:
        cw, ch = w, min(t.get(278, (h,))[0], h)
        offsets, counts = t.get(273), t.get(279)
    if not offsets or not counts or len(offsets) != len(counts):
        raise ValueError(f"{what}: TIFF without its strip or tile offsets")
    per = 1 if separate else spp
    planes = spp if separate else 1
    across, down = -(-w // cw), -(-h // ch)
    if len(offsets) < planes * across * down:
        raise ValueError(f"{what}: TIFF lists {len(offsets)} strips or "
                         f"tiles of {planes * across * down}")
    dt = np.dtype(bo + "u2") if bps == 16 else np.dtype(np.uint8)
    rowbytes = (cw * per * bps + 7) // 8
    out = np.zeros((planes, down * ch, across * cw, per),
                   np.uint16 if bps == 16 else np.uint8)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                rows = ch if tiled else min(ch, h - ty * ch)
                size = rowbytes * rows
                raw = data[offsets[k]:offsets[k] + counts[k]]
                k += 1
                chunk = _inflate(raw, comp, size, what)
                if bps < 8:
                    v = _unpack_bits(np.frombuffer(chunk, np.uint8).reshape(
                        rows, rowbytes), bps, cw)[..., None]
                else:
                    v = np.frombuffer(chunk, dt).reshape(rows, cw, per)
                    if predict:
                        v = np.cumsum(v, axis=1, dtype=v.dtype.newbyteorder(
                            "="))
                out[p, ty * ch:ty * ch + rows, tx * cw:(tx + 1) * cw] = v
    out = out[:, :h, :w]
    return (np.moveaxis(out[..., 0], 0, -1) if separate else out[0])


def _inflate(raw: bytes, comp: int, size: int, what: str) -> bytes:
    """One strip or tile of size bytes."""
    if comp == 1:
        chunk = raw
    elif comp in (8, 32946):
        try:
            chunk = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"{what}: TIFF Deflate data: {e}") from None
    else:
        buf = np.empty(size, np.uint8)
        codec.call("thc_tiff_lzw" if comp == 5 else "thc_packbits", raw,
                   len(raw), buf.ctypes.data, size, what=what)
        return buf.tobytes()
    if len(chunk) < size:
        raise ValueError(f"{what}: TIFF strip or tile ends early")
    return chunk[:size]


def _to8(v: np.ndarray) -> np.ndarray:
    """libtiff's Bitdepth16To8."""
    return ((v.astype(np.uint32) + 128) // 257).astype(np.uint8)


def _premultiply(c: np.ndarray, a: np.ndarray) -> np.ndarray:
    """libtiff's UaToAa: (v * a + 127) // 255."""
    return ((c.astype(np.uint32) * a[..., None] + 127) // 255).astype(
        np.uint8)


def _tiff_rgba(s, t, photo, bps, spp, extra, separate) -> np.ndarray:
    """The RGB of libtiff's RGBA image of samples s (h, w, spp)."""
    unassoc = bool(extra) and extra[0] == 2
    if photo == 3:
        cmap = np.asarray(t.get(320, ()), np.uint32)
        if cmap.size != 3 << bps:
            raise ValueError("palette TIFF without a colour map of "
                             f"{3 << bps} entries")
        cmap = cmap.reshape(3, -1).T
        if cmap.max() >= 256:
            cmap = cmap >> 8
        return np.ascontiguousarray(cmap.astype(np.uint8)[s[..., 0]])
    if photo == 2 or separate:
        # libtiff's RGB path, also for grey in separate planes (no
        # MinIsWhite inversion there)
        c = s[..., :3] if photo == 2 else np.repeat(s[..., :1], 3, -1)
        a = s[..., 3 if photo == 2 else 1] if unassoc else None
        if bps == 16:
            c = _to8(c)
            a = None if a is None else _to8(a)
        c = c.astype(np.uint8)
        return np.ascontiguousarray(c if a is None else _premultiply(c, a))
    g = s[..., 0]
    if bps == 1:
        g = g * np.uint8(255)
    elif bps == 16:
        g = (g >> 8).astype(np.uint8)
    if photo == 0:
        g = 255 - g
    return np.ascontiguousarray(np.repeat(g.astype(np.uint8)[..., None], 3,
                                          -1))
