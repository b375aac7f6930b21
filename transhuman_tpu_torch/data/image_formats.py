"""The frame formats ``cv2.imread`` reads beside JPEG and PNG, decoded as
OpenCV 5 decodes them into (H, W, 3) RGB uint8 (its BGR result after
``COLOR_BGR2RGB``): BMP, PxM (PBM, PGM, PPM, PAM, PFM), Sun raster, TIFF,
GIF, Radiance HDR, WebP and JPEG 2000.  Headers and plain raster layouts
are read with numpy; the byte-serial codings (BMP RLE4/RLE8, TIFF
PackBits, LZW, JPEG and CCITT, TIFF's YCbCr and CIELab conversions, GIF's
LZW, HDR's run-length scanlines, every stage of WebP's lossless and lossy
decoders, all of JPEG 2000) run in ``native/imgcodec.cc``,
``native/tiff.cc``, ``native/webp.cc`` and ``native/jpeg2000.cc``, TIFF
Deflate in the standard library's zlib, so no frame decode loops over
bytes in Python.

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
* TIFF (classic and BigTIFF): libtiff's RGBA image
  (``TIFFReadRGBAStrip``/``Tile``), which cv2 uses for every 8-bit
  result: 16-bit colour and separate-plane samples scaled by
  ``(v + 128) // 257``, contiguous 16-bit grey cut to its high byte, an
  unassociated alpha multiplied in (``(v * a + 127) // 255``; for grey
  only in separate planes), MinIsWhite inverted except in separate
  planes, a colour map cut to its high byte unless every entry is below
  256; the horizontal predictor applies to LZW and Deflate only;
  FillOrder 2 reverses the stored bits of every coding but JPEG.  JPEG
  (compression 7): each strip or tile an abbreviated stream read after
  the JPEGTables stream, contiguous YCbCr converted to RGB by libjpeg
  (``JPEGCOLORMODE_RGB``: fancy upsampling, its fixed-point tables), every
  other photometric taken as the components stand, a last strip coded at
  a full strip's height cut.  YCbCr without JPEG: ``TIFFYCbCrToRGB``'s
  tables (YCbCrCoefficients, ReferenceBlackWhite) and the put routines'
  blocks, chroma replicated; a 4x4-subsampled tile skips 10 bytes a block
  of the columns past the image, not 18.  CMYK: ``(255 - k) * (255 - c) //
  255`` from the first four samples.  CIELab: ``TIFFCIELabToXYZ`` and
  ``TIFFXYZToRGB`` in float32 against the WhitePoint (CIE D50 without
  one), RATIONAL tags read as float32 numerator / denominator.  CCITT RLE,
  Group 3 and Group 4: ``tif_fax3``'s runs, then the 1-bit path.  The
  orientation tag turns each strip or tile of libtiff's reading as
  ``TIFFRGBAImage`` flips it, placed from the bottom for orientations 3,
  4, 7 and 8, then the image as EXIF turns 5-8: for strips the EXIF
  orientation of the whole image, for tiles each tile turned on its own.
* GIF (OpenCV's own decoder, grfmt_gif.cpp): the first frame only, on the
  logical screen; the screen outside the frame and the frame's
  transparent pixels read as the global table's background colour, or
  black without a global table, whatever the disposal method says; a file
  cut anywhere, even after its first frame, a graphic control extension
  before the first frame of other than 4 bytes or of a disposal method
  above 3, and an application extension with a 3-byte data sub-block but
  NETSCAPE2.0's read as nothing; an LZW end code before the frame is full
  resets the table and drops the rest of its byte, a code that overruns
  the frame fails the file, and once the frame is full the next code ends
  the stream, the data having to end with it.
* Radiance HDR (rgbe.cpp): a header line ``FORMAT=32-bit_rle_rgbe``, then
  a blank line, then ``-Y H +X W``; a scanline that does not start 2, 2
  turns the rest of the image into flat pixels; each pixel
  m * 2^(e - 136) in float32, then 8 bits as imread converts them without
  IMREAD_ANYDEPTH: ``saturate(round_half_even(v * 255))``, and 0 where
  v * 255 reaches 2^31 (cvRound's INT_MIN), so cv2's HDR of an 8-bit
  image reads back within 1, not as it was.
* WebP (libwebp's simple API; WebPAnimDecoder for an animation): a VP8X
  file's alpha (ALPH, raw or lossless-coded) is decoded and dropped, so
  the colour is what it is under alpha 0 (no premultiplication) and a
  malformed ALPH fails the file; an animation reads as its first frame on
  a black canvas whatever its background colour and blending; libwebp's
  fancy chroma upsampler and 14-bit YUV -> RGB; the first EXIF chunk's
  orientation turns the image where the VP8X header's EXIF flag is set.
* JPEG 2000 (OpenJPEG 2.5, JP2 files and raw codestreams): a coefficient
  is reconstructed at the middle of its last decoded bit-plane's
  interval; the 9/7 is OpenJPEG's float32 lifting, its high-pass scaled
  by 1.625732422 (not 1/K) and the bands' step sizes taken without their
  log2 gain, rounded by lrintf (half to even); a 1-sample row or column
  at an odd coordinate is halved by C division on the 5/3 and left as it
  is on the 9/7; the ROI max-shift compares the magnitude at twice its
  scale, and BYPASS's raw passes are counted from the code-block's
  bit-planes without the ROI shift; a palette clamps indices past its
  last entry; cdef reorders channels as opj_jp2_apply_cdef does (alpha
  dropped); every sample is shifted right by the highest precision less
  8 and cut to 8 bits, whatever its own precision or its palette's; grey
  (replicated) only under a JP2 grey colour space, 3 or 4 components
  under sRGB, an ICC profile, another enumerated space or none; sYCC
  through cvtColor's 8-bit YUV -> BGR (14-bit fixed point: 2.032 U,
  -0.395 U - 0.581 V, 1.140 V); a tile the codestream lacks reads as 0;
  once every tile has all its tile-parts, what follows is not read if it
  is an EOC, a SOT or the stream's last two bytes, but a SOT that the
  tile-part count check takes for another part of the first tile.

Refused by name (FileNotFoundError naming the path and the format), each
where cv2.imread returns nothing or where the port does not decode it:
a gray PFM (``Pf``), PAM with 2 or 4 channels or a maxval of 1, Sun raster
run-length and RGB types; TIFF where cv2 reads nothing: below 8 bits but
for 1-bit grey and 4-bit palettes, float samples, more than 4 samples,
orientations 5-8 on a non-square image, LZMA, ZSTD, LERC, WebP and JPEG
2000 compression (libtiff's build lacks the codec), photometric
interpretations other than grey, RGB, palette, CMYK, YCbCr and CIELab
(ICCLab, ITULab, LogLuv ...), 16-bit CMYK, YCbCr or 8-bit-only layouts
at other depths, CMYK of another InkSet or fewer than 4 samples, YCbCr of
other than 3 samples or subsampled 1x4, 2x4 (or subsampled in separate
planes), CIELab in separate planes or of other than 3 samples, CCITT
of other than 1-bit samples; and TIFF no writer here (Pillow, cv2) makes:
old-style JPEG (6) and CCITT RLEW (32771) compression, JPEG of a palette,
of samples other than 8 bits or in separate planes, subsampled YCbCr
with the horizontal predictor; a GIF frame outside its
logical screen, Radiance HDR in XYZE or with a layout other than
-Y H +X W, a lossless WebP of a version other than 0; JPEG 2000 with an
image or tile-grid offset, signed or sub-sampled components, a precision
below 8 or above 31, more than 4 components, 1 or 2 components without a
JP2 grey colour space, sYCC of fewer than 3, the e-sYCC and CMYK colour
spaces, a codestream cut short (a tile-part past its end, no EOC after
the last tile-part), other bytes after the last tile-part but an EOC, a
SOT or two last bytes, a tile with no packet data, a JP2 file without ftyp
second or without a jp2h holding an ihdr before its codestream, or whose
ihdr size is not the codestream's (each where cv2 reads nothing), HTJ2K
(Part 15), Part 2 wavelets and component transforms, and
palettes other than every column from one index component; and the
format AVIF.
"""

from __future__ import annotations

import ctypes
import re
import struct
import zlib

import numpy as np

from ..native import build as codec

JP2_SIGNATURE = b"\0\0\0\x0cjP  \r\n\x87\n"
J2K_SIGNATURE = b"\xff\x4f\xff\x51"


class Refused(Exception):
    """A file of a format or coding the port does not read (the caller
    raises FileNotFoundError with the path)."""


def sniff(data: bytes):
    """The name of the decoder for data's signature (its first 12 bytes at
    most), or None."""
    if data[:2] == b"BM":
        return "bmp"
    if len(data) >= 2 and data[0:1] == b"P" and data[1:2] in b"1234567Ff":
        return "pxm"
    if data[:4] == b"\x59\xa6\x6a\x95":
        return "sun"
    if data[:4] in (b"II*\0", b"MM\0*", b"II+\0", b"MM\0+"):
        return "tiff"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if data.startswith((b"#?RADIANCE", b"#?RGBE")):
        return "hdr"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data.startswith((JP2_SIGNATURE, J2K_SIGNATURE)):
        return "jpeg2000"
    return None


def refused_name(data: bytes):
    if data[4:8] == b"ftyp" and data[8:12] in (b"avif", b"avis"):
        return "AVIF"
    return None


def decode(kind: str, data: bytes, what: str) -> np.ndarray:
    """(H, W, 3) RGB uint8 of data, a file of kind sniff() named; raises
    Refused for a coding refused by name, ValueError for a malformed
    file."""
    img = {"bmp": decode_bmp, "pxm": decode_pxm, "sun": decode_sun,
           "tiff": decode_tiff, "gif": decode_gif, "hdr": decode_hdr,
           "webp": decode_webp, "jpeg2000": decode_jpeg2000}[kind](data,
                                                                   what)
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
# type -> struct format of one value (RATIONAL and SRATIONAL: a pair)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q", 17: "q", 18: "Q"}
_COMPRESSIONS = {32771: "CCITT RLEW", 6: "old-style JPEG",
                 34712: "JPEG 2000", 34887: "LERC", 34925: "LZMA",
                 50000: "ZSTD", 50001: "WebP", 32946: None, 8: None,
                 1: None, 5: None, 32773: None, 7: None, 2: None, 3: None,
                 4: None}
# the compressions whose stored bits libtiff reverses under FillOrder 2
# (the CCITT decoders read them in that order, JPEG ignores the tag)
_BIT_REVERSED = (1, 5, 8, 32946, 32773)
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
# libtiff's YCbCr subsamplings (tif_getimage.c's put routines)
_SUBSAMPLINGS = ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (4, 4))
# CIE D50 (tif_aux.c's default WhitePoint), as float32 chromaticities
_D50 = np.float32([96.4250, 100.0, 82.4680])
_D50_WHITE = (_D50[0] / (_D50[0] + _D50[1] + _D50[2]),
              _D50[1] / (_D50[0] + _D50[1] + _D50[2]))


def _ifd(data: bytes, what: str) -> dict:
    """The first IFD's tags: tag -> tuple of values (RATIONAL and
    SRATIONAL as float32 numerator / denominator, as libtiff reads them
    into floats); classic TIFF or BigTIFF (version 43: 8-byte offsets,
    counts and inline values, 20-byte entries)."""
    bo = "<" if data[:2] == b"II" else ">"
    _need(data, 8, what, "TIFF")
    big = struct.unpack_from(bo + "H", data, 2)[0] == 43
    if big:
        _need(data, 16, what, "BigTIFF")
        if struct.unpack_from(bo + "HH", data, 4) != (8, 0):
            raise ValueError(f"{what}: BigTIFF header of another offset size")
        pos = struct.unpack_from(bo + "Q", data, 8)[0]
    else:
        pos = struct.unpack_from(bo + "I", data, 4)[0]
    count_fmt, entry_fmt, inline = ("Q", "HHQ8s", 8) if big else ("H",
                                                                  "HHI4s", 4)
    head = struct.calcsize(bo + count_fmt)
    step = struct.calcsize(bo + entry_fmt)
    _need(data, pos + head, what, "TIFF")
    n = struct.unpack_from(bo + count_fmt, data, pos)[0]
    _need(data, pos + head + step * n, what, "TIFF")
    tags = {}
    for i in range(n):
        tag, typ, count, val = struct.unpack_from(bo + entry_fmt, data,
                                                  pos + head + step * i)
        if typ not in _TYPES:
            continue
        fmt = _TYPES[typ]
        size = struct.calcsize(bo + fmt) * count
        if size > inline:
            off = struct.unpack(bo + ("Q" if big else "I"), val)[0]
            _need(data, off + size, what, "TIFF")
            raw = data[off:off + size]
        else:
            raw = val[:size]
        v = struct.unpack(bo + fmt * count, raw)
        if typ in (5, 10):
            v = tuple(np.float32(a) / np.float32(b) if b else np.float32(0)
                      for a, b in zip(v[::2], v[1::2]))
        tags[tag] = v
    tags["bo"] = bo
    return tags


def _tiff_check(t, spp, bps, comp, photo, planar, predictor):
    """Refuse (by name) what cv2 reads as nothing or no writer here makes;
    the colour channels' layout otherwise."""
    if comp not in _COMPRESSIONS or _COMPRESSIONS[comp]:
        name = _COMPRESSIONS.get(comp) or f"{comp}"
        why = ("no writer here makes it" if comp in (6, 32771) else
               "cv2 reads nothing: libtiff's build lacks the codec")
        raise Refused(f"TIFF with {name} compression ({why})")
    if spp > 4:
        raise Refused(f"TIFF with {spp} samples a pixel (cv2 reads nothing)")
    allowed = {0: (1, 8, 16), 1: (1, 8, 16), 2: (8, 16), 3: (1, 4, 8),
               5: (8,), 6: (8,), 8: (8, 16)}
    if photo not in allowed:
        raise Refused(f"TIFF with photometric interpretation {photo} (cv2 "
                      "reads nothing)")
    if bps not in allowed[photo]:
        raise Refused(f"TIFF of photometric interpretation {photo} at "
                      f"{bps} bits (cv2 reads nothing)")
    extra = t.get(338, ())
    if photo == 2 and spp - len(extra) < 3 \
            or photo in (0, 1, 3) and bps < 8 and spp > 1 \
            or photo == 5 and spp != 4 or photo in (6, 8) and spp != 3:
        raise Refused(f"TIFF with {spp} samples of {bps} bits at "
                      f"photometric interpretation {photo} (cv2 reads "
                      "nothing)")
    if photo == 5 and t.get(332, (1,))[0] != 1:
        raise Refused(f"CMYK TIFF with InkSet {t[332][0]} (cv2 reads "
                      "nothing)")
    if photo == 8 and planar == 2:
        raise Refused("CIELab TIFF in separate planes (cv2 reads nothing)")
    if predictor not in (1, 2) or predictor == 2 and bps < 8:
        raise Refused(f"TIFF predictor {predictor} at {bps} bits")
    sub = (1, 1)
    if photo == 6:
        sub = tuple(t.get(530, (2, 2))[:2])
        if sub not in _SUBSAMPLINGS or planar == 2 and sub != (1, 1):
            raise Refused(f"YCbCr TIFF subsampled {sub[0]}x{sub[1]}"
                          + (" in separate planes" if planar == 2 else "")
                          + " (cv2 reads nothing)")
        if sub != (1, 1) and predictor == 2 and comp != 7:
            raise Refused("subsampled YCbCr TIFF with the horizontal "
                          "predictor (no writer here makes it)")
    if comp == 7:
        if bps != 8 or photo == 3 or planar == 2 and spp > 1:
            raise Refused("JPEG-compressed TIFF of "
                          + ("a palette" if photo == 3 else
                             f"{bps}-bit samples" if bps != 8 else
                             "separate planes")
                          + " (no writer here makes it)")
    if comp in (2, 3, 4) and (bps != 1 or spp != 1):
        raise Refused(f"CCITT-compressed TIFF of {spp} samples of {bps} "
                      "bits (cv2 reads nothing)")
    return sub


def decode_tiff(data: bytes, what: str = "TIFF") -> np.ndarray:
    t = _ifd(data, what)

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
    if one(339, 1) not in (1, 2):
        raise Refused(f"TIFF with sample format {one(339)} (float or "
                      "complex samples)")
    orientation = one(274, 1)
    if not 1 <= orientation <= 8:
        raise Refused(f"TIFF with orientation {orientation}")
    if orientation >= 5 and w != h:
        # cv2 turns the image as EXIF says, and reads nothing where the
        # turn swaps a non-square image's height and width
        raise Refused(f"TIFF with orientation {orientation} on a "
                      f"{w}x{h} image")
    sub = _tiff_check(t, spp, bps, comp, photo, planar, predictor)
    separate = planar == 2 and spp > 1
    layout = _Layout(t, w, h, spp, separate, what)
    predict = predictor == 2 and comp in (5, 8, 32946)
    if comp == 7:
        s = _tiff_jpeg(data, t, layout, spp, photo, sub, what)
        if photo == 6:  # libjpeg's RGB
            photo, spp, t = 2, 3, {**t, 338: ()}
    elif photo == 6 and not separate:
        s = _tiff_ycbcr(data, t, layout, comp, predict, sub, what)
        photo, spp, t = 2, 3, {**t, 338: ()}
    else:
        s = _tiff_samples(data, t, layout, spp, bps, comp, predict, what)
    rgb = _tiff_rgba(s, t, photo, bps, spp, t.get(338, ()), separate)
    return _tiff_orient(rgb, layout, orientation)


class _Layout:
    """The strips or tiles of a TIFF: chunk size (ch, cw), offsets and
    byte counts, planes, chunks across and down."""

    def __init__(self, t, w, h, spp, separate, what):
        self.w, self.h = w, h
        self.tiled = 322 in t
        if self.tiled:
            self.cw, self.ch = t[322][0], t[323][0]
            self.offsets, self.counts = t.get(324), t.get(325)
        else:
            self.cw, self.ch = w, min(t.get(278, (h,))[0], h)
            self.offsets, self.counts = t.get(273), t.get(279)
        if not self.offsets or not self.counts \
                or len(self.offsets) != len(self.counts):
            raise ValueError(f"{what}: TIFF without its strip or tile "
                             "offsets")
        self.planes = spp if separate else 1
        self.per = 1 if separate else spp
        self.across = -(-w // self.cw)
        self.down = -(-h // self.ch)
        n = self.planes * self.across * self.down
        if len(self.offsets) < n:
            raise ValueError(f"{what}: TIFF lists {len(self.offsets)} "
                             f"strips or tiles of {n}")
        self.reverse = t.get(266, (1,))[0] == 2

    def chunks(self, data):
        """(plane, row, column, rows, stored bytes) of each strip or tile,
        rows the ones it holds (a strip's at the image's end)."""
        k = 0
        for p in range(self.planes):
            for ty in range(self.down):
                for tx in range(self.across):
                    rows = self.ch if self.tiled else min(
                        self.ch, self.h - ty * self.ch)
                    raw = data[self.offsets[k]:self.offsets[k]
                               + self.counts[k]]
                    k += 1
                    yield p, ty * self.ch, tx * self.cw, rows, raw


def _tiff_samples(data, t, lay, spp, bps, comp, predict, what):
    """(h, w, spp) samples, uint8 or uint16 (or (h, w, 1) below 8 bits,
    unpacked)."""
    dt = np.dtype(t["bo"] + "u2") if bps == 16 else np.dtype(np.uint8)
    rowbytes = (lay.cw * lay.per * bps + 7) // 8
    out = np.zeros((lay.planes, lay.down * lay.ch, lay.across * lay.cw,
                    lay.per), np.uint16 if bps == 16 else np.uint8)
    for p, y, x, rows, raw in lay.chunks(data):
        if comp in (2, 3, 4):
            buf = np.empty((rows, rowbytes), np.uint8)
            codec.call("thc_tiff_fax", raw, len(raw), comp,
                       t.get(292, (0,))[0] & 1 if comp == 3 else 0,
                       int(lay.reverse), lay.cw, rows, buf.ctypes.data,
                       rowbytes, what=what)
            chunk = buf.tobytes()
        else:
            if lay.reverse and comp in _BIT_REVERSED:
                raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
            chunk = _inflate(raw, comp, rowbytes * rows, what)
        if bps < 8:
            v = _unpack_bits(np.frombuffer(chunk, np.uint8).reshape(
                rows, rowbytes), bps, lay.cw)[..., None]
        else:
            v = np.frombuffer(chunk, dt).reshape(rows, lay.cw, lay.per)
            if predict:
                v = np.cumsum(v, axis=1, dtype=v.dtype.newbyteorder("="))
        out[p, y:y + rows, x:x + lay.cw] = v
    out = out[:, :lay.h, :lay.w]
    return np.moveaxis(out[..., 0], 0, -1) if lay.planes > 1 else out[0]


def _tiff_jpeg(data, t, lay, spp, photo, sub, what) -> np.ndarray:
    """(h, w, c) samples of a JPEG-compressed TIFF: each strip or tile an
    abbreviated stream after the JPEGTables stream; contiguous YCbCr as
    libjpeg's RGB (c = 3), else the components as they are (c = spp)."""
    tables = bytes(t.get(347, b""))
    ycbcr = photo == 6
    hs, vs = sub
    out = np.zeros((lay.down * lay.ch, lay.across * lay.cw, spp), np.uint8)
    for _, y, x, rows, raw in lay.chunks(data):
        buf = np.empty((rows, lay.cw, spp), np.uint8)
        # a last strip's stream may hold every row of a full strip
        taller = not lay.tiled and y + rows == lay.h
        codec.call("thc_tiff_jpeg", tables, len(tables), raw, len(raw),
                   int(ycbcr), hs, vs, spp, rows, lay.cw, int(taller),
                   buf.ctypes.data, what=what)
        out[y:y + rows, x:x + lay.cw] = buf
    return out[:lay.h, :lay.w]


def _floats(t, tag, default) -> np.ndarray:
    v = t.get(tag)
    return np.asarray(default if v is None else v, np.float32)


def _tiff_ycbcr(data, t, lay, comp, predict, sub, what) -> np.ndarray:
    """(h, w, 3) RGB of contiguous YCbCr, each strip or tile as libtiff's
    put routine for its subsampling converts it."""
    hs, vs = sub
    luma = _floats(t, 529, (0.299, 0.587, 0.114))
    rbw = _floats(t, 532, (0, 255, 128, 255, 128, 255))
    out = np.zeros((lay.down * lay.ch, lay.across * lay.cw, 3), np.uint8)
    for _, y, x, rows, raw in lay.chunks(data):
        if lay.reverse and comp in _BIT_REVERSED:
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        size = -(-rows // vs) * -(-lay.cw // hs) * (hs * vs + 2)
        chunk = _inflate(raw, comp, size, what)
        if predict:  # 1x1 only: three samples a pixel
            chunk = np.cumsum(np.frombuffer(chunk, np.uint8).reshape(
                rows, lay.cw, 3), axis=1, dtype=np.uint8).tobytes()
        # the part of the strip or tile inside the image
        rh, rw = min(rows, lay.h - y), min(lay.cw, lay.w - x)
        rgb = np.empty((rh, rw, 3), np.uint8)
        codec.call("thc_tiff_ycbcr", chunk, len(chunk), rh, rw, lay.cw, hs,
                   vs, luma.ctypes.data, rbw.ctypes.data, rgb.ctypes.data,
                   what=what)
        out[y:y + rh, x:x + rw] = rgb
    return out[:lay.h, :lay.w]


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
    if photo in (5, 6, 8):
        s = np.ascontiguousarray(s)
        out = np.empty(s.shape[:2] + (3,), np.uint8)
        if photo == 5:  # putRGBcontig8bitCMYKtile, putCMYKseparate8bittile
            codec.call("thc_tiff_cmyk", s.ctypes.data,
                       s.shape[0] * s.shape[1], s.shape[2], out.ctypes.data,
                       what="CMYK TIFF")
        elif photo == 6:  # separate planes, 1x1
            codec.call("thc_tiff_ycbcr", s.ctypes.data, s.nbytes, s.shape[0],
                       s.shape[1], s.shape[1], 1, 1,
                       _floats(t, 529, (0.299, 0.587, 0.114)).ctypes.data,
                       _floats(t, 532, (0, 255, 128, 255, 128,
                                        255)).ctypes.data, out.ctypes.data,
                       what="YCbCr TIFF")
        else:
            s = np.ascontiguousarray(s, s.dtype.newbyteorder("="))
            white = _floats(t, 318, _D50_WHITE)
            codec.call("thc_tiff_lab", s.ctypes.data, s.shape[0] * s.shape[1],
                       int(bps == 16), white.ctypes.data, out.ctypes.data,
                       what="CIELab TIFF")
        return out
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


def _tiff_orient(rgb, lay, orientation) -> np.ndarray:
    """rgb (the image in the file's order) as cv2 reads it under the
    orientation tag: each strip or tile of libtiff's RGBA reading
    (TIFFReadRGBAStrip / Tile, which flip what they read to the bottom-left
    origin the tag asks for) placed where cv2 puts it (from the bottom for
    orientations 3, 4, 7 and 8), then turned as imread turns an EXIF
    orientation of 5-8 (a transpose, and 180 degrees for 6 and 8).  For
    strips this is the EXIF orientation of the whole image; a tile is
    flipped on its own."""
    if orientation == 1:
        return rgb
    flip_v = orientation in (1, 2, 5, 6)
    flip_h = orientation in (2, 3, 6, 7)
    from_bottom = orientation in (3, 4, 7, 8)
    out = np.empty_like(rgb)
    for y in range(0, lay.h, lay.ch):
        for x in range(0, lay.w, lay.cw):
            r = rgb[y:y + lay.ch, x:x + lay.cw]
            if not flip_v:  # the tile reaches cv2 bottom row first
                r = r[::-1]
            if flip_h:
                r = r[:, ::-1]
            iy = lay.h - y - r.shape[0] if from_bottom else y
            out[iy:iy + r.shape[0], x:x + r.shape[1]] = r
    if orientation >= 5:
        out = out.transpose(1, 0, 2)
        if orientation in (6, 8):
            out = out[::-1, ::-1]
    return np.ascontiguousarray(out)


# ------------------------------ GIF, Radiance HDR, WebP and JPEG 2000
# the codec's entries for each: info, decode, leading arguments (GIF and
# Radiance HDR share imgcodec.cc's, told apart by a kind; WebP is webp.cc's,
# JPEG 2000 jpeg2000.cc's)
_ENTRIES = {"gif": ("thc_image_info", "thc_image_decode", (0,)),
            "hdr": ("thc_image_info", "thc_image_decode", (1,)),
            "webp": ("thc_webp_info", "thc_webp_decode", ()),
            "jpeg2000": ("thc_j2k_info", "thc_j2k_decode", ())}


def _native(kind: str, data: bytes, what: str) -> np.ndarray:
    info, dec, lead = _ENTRIES[kind]
    h, w = ctypes.c_int(), ctypes.c_int()
    codec.call(info, *lead, data, len(data), ctypes.byref(h),
               ctypes.byref(w), what=what, refused=Refused)
    if max(h.value, w.value) > 1 << 20 or h.value * w.value > 1 << 30:
        # imread's CV_IO_MAX_IMAGE_WIDTH / HEIGHT / PIXELS
        raise ValueError(f"{what}: {h.value}x{w.value} pixels is more than "
                         "imread reads")
    out = np.empty((h.value, w.value, 3), np.uint8)
    codec.call(dec, *lead, data, len(data), out.ctypes.data, h.value,
               w.value, what=what, refused=Refused)
    return out


def decode_gif(data: bytes, what: str = "GIF") -> np.ndarray:
    return _native("gif", data, what)


def decode_hdr(data: bytes, what: str = "Radiance HDR") -> np.ndarray:
    return _native("hdr", data, what)


def decode_webp(data: bytes, what: str = "WebP") -> np.ndarray:
    rgb = _native("webp", data, what)
    # imread turns the image by the first EXIF chunk where the VP8X
    # header's EXIF flag is set
    if data[12:16] != b"VP8X" or len(data) < 21 or not data[20] & 0x08:
        return rgb
    pos, end = 12, 8 + struct.unpack_from("<I", data, 4)[0]
    while pos + 8 <= min(end, len(data)):
        n = struct.unpack_from("<I", data, pos + 4)[0]
        if data[pos:pos + 4] == b"EXIF":
            return exif_orient(rgb, data[pos + 8:pos + 8 + n])
        pos += 8 + n + (n & 1)
    return rgb


def decode_jpeg2000(data: bytes, what: str = "JPEG 2000") -> np.ndarray:
    return _native("jpeg2000", data, what)


def exif_orient(rgb: np.ndarray, tiff: bytes) -> np.ndarray:
    """rgb turned as the orientation of the EXIF (TIFF) block ``tiff``
    says, as imread turns it (height and width swap for 5-8)."""
    orientation = codec.library().thc_exif_orientation(tiff, len(tiff))
    if not 2 <= orientation <= 8:
        return rgb
    h, w = rgb.shape[:2]
    out = np.empty((w, h, 3) if orientation >= 5 else (h, w, 3), np.uint8)
    codec.library().thc_orient_rgb(rgb.ctypes.data, h, w, orientation,
                                   out.ctypes.data)
    return out
