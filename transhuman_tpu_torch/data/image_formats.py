"""The frame formats ``cv2.imread`` reads beside JPEG and PNG, decoded as
OpenCV 5 decodes them into (H, W, 3) RGB uint8 (its BGR result after
``COLOR_BGR2RGB``): BMP, PxM (PBM, PGM, PPM, PAM, PFM), Sun raster, TIFF,
GIF, Radiance HDR, WebP, JPEG 2000 and AVIF.  Headers, plain raster
layouts and AVIF's HEIF boxes are read with numpy and struct; the
byte-serial codings (BMP RLE4/RLE8, TIFF PackBits, LZW, JPEG and CCITT,
TIFF's YCbCr and CIELab conversions, GIF's LZW, HDR's run-length
scanlines, every stage of WebP's lossless and lossy decoders, all of JPEG
2000, AV1 and AVIF's conversion to RGB) run in ``native/imgcodec.cc``,
``native/tiff.cc``, ``native/webp.cc``, ``native/jpeg2000.cc`` and
``native/av1.cc``, TIFF Deflate in the standard library's zlib, so no
frame decode loops over bytes in Python.

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
* AVIF (libavif 1.4 with libaom 3.14): the source libavif's automatic
  choice reads (major brand avis the tracks, avif the primary item,
  another the tracks where the brands made it read the moov box: a file
  whose brands need only meta is read up to it); an image sequence's
  colour track (the first trak with a tkhd id, a sample table of chunks,
  an av01 sample entry and no tref auxl): its first sample, found as
  libavif lists samples (stco or co64, stsc runs, stsz's constant or
  per-sample sizes; every sample within the file), decoded as an item's
  frame and scaled to the tkhd size, its av1C and nclx from the sample
  entry's boxes after its 78-byte VisualSampleEntry, an Exif item of the
  track's own meta box applied (not the file's), the alpha track (tref
  auxl to it) decoded and dropped (a failing one, or one of another size
  or depth, fails the file); the layered-image properties of an av01 item
  or a grid's tile: a1lx's layer sizes held to the item's size, lsel of
  layer L (not 0xFFFF) decoding a1lx's first L + 1 layers and failing
  where the stream has no frame of spatial layer L, a1op's operating point
  (libaom takes 0 past a stream's count); the primary item of
  the meta box (hdlr pict; pitm, iinf v2/v3, iloc v0-2 from the file or
  idat, iref, ipco/ipma), an av01 item or a grid of them; an AV1 key
  frame decoded to libaom's planes, loop restoration and film grain
  included (libaom grains the picture it outputs, and libavif converts
  the grained planes), each plane scaled to the item's ispe where that is
  not the frame's size (libavif's avifImageScale: libyuv's ScalePlane or
  ScalePlane_12 with kFilterBox, chroma at its subsampled size, before
  10 and 12 bits are cut); a grid's ImageGrid (in mdat or idat, 16 or
  32-bit fields) and its dimg tiles, decoded and scaled so, their planes
  joined row-major and cropped to the grid's output size before one
  conversion (tiles of other av1C fields, sizes, depths or colour, fewer
  than 64 samples a side, odd where chroma is subsampled, or not covering
  the output fail the file, as an ImageGrid whose size is not the grid's
  ispe does); the colr nclx box's CICP and range where there is one, the
  (first tile's) sequence header's otherwise; an alpha item or grid
  (auxl, auxC alpha) decoded (a failing one fails the file) and dropped;
  irot, imir and clap, which libavif requires to be essential, not
  applied, an Exif item's orientation applied where its data starts as
  TIFF does; cv2's signature check, libavif's parse of the file's first
  500 bytes, failing where a grid's ImageGrid, an Exif or XMP item or
  (without nclx) the AV1 data or first sample it reads starts past them,
  or where it walks past them over a box before the meta or moov box the
  brands need; 8-bit output as
  OpenCV asks libavif for it: a grey image is the Y plane (10 and 12 bits
  cut by ``convertTo``, half to even; the range ignored), a colour one
  libyuv's fixed-point conversion (bilinear 4:2:0, linear 4:2:2 chroma)
  after 10 and 12-bit planes are cut to 8 bits (``Convert16To8Plane``)
  for BT.601, unspecified, BT.709, BT.2020 NCL and chroma-derived NCL of
  those primaries (1, 2, 5, 6, 9), libavif's float conversion (9-3-3-1
  bilinear chroma) for identity, FCC, SMPTE 240M, YCgCo, chroma-derived
  NCL of any other primaries (Kr and Kb computed from libavif's
  primaries table, BT.709's for a code it lacks) and matrix coefficients
  15 (BT.601's Kr and Kb, libavif's default).

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
palettes other than every column from one index component; AVIF where
cv2 reads nothing (a cut file, irot, imir, clap, a1op or lsel not marked
essential, a1lx marked essential or of layers past the item, a1op past
31, lsel past 3 or of a layer the stream lacks, an unknown essential
property, no ispe or av1C, two nclx boxes, a failing alpha item or
track, identity of subsampled chroma, YCgCo of limited range, matrix
coefficients 3, 10, 11, 13, 14 and 16 up, a grid libavif fails, a track
box or sample table libavif fails (versions, stsc runs, a chunk of no
samples, sizes cut short, a sample past the end of the file, an elst of
other than one entry), a first sample other than a shown key frame, what
cv2's signature check does not pass) and AVIF the port does not decode:
AV1 superres, a stream of more than one operating point's layers (and so
a spatial layer past 0 that lsel selects), premultiplied alpha (prem).
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
    if data[4:8] == b"ftyp" and (data[8:12] in AVIF_BRANDS
                                 or AVIF_BRANDS[0] in _ftyp_brands(data)
                                 or AVIF_BRANDS[1] in _ftyp_brands(data)):
        return "avif"
    return None


def decode(kind: str, data: bytes, what: str) -> np.ndarray:
    """(H, W, 3) RGB uint8 of data, a file of kind sniff() named; raises
    Refused for a coding refused by name, ValueError for a malformed
    file."""
    img = {"bmp": decode_bmp, "pxm": decode_pxm, "sun": decode_sun,
           "tiff": decode_tiff, "gif": decode_gif, "hdr": decode_hdr,
           "webp": decode_webp, "jpeg2000": decode_jpeg2000,
           "avif": decode_avif}[kind](data, what)
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


# ------------------------------------------------------------------- AVIF
AVIF_BRANDS = (b"avif", b"avis")
# auxC types of an alpha item (libavif's avifIsAlpha)
_ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
               b"urn:mpeg:hevc:2015:auxid:1")
# item properties libavif reads; any other marked essential fails the file
_AVIF_PROPERTIES = (b"ispe", b"av1C", b"colr", b"pixi", b"auxC", b"irot",
                    b"imir", b"clap", b"pasp", b"a1op", b"lsel", b"a1lx")
# properties libavif requires to be marked essential
_AVIF_ESSENTIAL = (b"irot", b"imir", b"clap", b"a1op", b"lsel")
# libavif's default limit on a sequence's frames (imageCountLimit)
_AVIF_FRAME_LIMIT = 12 * 3600 * 60


class _Cut(Exception):
    """An AVIF box or item past the end of its container."""


def _ftyp_brands(data: bytes) -> tuple:
    """The compatible brands of a leading ftyp box (what data holds of
    it)."""
    if len(data) < 16 or data[4:8] != b"ftyp":
        return ()
    end = min(len(data), struct.unpack_from(">I", data, 0)[0])
    return tuple(data[i:i + 4] for i in range(16, end - 3, 4))


def _boxes(data: bytes, start: int, end: int):
    """(type, body start, body end) of each ISOBMFF box in data[start:end];
    _Cut where a box runs past end."""
    pos = start
    while pos < end:
        if pos + 8 > end:
            raise _Cut("a box header")
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise _Cut("a box header")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise _Cut(f"the {kind.decode('latin-1')!r} box")
        yield kind, pos + head, pos + size
        pos += size


def _uint(data: bytes, pos: int, n: int) -> int:
    return int.from_bytes(data[pos:pos + n], "big")


def _box_need(end: int, limit: int, what: str):
    if end > limit:
        raise ValueError(f"the {what} box cut short")


def _top_boxes(data: bytes, end: int):
    """(type, body start, body end) of data[:end]'s top-level boxes as
    libavif's avifParse walks them: ftyp, meta and moov read whole (_Cut
    where one runs past end), any other box skipped, until ftyp and the
    boxes its brands need (meta for avif, moov for avis) have been read;
    ValueError where a box header runs past end or the walk would go on
    past it, _Cut where end comes first."""
    pos, need, seen = 0, None, set()
    while pos < end:
        if pos + 8 > end:
            raise ValueError("a box header cut short")
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            if pos + 16 > end:
                raise ValueError("a box header cut short")
            size, head = struct.unpack_from(">Q", data, pos + 8)[0], 16
        elif size == 0:
            size = end - pos
        if size < head:
            raise ValueError(f"a {kind!r} box of {size} bytes")
        if kind in (b"ftyp", b"meta", b"moov"):
            if kind in seen:
                raise ValueError(f"a second {kind.decode('latin-1')} box")
            if pos + size > end:
                raise _Cut(f"the {kind.decode('latin-1')!r} box")
            seen.add(kind)
        yield kind, pos + head, pos + size
        if kind == b"ftyp":
            brands = _brands(data, pos + head, pos + size)
            need = {b"ftyp"} | {k for k, brand in ((b"meta", b"avif"),
                                                    (b"moov", b"avis"))
                                 if brand in brands}
        pos += size
        if need is not None and need <= seen:
            return
    if pos > end:
        raise ValueError(f"a box header past byte {end}")
    raise _Cut("the file (no ftyp, or no meta or moov box its brands "
               "need)")


def _brands(data: bytes, s: int, e: int) -> tuple:
    """ftyp's major brand, then its compatible brands."""
    if e - s < 8 or (e - s) % 4:
        raise ValueError("ftyp box of another length")
    return (data[s:s + 4],) + tuple(data[i:i + 4] for i in range(s + 8, e, 4))


class _Heif:
    """An AVIF file's meta box (its still-image items) and moov box (its
    tracks), parsed as libavif parses them; ``from_tracks`` where libavif's
    automatic source is the tracks: major brand avis, or neither avif nor
    avis with a track read (where the brands do not need the moov box,
    libavif stops before it)."""

    def __init__(self, data: bytes, meta=None):
        """meta: (start, end) of a track's meta box body, read alone."""
        self.data = data
        self.types, self.names, self.locations = {}, {}, {}
        self.content_types = {}
        self.refs, self.props, self.assoc = [], [], {}
        self.primary, self.idat, self.brands = None, b"", ()
        self.tracks = []
        if meta is not None:
            self._meta(meta[0] + 4, meta[1])
            return
        for kind, s, e in _top_boxes(data, len(data)):
            if kind == b"ftyp":
                self.brands = _brands(data, s, e)
                if not set(self.brands) & set(AVIF_BRANDS):
                    raise ValueError("AVIF file without an avif or avis brand")
            elif kind == b"meta":
                meta = (s, e)
            elif kind == b"moov":
                for k2, s2, e2 in _boxes(data, s, e):
                    if k2 == b"trak":
                        self.tracks.append(_Track(data, s2, e2))
                if not self.tracks:
                    raise ValueError("moov box without tracks")
        major = self.brands[0]
        self.from_tracks = major == b"avis" or (major != b"avif"
                                                and bool(self.tracks))
        if meta is not None:
            self._meta(meta[0] + 4, meta[1])
        if not self.from_tracks and self.primary is None:
            raise ValueError("AVIF file without a primary item (pitm)")

    def _meta(self, start: int, end: int):
        d = self.data
        handler = None
        for kind, s, e in _boxes(d, start, end):
            if kind == b"hdlr":
                handler = d[s + 8:s + 12]
            elif kind == b"pitm":
                self.primary = _uint(d, s + 4, 2 if d[s] == 0 else 4)
            elif kind == b"idat":
                self.idat = d[s:e]
            elif kind == b"iinf":
                n = 2 if d[s] == 0 else 4
                for k2, s2, e2 in _boxes(d, s + 4 + n, e):
                    if k2 != b"infe":
                        continue
                    version = d[s2]
                    if version not in (2, 3):
                        continue
                    w = 2 if version == 2 else 4
                    iid = _uint(d, s2 + 4, w)
                    kind3 = d[s2 + 4 + w + 2:s2 + 4 + w + 6]
                    self.types[iid] = kind3
                    if kind3 == b"mime":  # item_name, then content_type
                        rest = d[s2 + 4 + w + 6:e2].split(b"\0")
                        self.content_types[iid] = rest[1] if len(rest) > 1 \
                            else b""
            elif kind == b"iloc":
                self._iloc(s, e)
            elif kind == b"iref":
                w = 2 if d[s] == 0 else 4
                for k2, s2, e2 in _boxes(d, s + 4, e):
                    src = _uint(d, s2, w)
                    count = _uint(d, s2 + w, 2)
                    for i in range(count):
                        self.refs.append((k2, src, _uint(d, s2 + w + 2 + w * i,
                                                         w)))
            elif kind == b"iprp":
                for k2, s2, e2 in _boxes(d, s, e):
                    if k2 == b"ipco":
                        self.props = [(k3, s3, e3) for k3, s3, e3
                                      in _boxes(d, s2, e2)]
                    elif k2 == b"ipma":
                        self._ipma(s2, e2)
        if handler != b"pict":
            raise ValueError(f"AVIF meta handler {handler!r} (not pict)")
        # what libavif's ipco and ipma parse checks of every property and
        # association, whether or not an item it decodes has them
        for kind, s, e in self.props:
            _check_property(d, kind, s, e)
        for iid, assoc in self.assoc.items():
            for index, essential in assoc:
                if index > len(self.props):
                    raise ValueError("AVIF ipma index past ipco")
                kind = self.props[index - 1][0]
                if kind == b"a1lx" and essential:
                    raise ValueError("a1lx property marked essential")
                if kind in (b"a1op", b"lsel") and not essential:
                    raise ValueError(f"{kind.decode('latin-1')} property "
                                     "not marked essential")

    def _iloc(self, s: int, e: int):
        d = self.data
        version = d[s]
        if version > 2:
            raise ValueError(f"AVIF iloc version {version}")
        off, length = d[s + 4] >> 4, d[s + 4] & 15
        base, index = d[s + 5] >> 4, (d[s + 5] & 15 if version else 0)
        if any(v not in (0, 4, 8) for v in (off, length, base, index)):
            raise ValueError("AVIF iloc field sizes")
        pos = s + 6
        w = 2 if version < 2 else 4
        count = _uint(d, pos, w)
        pos += w
        for _ in range(count):
            iid = _uint(d, pos, w)
            pos += w
            method = 0
            if version:
                method = _uint(d, pos, 2) & 15
                pos += 2
            pos += 2  # data_reference_index
            base_offset = _uint(d, pos, base)
            pos += base
            extents = []
            n = _uint(d, pos, 2)
            pos += 2
            for _ in range(n):
                pos += index
                extents.append((base_offset + _uint(d, pos, off),
                                _uint(d, pos + off, length)))
                pos += off + length
            if pos > e:
                raise _Cut("the iloc box")
            self.locations[iid] = (method, extents)

    def _ipma(self, s: int, e: int):
        d = self.data
        version, flags = d[s], _uint(d, s + 1, 3)
        pos = s + 4
        count = _uint(d, pos, 4)
        pos += 4
        w = 2 if version < 1 else 4
        for _ in range(count):
            iid = _uint(d, pos, w)
            pos += w
            n = d[pos]
            pos += 1
            for _ in range(n):
                if flags & 1:
                    v = _uint(d, pos, 2)
                    pos += 2
                    essential, index = v >> 15, v & 0x7FFF
                else:
                    essential, index = d[pos] >> 7, d[pos] & 0x7F
                    pos += 1
                if index:
                    self.assoc.setdefault(iid, []).append((index, essential))
        if pos > e:
            raise _Cut("the ipma box")

    def properties(self, iid: int) -> dict:
        """{property type: [body (start, end)], ...} of item iid; Refused
        for an essential property libavif does not read."""
        out = {}
        for index, essential in self.assoc.get(iid, ()):
            if index > len(self.props):
                raise ValueError("AVIF ipma index past ipco")
            kind, s, e = self.props[index - 1]
            if kind not in _AVIF_PROPERTIES and essential:
                raise Refused(f"AVIF essential property "
                              f"{kind.decode('latin-1')}")
            if kind in _AVIF_ESSENTIAL and not essential:
                raise ValueError(f"{kind.decode('latin-1')} property not "
                                 "marked essential")
            out.setdefault(kind, []).append((s, e))
        if sum(self.data[s:s + 4] == b"nclx"
               for s, _ in out.get(b"colr", ())) > 1:
            raise ValueError("two nclx colour properties")
        return out

    def item(self, iid: int) -> bytes:
        if iid not in self.locations:
            raise ValueError(f"AVIF item {iid} without a location (iloc)")
        method, extents = self.locations[iid]
        if method not in (0, 1):
            raise Refused(f"AVIF item construction method {method}")
        src = self.data if method == 0 else self.idat
        parts = []
        for start, n in extents:
            if n == 0:
                n = len(src) - start
            if start + n > len(src):
                raise _Cut(f"item {iid}'s data")
            parts.append(src[start:start + n])
        return b"".join(parts)


def _check_property(d: bytes, kind: bytes, s: int, e: int):
    """ValueError where libavif's parse of a property fails the file: a
    layered image's a1op (an operating point past 31), lsel (a layer past
    3 but 0xFFFF, every layer) and a1lx (reserved bits, fields cut
    short)."""
    if kind == b"a1op" and (e - s < 1 or d[s] > 31):
        raise ValueError("a1op of an operating point past 31")
    if kind == b"lsel" and (e - s < 2 or 3 < _uint(d, s, 2) < 0xFFFF):
        raise ValueError("lsel of a layer past 3")
    if kind == b"a1lx" and (e - s < 1 or d[s] >> 1 or
                            e - s < 1 + 3 * (4 if d[s] & 1 else 2)):
        raise ValueError("a1lx with reserved bits set or cut short")


class _Track:
    """A trak of the moov box as libavif's avifParseTrackBox reads it: its
    id and size (tkhd, a size libavif scales the frame to), the track it is
    auxiliary to and the one that premultiplies it (tref auxl, prem), its
    sample descriptions (stsd: format, and an av01 entry's properties after
    its 78-byte VisualSampleEntry) and sample table (stco or co64, stsc,
    stsz), each box's version and length checked as libavif checks them
    (ValueError where it fails the file)."""

    def __init__(self, d: bytes, s: int, e: int):
        self.id = self.aux_for = self.prem_by = 0
        self.meta = None
        self.descriptions, self.chunks, self.runs, self.sizes = [], [], [], []
        self.constant, self.table = 0, False
        duration = repeating = edts = None
        for kind, s2, e2 in _boxes(d, s, e):
            if kind == b"tkhd":
                if duration is not None:
                    raise ValueError("a second tkhd box")
                duration = self._tkhd(d, s2, e2)
            elif kind == b"meta":
                self.meta = _Heif(d, (s2, e2))
            elif kind == b"mdia":
                for k3, s3, e3 in _boxes(d, s2, e2):
                    if k3 == b"mdhd":
                        _box_need(s3 + 4, e3, "mdhd")
                        if d[s3] > 1:
                            raise ValueError(f"mdhd version {d[s3]}")
                        _box_need(s3 + (32 if d[s3] else 20), e3, "mdhd")
                    elif k3 == b"minf":
                        for k4, s4, e4 in _boxes(d, s3, e3):
                            if k4 == b"stbl":
                                if self.table:
                                    raise ValueError("a second stbl box")
                                self.table = True
                                self._stbl(d, s4, e4)
            elif kind == b"tref":
                for k3, s3, e3 in _boxes(d, s2, e2):
                    if k3 in (b"auxl", b"prem"):
                        _box_need(s3 + 4, e3, k3.decode())
                        if k3 == b"auxl":
                            self.aux_for = _uint(d, s3, 4)
                        else:
                            self.prem_by = _uint(d, s3, 4)
            elif kind == b"edts":
                if edts:
                    raise ValueError("a second edts box")
                edts = True
                repeating = self._elst(d, s2, e2)
        if duration is None:
            raise ValueError("trak without tkhd")
        if repeating and duration == 0:
            raise ValueError("track duration 0 under a repeated edit list")

    def _tkhd(self, d, s, e):
        """The track's duration (-1 indefinite); its id and size set."""
        _box_need(s + 4, e, "tkhd")
        version = d[s]
        if version > 1:
            raise ValueError(f"tkhd version {version}")
        w = 8 if version else 4
        at = s + 4 + 2 * w  # creation and modification times
        _box_need(at + 8 + w + 52 + 8, e, "tkhd")
        self.id = _uint(d, at, 4)
        duration = _uint(d, at + 8, w)
        at += 8 + w + 52  # reserved, layer, group, volume, matrix
        self.width = _uint(d, at, 4) >> 16
        self.height = _uint(d, at + 4, 4) >> 16
        _check_size(self.width, self.height, "track")
        return -1 if duration == (1 << 8 * w) - 1 else duration

    @staticmethod
    def _elst(d, s, e):
        """Whether the edts box's one elst repeats the track."""
        elst = [(s2, e2) for k, s2, e2 in _boxes(d, s, e) if k == b"elst"]
        if len(elst) != 1:
            raise ValueError(f"edts box of {len(elst)} elst boxes")
        s, e = elst[0]
        _box_need(s + 4, e, "elst")
        if not d[s + 3] & 1:
            return False
        _box_need(s + 8, e, "elst")
        if _uint(d, s + 4, 4) != 1:
            raise ValueError("elst of other than one entry")
        if d[s] > 1:
            raise ValueError(f"elst version {d[s]}")
        w = 8 if d[s] else 4
        _box_need(s + 8 + w, e, "elst")
        if not _uint(d, s + 8, w):
            raise ValueError("elst segment duration 0")
        return True

    def _stbl(self, d, s, e):
        for kind, s2, e2 in _boxes(d, s, e):
            name = kind.decode("latin-1")
            if kind not in (b"stco", b"co64", b"stsc", b"stsz", b"stss",
                            b"stts", b"stsd"):
                continue
            _box_need(s2 + 8, e2, name)
            if d[s2] > (kind == b"stsd"):
                raise ValueError(f"{name} version {d[s2]}")
            n = _uint(d, s2 + 4, 4)
            if kind in (b"stco", b"co64"):
                w = 8 if kind == b"co64" else 4
                _box_need(s2 + 8 + w * n, e2, name)
                self.chunks += np.frombuffer(d, f">u{w}", n, s2 + 8).tolist()
            elif kind == b"stsc":
                _box_need(s2 + 8 + 12 * n, e2, name)
                runs = np.frombuffer(d, ">u4", 3 * n, s2 + 8).reshape(n, 3)
                first = runs[:, 0].astype(np.int64)
                if n and (first[0] != 1 or (np.diff(first) <= 0).any()):
                    raise ValueError("stsc chunks not 1, 2, ... increasing")
                self.runs += runs[:, :2].tolist()
            elif kind == b"stsz":
                _box_need(s2 + 12, e2, name)
                count = _uint(d, s2 + 8, 4)
                if n:
                    self.constant = n
                else:
                    _box_need(s2 + 12 + 4 * count, e2, name)
                    self.sizes += np.frombuffer(d, ">u4", count,
                                                s2 + 12).tolist()
            elif kind == b"stss":
                _box_need(s2 + 8 + 4 * n, e2, name)
            elif kind == b"stts":
                _box_need(s2 + 8 + 8 * n, e2, name)
            else:
                pos = s2 + 8
                for _ in range(n):
                    if pos + 8 > e2:
                        raise ValueError("the stsd box cut short")
                    fmt, s3, e3 = next(_boxes(d, pos, e2))
                    props = None
                    if fmt == b"av01":
                        if e3 - s3 < 78:
                            raise ValueError("VisualSampleEntry cut short")
                        props = {}
                        for k4, s4, e4 in _boxes(d, s3 + 78, e3):
                            _check_property(d, k4, s4, e4)
                            props.setdefault(k4, []).append((s4, e4))
                    self.descriptions.append((fmt, props))
                    pos = e3

    def properties(self):
        """The first av01 sample entry's properties, or None."""
        return next((p for fmt, p in self.descriptions if fmt == b"av01"),
                    None)

    def samples(self, size: int):
        """(offset, size) of each sample as libavif's
        avifCodecDecodeInputFillFromSampleTable lists them from a file of
        ``size`` bytes (ValueError where it fails the file)."""
        runs = np.array(self.runs, np.int64).reshape(-1, 2)
        at = np.searchsorted(runs[:, 0], np.arange(1, len(self.chunks) + 1),
                             "right") - 1
        per = np.where(at >= 0, runs[np.maximum(at, 0), 1], 0)
        if (per == 0).any():
            raise ValueError("a chunk of no samples")
        total = int(per.sum())
        if total > _AVIF_FRAME_LIMIT:
            raise ValueError(f"{total} samples (libavif's limit "
                             f"{_AVIF_FRAME_LIMIT})")
        if self.constant:
            sizes = np.full(total, self.constant, np.int64)
        elif total > len(self.sizes):
            raise ValueError("sample table cut short (stsz)")
        else:
            sizes = np.array(self.sizes[:total], np.int64)
        ends = np.cumsum(sizes)
        first = np.concatenate([[0], np.cumsum(per)[:-1]])
        chunks = np.minimum(np.array(self.chunks, np.uint64), size + 1)
        starts = np.repeat(chunks.astype(np.int64) - (
            ends[first] - sizes[first]), per) + ends - sizes
        if (starts + sizes > size).any():
            raise ValueError("a sample past the end of the file")
        return list(zip(starts.tolist(), sizes.tolist()))


def _av1_planes(obus: bytes):
    """(planes (uint16 y, u, v), meta) of the AV1 still image in obus; meta
    as ``thc_av1_decode`` in native/av1.cc writes it (25 values: size,
    depth, subsampling and colour, then each plane's loop restoration,
    whether film grain was applied, the screen-content and intra block
    copy flags, and the counts of blocks with a Y palette, with a UV
    palette and of IntraBC blocks)."""
    lib = codec.library("av1")
    handle = ctypes.c_void_p()
    meta = np.zeros(25, np.int32)
    codec.call("thc_av1_decode", obus, len(obus), ctypes.byref(handle),
               meta.ctypes.data, what="AV1 item", refused=Refused, lib="av1")
    w, h, _, mono, sx, sy = (int(v) for v in meta[:6])
    y = np.empty((h, w), np.uint16)
    u = np.empty(((h + sy) >> sy, (w + sx) >> sx), np.uint16)
    v = np.empty_like(u)
    lib.thc_av1_planes(handle, y.ctypes.data, u.ctypes.data, v.ctypes.data)
    lib.thc_av1_release(handle)
    return (y,) if mono else (y, u, v), meta


def decode_avif(data: bytes, what: str = "AVIF") -> np.ndarray:
    try:
        return _decode_avif(data, what)
    except _Cut as e:
        raise Refused(f"AVIF file cut short (in {e})") from None
    except (ValueError, IndexError, struct.error) as e:
        # libavif fails the file, and cv2.imread returns nothing
        raise Refused(f"malformed AVIF ({e})") from None


# cv2.imread picks its AVIF decoder by libavif's parse of the file's first
# 500 bytes (AvifDecoder::checkSignature, the reader's size hint 1e9).
# Where that parse reads ftyp and the meta or moov box its brands need
# within them, libavif's decoder reset goes on to read, for the primary
# item, its grid's ImageGrid (and an alpha grid's), the Exif and XMP items
# describing it and, without nclx colour, its (or its first tile's) AV1
# data for the sequence header's; for a sequence's track, without nclx,
# its first sample: a read starting past the 500 bytes fails the parse,
# and cv2 reads nothing; one ending past them stops it, and cv2 reads the
# whole file. So does a box ftyp, meta or moov cut at the 500th byte; a
# box header across it, or a walk past it over another box, fails.
_SIGNATURE_BYTES = 500


def _signature_check(data: bytes, reads):
    """ValueError where cv2's signature check fails the file; reads: the
    (offset, size) extents the decoder reset reads."""
    try:
        for _ in _top_boxes(data, min(len(data), _SIGNATURE_BYTES)):
            pass
    except _Cut:
        return
    for start, n in reads:
        if start > _SIGNATURE_BYTES:
            raise ValueError(f"data at byte {start}, past the 500 bytes "
                             "cv2's signature check parses")
        if start + n > _SIGNATURE_BYTES:
            return


def _item_reads(heif: _Heif, alpha, nclx: bool) -> list:
    """The file extents libavif's decoder reset reads for the primary
    item (see _signature_check)."""
    primary = heif.primary
    reads = [i for i in (primary, alpha) if heif.types.get(i) == b"grid"]
    reads += _metadata(heif, primary)
    if not nclx:
        reads.append(_tiles(heif, primary)[0] if heif.types.get(primary)
                     == b"grid" else primary)
    return _extents(heif, reads)


def _metadata(heif: _Heif, primary=None) -> list:
    """The Exif and XMP items describing item ``primary`` (cdsc), or, for
    a track's meta box, all of them."""
    described = {src for ref, src, dst in heif.refs
                 if ref == b"cdsc" and dst == primary}
    return [i for i, kind in heif.types.items()
            if (primary is None or i in described) and (
                kind == b"Exif" or heif.content_types.get(i)
                == b"application/rdf+xml")]


def _extents(heif: _Heif, items) -> list:
    """The file extents of items (those in the file, not in idat)."""
    out = []
    for iid in items:
        method, extents = heif.locations.get(iid, (1, ()))
        out += extents if method == 0 else []
    return out


def _tiles(heif: _Heif, iid: int) -> list:
    """The dimg references of grid item iid, in order."""
    return [dst for ref, src, dst in heif.refs if ref == b"dimg"
            and src == iid]


def _check_size(width: int, height: int, what: str):
    if not width or not height or width > 32768 or height > 32768 or \
            width * height > 16384 * 16384:
        # libavif's image size and dimension limits
        raise ValueError(f"{what} of {width}x{height} pixels")


def _ispe(heif: _Heif, props: dict):
    s, _ = props[b"ispe"][0]
    width, height = struct.unpack_from(">II", heif.data, s + 4)
    _check_size(width, height, "ispe")
    return width, height


def _scaled(planes, meta, width: int, height: int):
    """planes scaled to width x height (chroma at its subsampled size) as
    libavif's avifImageScale scales a decoded image to its ispe
    (native/av1.cc's thc_avif_scale_plane)."""
    fw, fh, depth, _, sx, sy = (int(v) for v in meta[:6])
    if (fw, fh) == (width, height):
        return planes
    lib = codec.library("av1")
    out = []
    for p, plane in enumerate(planes):
        ssx, ssy = (sx, sy) if p else (0, 0)
        dst = np.empty(((height + ssy) >> ssy, (width + ssx) >> ssx),
                       np.uint16)
        lib.thc_avif_scale_plane(plane.ctypes.data, plane.shape[1],
                                 plane.shape[0], dst.ctypes.data,
                                 dst.shape[1], dst.shape[0], depth)
        out.append(dst)
    return tuple(out)


def _image(heif: _Heif, iid: int, alpha: bool = False):
    """(planes, meta) of item iid: an av01 item decoded and scaled to its
    ispe (an alpha item without one kept at its frame's size), or a grid of
    such tiles joined; meta as _av1_planes gives it, at the image's
    size."""
    props = heif.properties(iid)
    kind = heif.types.get(iid)
    if kind == b"grid":
        if b"ispe" not in props:
            raise ValueError("grid item without ispe")
        return _grid(heif, iid, _ispe(heif, props))
    if kind != b"av01":
        raise ValueError(f"item of type {kind!r} (not av01 or grid)")
    if b"av1C" not in props or (b"ispe" not in props and not alpha):
        raise ValueError("item without ispe or av1C")
    planes, meta = _av1_planes(_layers(heif.data, props, heif.item(iid)))
    if b"ispe" in props:
        width, height = _ispe(heif, props)
        planes = _scaled(planes, meta, width, height)
        meta[0], meta[1] = width, height
    return planes, meta


def _layers(d: bytes, props: dict, obus: bytes) -> bytes:
    """What of an av01 item's data libavif hands libaom (its
    avifCodecDecodeInputFillFromDecoderItem, progressive decoding off, as
    cv2 leaves it): where lsel selects layer L (not 0xFFFF, every layer)
    the item's first L + 1 layers by a1lx (the whole item without a1lx),
    libaom then outputting the frame of spatial layer L (ValueError where
    the stream has none: libavif fails the file); otherwise the whole
    item. a1lx's layer sizes must fit in the item either way; a1op's
    operating point is the stream's only one (libaom takes 0 for an index
    past the stream's count), and a stream of more than one is refused by
    native/av1.cc."""
    sizes = None
    if b"a1lx" in props:
        s, _ = props[b"a1lx"][0]
        w = 4 if d[s] & 1 else 2
        left, sizes = len(obus), []
        for i in range(3):
            n = _uint(d, s + 1 + w * i, w)
            if not n:
                break
            if n >= left:
                raise ValueError(f"a1lx layer {i} does not fit in the item")
            sizes.append(n)
            left -= n
        sizes.append(left)
    if b"lsel" not in props:
        return obus
    s, _ = props[b"lsel"][0]
    layer = _uint(d, s, 2)
    if layer == 0xFFFF:
        return obus
    if sizes is not None:
        if layer >= len(sizes):
            raise ValueError(f"lsel layer {layer} past a1lx's {len(sizes)}")
        obus = obus[:sum(sizes[:layer + 1])]
    if layer:
        pos = 0
        while pos < len(obus):  # the OBUs' extension headers
            head = obus[pos]
            ext = (head >> 2) & 1
            if ext and pos + 1 < len(obus) and (obus[pos + 1] >> 3) & 3 \
                    == layer:
                raise Refused(f"AVIF layered image (spatial layer {layer})")
            pos += 1 + ext
            if not head & 2:
                break
            size = shift = 0
            while pos < len(obus):
                size |= (obus[pos] & 0x7F) << shift
                pos, shift = pos + 1, shift + 7
                if not obus[pos - 1] & 0x80:
                    break
            pos += size
        raise ValueError(f"lsel layer {layer}, which the stream lacks")
    return obus


def _grid(heif: _Heif, iid: int, size):
    """(planes, meta) of grid item iid (its ispe ``size``): its ImageGrid
    read, its tiles decoded and their planes joined row-major and cropped
    to the grid's output size, as libavif's avifDecoderDataFillImageGrid
    joins them before one conversion; ValueError wherever libavif fails
    the grid."""
    body = heif.item(iid)
    if len(body) < 4 or body[0] != 0:
        raise ValueError("ImageGrid of another version")
    flags, rows, cols = body[1], body[2] + 1, body[3] + 1
    n = 4 if flags & 1 else 2
    if len(body) != 4 + 2 * n:
        raise ValueError("ImageGrid of another length")
    gw, gh = _uint(body, 4, n), _uint(body, 4 + n, n)
    if not gw or not gh:
        raise ValueError(f"ImageGrid of {gw}x{gh} pixels")
    if (gw, gh) != size:
        # imread's 8-bit matrix is the ispe's size
        raise ValueError(f"ImageGrid of {gw}x{gh} for an ispe of "
                         f"{size[0]}x{size[1]}")
    tiles = _tiles(heif, iid)
    if len(tiles) != rows * cols:
        raise ValueError(f"grid of {rows}x{cols} tiles with {len(tiles)} "
                         "dimg references")
    configs = set()
    for t in tiles:
        props = heif.properties(t)
        if heif.types.get(t) != b"av01" or b"av1C" not in props:
            raise ValueError("grid tile not an av01 item with av1C")
        s, _ = props[b"av1C"][0]
        configs.add(heif.data[s:s + 4])
    if len(configs) > 1:
        raise ValueError("grid tiles of different av1C fields")
    decoded = [_image(heif, t) for t in tiles]
    planes, meta = decoded[0]
    tw, th, _, mono, sx, sy = (int(v) for v in meta[:6])
    for _, m in decoded[1:]:
        if (list(m[:6]) != list(meta[:6])
                or list(m[6:10]) != list(meta[6:10])):
            raise ValueError("grid tiles of different sizes, depths, "
                             "subsampling or colour")
    if tw < 64 or th < 64 or (sx and (gw % 2 or tw % 2)) or \
            (sy and (gh % 2 or th % 2)):
        raise ValueError(f"grid of {tw}x{th} tiles for {gw}x{gh} pixels")
    if tw * cols < gw or th * rows < gh or tw * (cols - 1) >= gw or \
            th * (rows - 1) >= gh:
        raise ValueError(f"{rows}x{cols} tiles of {tw}x{th} do not cover "
                         f"{gw}x{gh} pixels")
    joined = []
    for p in range(len(planes)):
        ssx, ssy = (sx, sy) if p else (0, 0)
        whole = np.block([[decoded[r * cols + c][0][p] for c in range(cols)]
                          for r in range(rows)])
        joined.append(np.ascontiguousarray(
            whole[:(gh + ssy) >> ssy, :(gw + ssx) >> ssx]))
    meta = meta.copy()
    meta[0], meta[1] = gw, gh
    return tuple(joined), meta


def _item_image(heif: _Heif):
    """(planes, meta, nclx offset or None, Exif data or None) of the
    primary item, its alpha item (auxl, auxC alpha) decoded as libavif
    decodes it (a failing one fails the file) and dropped, as imread's
    3-channel result drops it."""
    data = heif.data
    props = heif.properties(heif.primary)
    nclx = [s for s, _ in props.get(b"colr", ()) if data[s:s + 4] == b"nclx"]
    alpha = None
    for ref, src, dst in heif.refs:
        if ref == b"auxl" and dst == heif.primary and any(
                data[s + 4:e].rstrip(b"\0") in _ALPHA_URNS
                for s, e in heif.properties(src).get(b"auxC", ())):
            alpha = src
            break
    if alpha is not None and (b"prem", heif.primary, alpha) in heif.refs:
        raise Refused("AVIF premultiplied alpha (prem)")
    _signature_check(data, _item_reads(heif, alpha, bool(nclx)))
    planes, meta = _image(heif, heif.primary)
    if alpha is not None:
        _, ameta = _image(heif, alpha, alpha=True)
        _same_as_alpha(meta, ameta)
    return planes, meta, nclx[0] if nclx else None, _exif(
        heif, heif.primary)


def _exif(heif: _Heif, primary=None):
    """The data after its 4-byte header offset of the first Exif item of
    _metadata(heif, primary), or None."""
    return next((heif.item(i)[4:] for i in _metadata(heif, primary)
                 if heif.types[i] == b"Exif"), None)


def _same_as_alpha(meta, ameta):
    if (int(ameta[0]), int(ameta[1]), int(ameta[2])) != (
            int(meta[0]), int(meta[1]), int(meta[2])):
        raise ValueError("alpha image of another size or depth")


def _track_image(heif: _Heif):
    """(planes, meta, nclx offset or None, Exif data or None) of an image
    sequence's first frame as libavif reads it from tracks: the colour
    track is the first with an id, a sample table of chunks, an av01
    sample entry and no auxl reference, its first av01 entry's properties
    its colour's (av1C required, nclx over the sequence header's), its
    first sample decoded and scaled to its tkhd size, its own meta box's
    Exif item applied (the file's meta box is not read); the alpha track
    (the first such track auxl to it) decoded likewise and dropped (a
    failing one fails the file)."""
    data = heif.data

    def usable(t):
        return t.table and t.id and t.chunks and t.properties() is not None
    color = next((t for t in heif.tracks if usable(t) and not t.aux_for),
                 None)
    if color is None:
        raise ValueError("no AV1 colour track")
    alpha = next((t for t in heif.tracks if usable(t)
                  and t.aux_for == color.id), None)
    props = color.properties()
    if b"av1C" not in props:
        raise ValueError("colour track without av1C")
    nclx = [s for s, _ in props.get(b"colr", ()) if data[s:s + 4] == b"nclx"]
    if len(nclx) > 1:
        raise ValueError("two nclx colour properties")
    first = color.samples(len(data))[0]
    if alpha is not None:
        alpha_first = alpha.samples(len(data))[0]
        if color.prem_by == alpha.id:
            raise Refused("AVIF premultiplied alpha (prem)")
    meta_reads = _extents(color.meta, _metadata(color.meta)) \
        if color.meta else []
    _signature_check(data, meta_reads + ([] if nclx else [first]))

    def frame(track, at):
        start, n = at
        planes, meta = _av1_planes(data[start:start + n])
        planes = _scaled(planes, meta, track.width, track.height)
        meta[0], meta[1] = track.width, track.height
        return planes, meta
    planes, meta = frame(color, first)
    if alpha is not None:
        _same_as_alpha(meta, frame(alpha, alpha_first)[1])
    return planes, meta, nclx[0] if nclx else None, \
        _exif(color.meta) if color.meta else None


def _decode_avif(data: bytes, what: str) -> np.ndarray:
    heif = _Heif(data)
    planes, meta, nclx, exif = (_track_image if heif.from_tracks
                                else _item_image)(heif)
    cp, mc, full = int(meta[6]), int(meta[8]), int(meta[9])
    if nclx is not None:
        cp, _, mc = struct.unpack_from(">HHH", data, nclx + 4)
        full = data[nclx + 10] >> 7
    w, h, depth, mono, sx, sy = (int(v) for v in meta[:6])
    out = np.empty((h, w, 3), np.uint8)
    params = np.array([w, h, depth, mono, sx, sy, cp, mc, full], np.int32)
    u, v = (planes[1], planes[2]) if len(planes) == 3 else (planes[0],) * 2
    codec.call("thc_avif_to_rgb", planes[0].ctypes.data, u.ctypes.data,
               v.ctypes.data, params.ctypes.data, out.ctypes.data,
               what=what, refused=Refused, lib="av1")
    # irot, imir and clap are not applied
    if exif is not None and exif[:4] in (b"II*\0", b"MM\0*"):
        out = exif_orient(out, exif)
    return out
