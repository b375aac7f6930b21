"""Image files in the container formats ``cv2.imread`` reads beside JPEG
and PNG, for tests/test_torch_formats.py and chip_smoke.py's fixtures:
BMP (every depth, palettes, bit fields, RLE4 and RLE8 with delta and
end-of-line codes, top-down rows, the v3, v4 and v5 headers), PxM (ASCII
P1-P3, binary P4-P6, PAM, PFM), Sun raster (standard, RLE and RGB types,
colour maps), TIFF (strips and tiles, both planar configurations, both
byte orders, no compression, PackBits, LZW and Deflate, the horizontal
predictor, grey, RGB and palette data, extra alpha samples), GIF (87a and
89a, global and local tables, interlace, transparency, frames on a larger
screen, animation), Radiance HDR (run-length and flat scanlines), WebP
(the RIFF, VP8X, ANIM and ANMF chunks; a lossless writer with the
subtract-green and predictor transforms; lossy key frames of a chosen
header and random modes and tokens) and JPEG 2000 (JP2 boxes; codestreams
of chosen or drawn headers around random code-block payloads).

Each writer follows its format's specification; what the port must equal
is ``cv2.imread`` of the file, never the writer's input."""

import struct
import zlib

import numpy as np


# ------------------------------------------------------------------- BMP
def _rows_bits(idx: np.ndarray, bpp: int) -> np.ndarray:
    """(h, w) samples below 8 bits packed MSB-first into whole bytes."""
    h, w = idx.shape
    per = 8 // bpp
    pad = (-w) % per
    v = np.pad(idx.astype(np.uint8), ((0, 0), (0, pad)))
    v = v.reshape(h, -1, per)
    shifts = np.arange(8 - bpp, -1, -bpp, dtype=np.uint8)
    return (v << shifts).sum(-1).astype(np.uint8)


def _rle8(idx: np.ndarray, delta_at=None, eol_after_full=True) -> bytes:
    """RLE8 rows (bottom-up order is the caller's), runs of equal values as
    encoded pairs, other stretches of 3 or more in absolute mode, an
    end-of-line after each row and an end-of-bitmap; ``delta_at`` (row,
    col, dx, dy) replaces the pixels from there with a delta code."""
    out = bytearray()
    h, w = idx.shape
    y = 0
    while y < h:
        row = [int(v) for v in idx[y]]
        x = 0
        stop = w
        if delta_at is not None and delta_at[0] == y:
            stop = delta_at[1]
        while x < stop:
            run = 1
            while x + run < stop and row[x + run] == row[x] and run < 255:
                run += 1
            if run >= 2 or stop - x < 3:
                out += bytes([run, row[x]])
                x += run
                continue
            lit = 1
            while (x + lit < stop and lit < 255
                   and not (x + lit + 1 < stop
                            and row[x + lit] == row[x + lit + 1])):
                lit += 1
            if lit < 3:
                out += bytes([1, row[x]])
                x += 1
                continue
            out += bytes([0, lit, *row[x:x + lit]])
            if lit % 2:
                out += b"\0"
            x += lit
        if delta_at is not None and delta_at[0] == y:
            _, col, dx, dy = delta_at
            out += bytes([0, 2, dx, dy])
            # resume at (col + dx, y + dy): write the rest of that row
            y += dy
            x = col + dx
            row = [int(v) for v in idx[y]]
            while x < w:
                out += bytes([1, row[x]])
                x += 1
        if x < w or eol_after_full:
            out += b"\0\0"
        y += 1
    return bytes(out + b"\0\1")


def _rle4(idx: np.ndarray) -> bytes:
    """RLE4 rows: pairs of alternating nibbles as encoded runs, stretches
    of 3 or more in absolute mode (nibble-packed, word-aligned), an
    end-of-line after each row and an end-of-bitmap."""
    out = bytearray()
    for row in idx:
        row = [int(v) for v in row]
        x, w = 0, len(row)
        while x < w:
            # a run alternating a, b
            run = 1
            while (x + run < w and run < 255
                   and row[x + run] == row[x + (run % 2)]):
                run += 1
            if run >= 3 or w - x < 3:
                b = row[x + 1] if run > 1 else 0
                out += bytes([run, (row[x] << 4) | b])
                x += run
                continue
            lit = min(w - x, 10)
            nib = row[x:x + lit] + [0] * (lit % 2)
            body = bytes((nib[i] << 4) | nib[i + 1]
                         for i in range(0, len(nib), 2))
            out += bytes([0, lit]) + body + b"\0" * (len(body) % 2)
            x += lit
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp(img: np.ndarray, bpp: int, palette=None, compression=0,
        masks=None, header=40, top_down=False, clrused=None,
        delta_at=None) -> bytes:
    """A BMP of ``img``: (h, w, 3) RGB for 24 and 32 bits, (h, w) uint16
    packed pixels for 16 bits, (h, w) palette indices below 16 bits;
    ``palette`` (n, 3) RGB; compression 0 (BI_RGB), 1 (RLE8), 2 (RLE4) or
    3 (BI_BITFIELDS with ``masks`` (r, g, b[, a])); ``header`` 40 (v3:
    bit-field masks after it), 108 (v4) or 124 (v5)."""
    h, w = img.shape[:2]
    if bpp == 24:
        rows = img[..., ::-1].reshape(h, w * 3)
    elif bpp == 32:
        rows = np.concatenate([img[..., ::-1], np.full((h, w, 1), 255,
                                                       np.uint8)], -1)
        rows = rows.reshape(h, w * 4)
    elif bpp == 16:
        rows = img.astype("<u2").view(np.uint8).reshape(h, w * 2)
    elif bpp == 8:
        rows = img.astype(np.uint8)
    else:
        rows = _rows_bits(img, bpp)
    order = slice(None) if top_down else slice(None, None, -1)
    if compression == 1:
        data = _rle8(img[order], delta_at)
    elif compression == 2:
        data = _rle4(img[order])
    else:
        stride = -(-rows.shape[1] // 4) * 4
        data = np.pad(rows, ((0, 0), (0, stride - rows.shape[1])))[order]
        data = data.tobytes()
    pal = b""
    if palette is not None:
        pal = np.concatenate([np.asarray(palette, np.uint8)[:, ::-1],
                              np.zeros((len(palette), 1), np.uint8)], 1)
        pal = pal.tobytes()
    n_pal = len(pal) // 4
    info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1,
                       bpp, compression, len(data), 2835, 2835,
                       n_pal if clrused is None else clrused, 0)
    extra = b""
    if header >= 108:
        m = list(masks or (0, 0, 0, 0)) + [0] * (4 - len(masks or ()))
        info += struct.pack("<IIII", *m[:4]) + b"BGRs" + b"\0" * 36 \
            + b"\0" * 12
        if header == 124:
            info += struct.pack("<IIII", 4, 0, 0, 0)
    elif compression == 3:
        extra = struct.pack(f"<{len(masks)}I", *masks)
    off = 14 + len(info) + len(extra) + len(pal)
    head = b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off)
    return head + info + extra + pal + data


# ------------------------------------------------------------------- PxM
def pnm_ascii(img: np.ndarray, magic: str, maxval: int = 255,
              comment: bool = True) -> bytes:
    """P1 (img (h, w) of 0/1), P2 (h, w) or P3 (h, w, 3), whitespace-
    separated samples, a comment in the header."""
    h, w = img.shape[:2]
    head = f"{magic}\n" + ("# written by a test\n" if comment else "")
    head += f"{w} {h}\n"
    if magic != "P1":
        head += f"{maxval}\n"
    vals = img.reshape(h, -1)
    body = "\n".join(" ".join(str(int(v)) for v in row) for row in vals)
    return (head + body + "\n").encode()


def pnm_binary(img: np.ndarray, magic: str, maxval: int = 255) -> bytes:
    """P4 (0/1, bits packed MSB-first, rows byte-aligned), P5 or P6, 16-bit
    samples big-endian above maxval 255."""
    h, w = img.shape[:2]
    head = f"{magic}\n{w} {h}\n" + ("" if magic == "P4" else f"{maxval}\n")
    if magic == "P4":
        body = _rows_bits(img, 1).tobytes()
    elif maxval > 255:
        body = img.astype(">u2").tobytes()
    else:
        body = img.astype(np.uint8).tobytes()
    return head.encode() + body


def pam(img: np.ndarray, maxval: int = 255, tupltype="RGB") -> bytes:
    h, w = img.shape[:2]
    depth = 1 if img.ndim == 2 else img.shape[2]
    head = (f"P7\nWIDTH {w}\nHEIGHT {h}\nDEPTH {depth}\nMAXVAL {maxval}\n"
            f"TUPLTYPE {tupltype}\nENDHDR\n")
    body = img.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    return head.encode() + body


def pfm(img: np.ndarray, little: bool = True, scale: float = 1.0) -> bytes:
    """PF (h, w, 3) or Pf (h, w) floats, rows bottom-up; the scale's sign
    gives the byte order."""
    h, w = img.shape[:2]
    magic = "PF" if img.ndim == 3 else "Pf"
    head = f"{magic}\n{w} {h}\n{-scale if little else scale}\n".encode()
    return head + img[::-1].astype("<f4" if little else ">f4").tobytes()


# ------------------------------------------------------------ Sun raster
def _sun_rle(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and data[i + run] == data[i] and run < 256:
            run += 1
        v = data[i]
        if run >= 3 or (v == 0x80 and run >= 2):
            out += bytes([0x80, run - 1, v])
        elif v == 0x80:
            out += b"\x80\x00"
        else:
            out += bytes([v] * run)
        i += run
    return bytes(out)


def sun_raster(img: np.ndarray, depth: int, rtype: int = 1, cmap=None,
               pad_rle: bool = True) -> bytes:
    """A Sun raster: (h, w, 3) RGB at 24 and 32 bits (stored BGR, or RGB
    for type 3; 32 bits with a pad byte first), (h, w) indices or 0/1 at 8
    and 1 bits; rows padded to 16 bits; type 1 standard, 2 RLE (of the
    padded rows, or of the unpadded ones with pad_rle False), 3 RGB;
    ``cmap`` (n, 3) RGB as an equal-RGB colour map."""
    h, w = img.shape[:2]
    if depth in (24, 32):
        px = img if rtype == 3 else img[..., ::-1]
        if depth == 32:
            px = np.concatenate([np.zeros((h, w, 1), np.uint8), px], -1)
        rows = px.reshape(h, -1)
    elif depth == 8:
        rows = img.astype(np.uint8)
    else:
        rows = _rows_bits(img, 1)
    padded = np.pad(rows, ((0, 0), (0, rows.shape[1] % 2)))
    raw = padded.tobytes()
    if rtype == 2:
        raw = _sun_rle(raw if pad_rle else rows.tobytes())
    maplen = 0
    cm = b""
    if cmap is not None:
        cm = np.asarray(cmap, np.uint8).T.tobytes()
        maplen = len(cm)
    head = struct.pack(">8I", 0x59A66A95, w, h, depth, len(raw), rtype,
                       1 if cmap is not None else 0, maplen)
    return head + cm + raw


# ------------------------------------------------------------------ TIFF
def _packbits(data: bytes) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        run = 1
        while i + run < n and data[i + run] == data[i] and run < 128:
            run += 1
        if run >= 2:
            out += bytes([(257 - run) & 0xFF, data[i]])
            i += run
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n
                                             and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _lzw(data: bytes) -> bytes:
    """TIFF LZW as libtiff writes it: MSB-first codes, a clear code first,
    the width growing once the next free code needs it, a clear when it
    reaches 4094, end of information last."""
    out_bits, nbits = 0, 0
    out = bytearray()

    def put(code, width):
        nonlocal out_bits, nbits
        out_bits = (out_bits << width) | code
        nbits += width
        while nbits >= 8:
            nbits -= 8
            out.append((out_bits >> nbits) & 0xFF)
        out_bits &= (1 << nbits) - 1

    table = {bytes([i]): i for i in range(256)}
    nxt, width = 258, 9
    put(256, width)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if wc in table:
            w = wc
            continue
        put(table[w], width)
        table[wc] = nxt
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
        if nxt >= 4094:
            put(256, width)
            table = {bytes([i]): i for i in range(256)}
            nxt, width = 258, 9
        w = bytes([c])
    if w:
        put(table[w], width)
        nxt += 1
        if nxt >= (1 << width) and width < 12:
            width += 1
    put(257, width)
    if nbits:
        out.append((out_bits << (8 - nbits)) & 0xFF)
    return bytes(out)


_COMPRESS = {1: lambda b: b, 5: _lzw, 8: zlib.compress, 32946: zlib.compress,
             32773: _packbits}


def _predict(block: np.ndarray, spp: int) -> np.ndarray:
    """Horizontal differencing of (rows, cols, spp) samples."""
    d = block.copy()
    d[:, 1:] = block[:, 1:] - block[:, :-1]
    return d


def tiff(img: np.ndarray, bps: int = 8, photometric: int = 2,
         compression: int = 1, predictor: int = 1, planar: int = 1,
         big_endian: bool = False, rows_per_strip=None, tile=None,
         colormap=None, extra=None, sample_format=None,
         orientation=None, bigtiff: bool = False, tags=None,
         code=None) -> bytes:
    """A TIFF of ``img`` (h, w) or (h, w, spp) samples (uint8, or uint16 at
    16 bits; 0/1 or indices below 8 bits, rows packed MSB-first): one IFD,
    strips (``rows_per_strip``) or tiles (``tile`` (th, tw), multiples of
    16), planar 1 or 2, ``colormap`` (3, 2**bps) uint16, ``extra`` the
    ExtraSamples values, ``orientation`` the Orientation tag, BigTIFF
    (version 43: 8-byte offsets and counts, 20-byte entries) with
    ``bigtiff``; ``tags`` more entries, tag -> (type, values) (RATIONAL
    values as (numerator, denominator) pairs, ASCII and UNDEFINED as
    bytes); ``code`` a function of a strip or tile's (rows, cols, s)
    samples to its stored bytes in place of the compression's coder (a
    JPEG or CCITT stream, packed YCbCr units), the compression tag still
    ``compression``."""
    e = ">" if big_endian else "<"
    a = img if img.ndim == 3 else img[..., None]
    h, w, spp = a.shape
    dt = np.dtype(e + "u2") if bps == 16 else np.dtype(np.uint8)

    def encode(block):
        """(rows, cols, s) samples -> the chunk's bytes."""
        if code is not None:
            return code(block)
        if predictor == 2:
            block = _predict(block.astype(np.uint16 if bps == 16
                                          else np.uint8), block.shape[2])
        if bps < 8:
            raw = _rows_bits(block[..., 0], bps).tobytes()
        else:
            raw = block.astype(dt).tobytes()
        return _COMPRESS[compression](raw)

    planes = [a] if planar == 1 else [a[..., s:s + 1] for s in range(spp)]
    chunks = []
    if tile is None:
        rps = rows_per_strip or h
        for p in planes:
            for y in range(0, h, rps):
                chunks.append(encode(p[y:y + rps]))
    else:
        th, tw = tile
        for p in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    blk = np.zeros((th, tw, p.shape[2]), p.dtype)
                    part = p[y:y + th, x:x + tw]
                    blk[:part.shape[0], :part.shape[1]] = part
                    chunks.append(encode(blk))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
               259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).ravel()])
    if extra is not None:
        entries[338] = (3, list(extra))
    if sample_format is not None:
        entries[339] = (3, [sample_format] * spp)
    if orientation is not None:
        entries[274] = (3, [orientation])
    if tile is None:
        entries[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    else:
        entries[322] = (4, [tile[1]])
        entries[323] = (4, [tile[0]])
        off_tag, cnt_tag = 324, 325
    entries.update(tags or {})
    return tiff_file(chunks, entries, off_tag, cnt_tag, big_endian, bigtiff)


def jpeg_tables_split(jpeg: bytes):
    """(tables, abbreviated) of a JPEG stream, as a TIFF JPEG writer lays
    them out: a tables-only stream of its DQT and DHT segments (the
    JPEGTables tag), and the stream without them and without its APP0."""
    pos, head = 2, []
    while jpeg[pos + 1] != 0xDA:
        n = int.from_bytes(jpeg[pos + 2:pos + 4], "big")
        head.append((jpeg[pos + 1], jpeg[pos:pos + 2 + n]))
        pos += 2 + n
    tables = b"\xff\xd8" + b"".join(seg for m, seg in head
                                    if m in (0xDB, 0xC4)) + b"\xff\xd9"
    rest = b"".join(seg for m, seg in head if m not in (0xDB, 0xC4, 0xE0))
    return tables, b"\xff\xd8" + rest + jpeg[pos:]


def ycbcr_units(block: np.ndarray, hs: int, vs: int) -> bytes:
    """(rows, cols, 3) Y, Cb, Cr samples as TIFF's contiguous YCbCr data
    units of subsampling hs x vs: hs * vs luma samples, then the block's
    top-left Cb and Cr; a partial block at the edge repeats the edge."""
    r, c, _ = block.shape
    rr, cc = -(-r // vs) * vs, -(-c // hs) * hs
    b = np.pad(block, ((0, rr - r), (0, cc - c), (0, 0)), mode="edge")
    y = b[..., 0].reshape(rr // vs, vs, cc // hs, hs).transpose(
        0, 2, 1, 3).reshape(rr // vs, cc // hs, vs * hs)
    chroma = b[::vs, ::hs, 1:]
    return np.concatenate([y, chroma], -1).astype(np.uint8).tobytes()


_TAG_FORMATS = {1: "B", 2: "s", 3: "H", 4: "I", 5: "I", 7: "s", 8: "h",
                9: "i", 10: "i", 11: "f", 12: "d", 16: "Q"}


def tiff_file(chunks, entries, off_tag, cnt_tag, big_endian=False,
              bigtiff=False) -> bytes:
    """A one-IFD TIFF (BigTIFF with ``bigtiff``) of the strips or tiles
    ``chunks`` (their offsets and byte counts under off_tag and cnt_tag,
    LONG, or LONG8 in a BigTIFF) and ``entries``, tag -> (type, values):
    layout header, chunk data, out-of-line values, the IFD."""
    e = ">" if big_endian else "<"
    inline = 8 if bigtiff else 4
    head_size = 16 if bigtiff else 8
    body = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(head_size + len(body))
        body += c
        if len(body) % 2:
            body += b"\0"
    long_type = 16 if bigtiff else 4
    entries = dict(entries)
    entries[off_tag] = (long_type, offsets)
    entries[cnt_tag] = (long_type, [len(c) for c in chunks])
    packed = []
    for tag in sorted(entries):
        typ, vals = entries[tag]
        if typ in (2, 7):
            payload, count = bytes(vals), len(vals)
        elif typ in (5, 10):
            flat = [int(v) for pair in vals for v in pair]
            payload = struct.pack(e + _TAG_FORMATS[typ] * len(flat), *flat)
            count = len(vals)
        else:
            payload = struct.pack(e + _TAG_FORMATS[typ] * len(vals), *vals)
            count = len(vals)
        if len(payload) <= inline:
            packed.append((tag, typ, count, payload.ljust(inline, b"\0")))
        else:
            off = head_size + len(body)
            body += payload
            if len(body) % 2:
                body += b"\0"
            packed.append((tag, typ, count, struct.pack(
                e + ("Q" if bigtiff else "I"), off)))
    ifd_off = head_size + len(body)
    order = b"MM" if big_endian else b"II"
    if bigtiff:
        ifd = struct.pack(e + "Q", len(packed))
        for tag, typ, n, val in packed:
            ifd += struct.pack(e + "HHQ", tag, typ, n) + val
        ifd += struct.pack(e + "Q", 0)
        head = order + struct.pack(e + "HHHQ", 43, 8, 0, ifd_off)
    else:
        ifd = struct.pack(e + "H", len(packed))
        for tag, typ, n, val in packed:
            ifd += struct.pack(e + "HHI", tag, typ, n) + val
        ifd += struct.pack(e + "I", 0)
        head = order + struct.pack(e + "HI", 42, ifd_off)
    return head + bytes(body) + ifd


# ------------------------------------------------- frames of a ZJU layout
def _quantize(img: np.ndarray):
    """(indices, palette) of img on the 6x6x6 colour cube."""
    q = (img.astype(np.int32) * 6 // 256)
    idx = (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)
    levels = np.arange(6) * 51
    pal = np.stack(np.meshgrid(levels, levels, levels, indexing="ij"),
                   -1).reshape(-1, 3)
    return idx, pal


# a frame's extension and its cameras' codings (the views of a frame share
# the target's file name; cv2.imread decodes by content); "webp_lossy",
# "jp2_lossless", "jp2_lossy", "tiff_jpeg_420" and the "avif_" ones are the
# caller's to make (no writer here codes VP8, JPEG 2000's tier 1, JPEG or
# AV1); the last camera's are AVIF image sequences (cv2.imread reads their
# first frame)
FRAME_FORMATS = (
    (".bmp", ("bmp24", "bmp_rle8", "bmp565", "jp2_lossy", "gif",
              "avif_cv2", "avif_cv2_sequence")),
    (".tif", ("tiff_jpeg_420", "tiff_cmyk_deflate_tiles", "jp2_lossless",
              "webp_lossless", "bigtiff16", "avif_cv2_10bit",
              "avif_cv2_sequence_10bit")),
    (".ppm", ("p6", "hdr", "sun24", "webp_lossy", "sun8",
              "avif_pil_444_screen", "avif_pil_sequence_rgba")),
)


def cmyk_of(img: np.ndarray) -> np.ndarray:
    """(h, w, 4) CMYK samples that libtiff reads back as img: C, M, Y the
    complement of R, G, B and K 0."""
    return np.concatenate([255 - img, np.zeros(img.shape[:2] + (1,),
                                               np.uint8)], -1)


def cielab_of(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) 8-bit CIELab samples (L, then signed a and b) that
    libtiff's display conversion (sRGB primaries, a pure 2.4 gamma over
    luminances 1 to 100, the D50 white point) reads back as img within a
    few levels: that conversion inverted, then quantised."""
    v = img.astype(np.float64) / 255
    lum = 1 + 99 * v ** 2.4
    m = np.array([[3.2410, -1.5374, -0.4986], [-0.9692, 1.8760, 0.0416],
                  [0.0556, -0.2040, 1.0570]])
    xyz = lum @ np.linalg.inv(m).T
    d50 = np.array([96.4250, 100.0, 82.4680])
    white = d50 / d50[1] * 100
    t = xyz / white
    f = np.where(t > 0.008856, np.cbrt(np.maximum(t, 0)),
                 7.787 * t + 16 / 116)
    lab = np.stack([116 * f[..., 1] - 16, 500 * (f[..., 0] - f[..., 1]),
                    200 * (f[..., 1] - f[..., 2])], -1)
    out = np.empty(img.shape, np.uint8)
    out[..., 0] = np.clip(np.rint(lab[..., 0] * 255 / 100), 0, 255)
    out[..., 1:] = np.clip(np.rint(lab[..., 1:]), -128, 127).astype(
        np.int8).view(np.uint8)
    return out


def encode_frame(img: np.ndarray, kind: str) -> bytes:
    """(h, w, 3) RGB uint8 in the coding ``kind`` of FRAME_FORMATS."""
    h, w = img.shape[:2]
    if kind == "bmp24":
        return bmp(img, 24)
    if kind == "bmp32":
        return bmp(img, 32, header=124)
    if kind == "bmp565":
        v = img.astype(np.uint16)
        px = (v[..., 0] >> 3 << 11) | (v[..., 1] >> 2 << 5) | (v[..., 2] >> 3)
        return bmp(px, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    if kind == "bmp_rle8":
        idx, pal = _quantize(img)
        return bmp(idx, 8, palette=pal, compression=1)
    if kind == "tiff_packbits_planar":
        return tiff(img, compression=32773, planar=2, big_endian=True,
                    rows_per_strip=16)
    if kind == "bigtiff16":
        return tiff(img.astype(np.uint16) * 257 + 77, 16, compression=5,
                    predictor=2, bigtiff=True)
    if kind == "tiff_cmyk_deflate_tiles":
        return tiff(cmyk_of(img), photometric=5, compression=8,
                    predictor=2, tile=(32, 32))
    if kind == "tiff_cmyk":
        return tiff(cmyk_of(img), photometric=5, compression=8,
                    predictor=2, rows_per_strip=8)
    if kind == "tiff_cielab":
        return tiff(cielab_of(img), photometric=8, compression=8,
                    predictor=2, rows_per_strip=8)
    if kind == "bigtiff_deflate":
        return tiff(img, compression=8, predictor=2, rows_per_strip=8,
                    bigtiff=True)
    if kind == "p6":
        return pnm_binary(img, "P6")
    if kind == "p3":
        return pnm_ascii(img, "P3")
    if kind == "sun24":
        return sun_raster(img, 24)
    if kind == "sun8":
        idx, pal = _quantize(img)
        return sun_raster(idx, 8, cmap=pal)
    if kind == "gif":
        idx, pal = _quantize(img)
        return gif([{"idx": idx, "interlace": True}], palette=pal)
    if kind == "hdr":
        return hdr(img / 255.0)
    if kind == "webp_lossless":
        return vp8l(img)
    raise ValueError(kind)


# ------------------------------------------------------------------- GIF
def _gif_lzw(idx: bytes, min_size: int) -> bytes:
    """LSB-first GIF LZW of idx: the code width grows as the table reaches
    each power of two, a clear code when the table is full."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    out, acc, nacc = bytearray(), 0, 0
    width = min_size + 1

    def put(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += width
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    table = {bytes([i]): i for i in range(clear)}
    nxt = end + 1
    put(clear)
    cur = b""
    for b in idx:
        s = cur + bytes([b])
        if s in table:
            cur = s
            continue
        put(table[cur])
        if nxt < 4096:
            table[s] = nxt
            nxt += 1
            if nxt > (1 << width) and width < 12:
                width += 1
        else:
            put(clear)
            table = {bytes([i]): i for i in range(clear)}
            nxt = end + 1
            width = min_size + 1
        cur = bytes([b])
    if cur:
        put(table[cur])
    put(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def _gif_table(pal: np.ndarray) -> tuple:
    """(size field, the table's bytes padded to a power of two)."""
    n = max(2, 1 << int(np.ceil(np.log2(max(len(pal), 2)))))
    t = np.zeros((n, 3), np.uint8)
    t[:len(pal)] = pal
    return int(np.log2(n)) - 1, t.tobytes()


def gif(frames, screen=None, palette=None, version=b"89a", bg=0,
        min_code_size=None, loop=False) -> bytes:
    """A GIF of frames, each a dict: ``idx`` (h, w) palette indices and
    optionally ``pos`` (left, top), ``palette`` (a local table),
    ``interlace``, ``transparent`` (an index, through a Graphic Control
    Extension) and ``disposal``; ``screen`` (width, height) defaults to the
    first frame's size, ``palette`` is the global table."""
    h0, w0 = frames[0]["idx"].shape
    sw, sh = screen or (w0, h0)
    out = bytearray(b"GIF" + version + struct.pack("<HH", sw, sh))
    if palette is not None:
        size, table = _gif_table(np.asarray(palette, np.uint8))
        out += bytes([0x80 | 0x70 | size, bg, 0]) + table
    else:
        out += bytes([0x70, bg, 0])
    if loop:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\0\0\0"
    for f in frames:
        idx = np.asarray(f["idx"], np.uint8)
        h, w = idx.shape
        if "transparent" in f or "disposal" in f:
            t = f.get("transparent")
            packed = (f.get("disposal", 0) << 2) | (t is not None)
            out += bytes([0x21, 0xF9, 4, packed, 0, 0, t or 0, 0])
        left, top = f.get("pos", (0, 0))
        packed, table = 0, b""
        if f.get("palette") is not None:
            size, table = _gif_table(np.asarray(f["palette"], np.uint8))
            packed = 0x80 | size
        rows = idx
        if f.get("interlace"):
            packed |= 0x40
            order = [*range(0, h, 8), *range(4, h, 8), *range(2, h, 4),
                     *range(1, h, 2)]
            rows = idx[order]
        out += b"\x2c" + struct.pack("<HHHHB", left, top, w, h, packed)
        out += table
        mcs = min_code_size or max(2, int(idx.max()).bit_length())
        data = _gif_lzw(rows.tobytes(), mcs)
        out.append(mcs)
        for i in range(0, len(data), 255):
            blk = data[i:i + 255]
            out += bytes([len(blk)]) + blk
        out.append(0)
    return bytes(out + b"\x3b")


# ------------------------------------------------------------------ WebP
def riff_webp(chunks) -> bytes:
    """A RIFF WEBP file of (fourcc, payload) chunks."""
    body = b"".join(tag + struct.pack("<I", len(d)) + d + b"\0" * (len(d) & 1)
                    for tag, d in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def webp_chunks(data: bytes):
    """The (fourcc, payload) chunks of a RIFF WEBP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        n = struct.unpack_from("<I", data, pos + 4)[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def vp8x(width, height, chunks, alpha=False, animation=False) -> bytes:
    """A VP8X file of chunks on a width x height canvas."""
    flags = (0x10 if alpha else 0) | (0x02 if animation else 0)
    head = bytes([flags, 0, 0, 0]) + (width - 1).to_bytes(3, "little") + (
        height - 1).to_bytes(3, "little")
    return riff_webp([(b"VP8X", head), *chunks])


def anmf(x, y, width, height, chunks, duration=100, blend=0) -> tuple:
    """An ANMF chunk: a frame at (x, y) (even), its image chunks."""
    head = b"".join(v.to_bytes(3, "little") for v in
                    (x // 2, y // 2, width - 1, height - 1, duration))
    body = b"".join(tag + struct.pack("<I", len(d)) + d + b"\0" * (len(d) & 1)
                    for tag, d in chunks)
    return (b"ANMF", head + bytes([blend]) + body)


class _BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out, self.range, self.bottom, self.bit_count = bytearray(), 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, bits):
        for i in range(bits - 1, -1, -1):
            self.put((v >> i) & 1)

    def signed(self, v, bits):
        self.value(abs(v), bits)
        self.put(v < 0)

    def optional_signed(self, v, bits):
        self.put(v != 0)
        if v:
            self.signed(v, bits)

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def vp8_random(width, height, seed, partitions=0, simple=False, level=20,
               sharpness=0, segments=None, lf_deltas=None, quant=40,
               quant_deltas=(0, 0, 0, 0, 0), data_per_mb=96) -> bytes:
    """A lossy WebP key frame whose header is as given and whose modes and
    tokens are random bits: the frame header up to the entropy refresh
    flag is written field by field, the rest of the first partition
    (coefficient probability updates, the skip probability, every
    macroblock's segment, skip flag and modes) and every token partition
    are random bytes, which a boolean decoder reads as samples of its own
    probabilities.  ``segments``: (update_map, absolute, quantizers,
    filter levels) or None; ``lf_deltas``: (ref deltas, mode deltas) or
    None; ``partitions``: log2 of the token partitions."""
    rng = np.random.default_rng(seed)
    mbs = ((width + 15) >> 4) * ((height + 15) >> 4)
    e = _BoolEncoder()
    e.put(0)  # colour space
    e.put(0)  # clamping type
    e.put(segments is not None)
    if segments is not None:
        update_map, absolute, quants, levels = segments
        e.put(update_map)
        e.put(1)  # update the segment data
        e.put(absolute)
        for q in quants:
            e.optional_signed(q, 7)
        for f in levels:
            e.optional_signed(f, 6)
        if update_map:
            for p in rng.integers(1, 256, 3):
                e.put(1)
                e.value(int(p), 8)
    e.put(simple)
    e.value(level, 6)
    e.value(sharpness, 3)
    e.put(lf_deltas is not None)
    if lf_deltas is not None:
        e.put(1)
        for d in (*lf_deltas[0], *lf_deltas[1]):
            e.optional_signed(d, 6)
    e.value(partitions, 2)
    e.value(quant, 7)
    for d in quant_deltas:
        e.optional_signed(d, 4)
    e.put(0)  # refresh entropy probabilities
    first = e.flush() + rng.integers(0, 256, 200 + 24 * mbs,
                                     dtype=np.uint8).tobytes()
    n = 1 << partitions
    parts = [rng.integers(0, 256, data_per_mb * mbs // n + 64,
                          dtype=np.uint8).tobytes() for _ in range(n)]
    tag = len(first) << 5 | 1 << 4  # key frame, version 0, shown
    frame = (struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a"
             + struct.pack("<HH", width, height) + first
             + b"".join(struct.pack("<I", len(p))[:3] for p in parts[:-1])
             + b"".join(parts))
    return riff_webp([(b"VP8 ", frame)])


# ---------------------------------------------------------- Radiance HDR
def _rgbe(f: np.ndarray) -> np.ndarray:
    """(h, w, 4) RGBE bytes of (h, w, 3) non-negative floats (Greg Ward's
    float2rgbe)."""
    m = f.max(-1)
    mant, e = np.frexp(m)
    scale = np.where(m > 1e-32, mant * 256.0 / np.where(m > 0, m, 1), 0)
    out = np.zeros(f.shape[:2] + (4,), np.uint8)
    out[..., :3] = (f * scale[..., None]).astype(np.uint8)
    out[..., 3] = np.where(m > 1e-32, e + 128, 0)
    return out


def hdr(f: np.ndarray, rle: bool = True, header: bytes = None,
        flat_from: int = None) -> bytes:
    """A Radiance HDR file of (h, w, 3) floats (RGB): new-style run-length
    scanlines (each channel as runs of 4 or more equal bytes and literal
    stretches), or flat RGBE pixels; ``flat_from`` writes the scanlines
    from that row flat (a reader switches to flat pixels there);
    ``header`` replaces the lines before the size line."""
    h, w = f.shape[:2]
    px = _rgbe(np.asarray(f, np.float64))
    out = bytearray(header if header is not None else
                    b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += b"-Y %d +X %d\n" % (h, w)
    for y in range(h):
        if not rle or (flat_from is not None and y >= flat_from):
            out += px[y:].tobytes() if rle else px.tobytes()
            break
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            out += _hdr_runs(px[y, :, c])
    return bytes(out)


def _hdr_runs(v: np.ndarray) -> bytes:
    """One channel of a scanline as HDR runs (128 + n, value) of 4 to 127
    equal bytes and literal stretches (n, bytes) of up to 128."""
    starts = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
    lens = np.diff(np.r_[starts, len(v)])
    out, lit = bytearray(), []

    def flush():
        for i in range(0, len(lit), 128):
            out.append(len(lit[i:i + 128]))
            out.extend(lit[i:i + 128])
        lit.clear()

    for s, n in zip(starts.tolist(), lens.tolist()):
        if n >= 4:
            flush()
            while n > 0:
                k = min(n, 127)
                if k < 4:
                    lit.extend([int(v[s])] * k)
                else:
                    out += bytes([128 + k, int(v[s])])
                n -= k
        else:
            lit.extend(v[s:s + n].tolist())
    flush()
    return bytes(out)


# ---------------------------------------------------------- WebP lossless
def _huffman_lengths(counts, limit: int) -> np.ndarray:
    """Code lengths (at most ``limit``) of a prefix code for counts; a
    single used symbol gets length 1 (written as a simple code)."""
    import heapq

    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    lengths = np.zeros(len(counts), np.int64)
    if len(used) <= 1:
        lengths[used] = 1
        return lengths
    c = counts.copy()
    while True:
        heap = [(int(c[s]), i, [int(s)]) for i, s in enumerate(used)]
        heapq.heapify(heap)
        depth = {int(s): 0 for s in used}
        k = len(heap)
        while len(heap) > 1:
            a, b = heapq.heappop(heap), heapq.heappop(heap)
            for s in a[2] + b[2]:
                depth[s] += 1
            heapq.heappush(heap, (a[0] + b[0], k, a[2] + b[2]))
            k += 1
        if max(depth.values()) <= limit:
            break
        c[used] = np.maximum(c[used] >> 1, 1)
    for s, d in depth.items():
        lengths[s] = d
    return lengths


def _canonical(lengths: np.ndarray) -> np.ndarray:
    """The bit-reversed canonical codes of lengths (VP8L reads a code's
    first bit lowest)."""
    codes = np.zeros(len(lengths), np.int64)
    code = 0
    for n in range(1, 16):
        for s in np.flatnonzero(lengths == n):
            codes[s] = int(format(code, f"0{n}b")[::-1], 2)
            code += 1
        code <<= 1
    return codes


class _Bits:
    """An LSB-first bit writer of (value, width) pieces, packed by numpy."""

    def __init__(self):
        self.values, self.widths = [], []

    def put(self, value, width):
        self.values.append(np.atleast_1d(np.asarray(value, np.int64)))
        self.widths.append(np.broadcast_to(np.asarray(width, np.int64),
                                           self.values[-1].shape))

    def bytes(self) -> bytes:
        v = np.concatenate(self.values)
        w = np.concatenate(self.widths)
        keep = w > 0
        v, w = v[keep], w[keep]
        j = np.arange(int(w.sum())) - np.repeat(np.cumsum(w) - w, w)
        bits = (np.repeat(v, w) >> j) & 1
        return np.packbits(bits.astype(np.uint8), bitorder="little").tobytes()


def _vp8l_code(bits: _Bits, counts) -> tuple:
    """Write a prefix code for counts (simple for one or two symbols below
    256, normal otherwise); (lengths, codes) to write symbols with."""
    counts = np.asarray(counts)
    used = np.flatnonzero(counts)
    if len(used) == 0:
        used = np.array([0])
    if len(used) <= 2 and used.max() < 256:
        bits.put(1, 1)
        bits.put(len(used) - 1, 1)
        wide = used[0] > 1
        bits.put(int(wide), 1)
        bits.put(int(used[0]), 8 if wide else 1)
        if len(used) == 2:
            bits.put(int(used[1]), 8)
        lengths = np.zeros(len(counts), np.int64)
        lengths[used] = 1 if len(used) == 2 else 0
        return lengths, _canonical(lengths)
    lengths = _huffman_lengths(counts, 15)
    order = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14,
             15)
    cl = _huffman_lengths(np.bincount(lengths, minlength=19), 7)
    if (cl > 0).sum() == 1:  # one length for every symbol: a 1-bit code
        cl[(int(np.flatnonzero(cl)[0]) + 1) % 16] = 1
    bits.put(0, 1)
    bits.put(19 - 4, 4)
    for s in order:
        bits.put(int(cl[s]), 3)
    bits.put(0, 1)  # every symbol's length is written
    cl_codes = _canonical(cl)
    bits.put(cl_codes[lengths], cl[lengths])
    return lengths, _canonical(lengths)


def _vp8l_image(bits: _Bits, argb: np.ndarray, main: bool = False):
    """An entropy-coded image of (n,) ARGB uint32: no colour cache, no
    meta codes (``main``: the flag the main image has), every pixel a
    literal."""
    a, r, g, b = ((argb >> s) & 255 for s in (24, 16, 8, 0))
    bits.put(0, 1)  # no colour cache
    if main:
        bits.put(0, 1)  # no meta prefix codes
    tables = [_vp8l_code(bits, np.bincount(g, minlength=280)),
              _vp8l_code(bits, np.bincount(r, minlength=256)),
              _vp8l_code(bits, np.bincount(b, minlength=256)),
              _vp8l_code(bits, np.bincount(a, minlength=256)),
              _vp8l_code(bits, np.zeros(40, np.int64))]
    syms = np.stack([g, r, b, a], -1).astype(np.int64)
    lens = np.stack([tables[i][0][syms[:, i]] for i in range(4)], -1)
    codes = np.stack([tables[i][1][syms[:, i]] for i in range(4)], -1)
    bits.put(codes.ravel(), lens.ravel())


def _vp8l_predict(px: np.ndarray, modes: np.ndarray, tile_bits: int):
    """The predictor transform's residuals of (h, w, 4) ARGB bytes, each
    tile by its mode (0-13)."""
    h, w = px.shape[:2]
    p = px.astype(np.int64)
    pad = np.zeros((h + 1, w + 2, 4), np.int64)
    pad[1:, 1:-1] = p
    pad[1:, -1] = np.r_[p[1:, 0], np.zeros((1, 4), np.int64)]  # TR at x=w-1
    L, T = pad[1:, :-2], pad[:-1, 1:-1]
    TR, TL = pad[:-1, 2:], pad[:-1, :-2]

    def avg(a, b):
        return (a + b) >> 1

    def select():
        d = (np.abs(L - TL) - np.abs(T - TL)).sum(-1, keepdims=True)
        return np.where(d <= 0, T, L)

    half = avg(L, T)
    preds = [np.broadcast_to([255, 0, 0, 0], p.shape), L, T, TR, TL,
             avg(avg(L, TR), T), avg(L, TL), avg(L, T), avg(TL, T),
             avg(T, TR), avg(avg(L, TL), avg(T, TR)), select(),
             np.clip(L + T - TL, 0, 255),
             np.clip(half + np.trunc((half - TL) / 2).astype(np.int64), 0,
                     255)]
    m = np.repeat(np.repeat(modes, 1 << tile_bits, 0), 1 << tile_bits,
                  1)[:h, :w]
    pred = np.choose(m[..., None], preds)
    pred[0, :] = np.r_[[[255, 0, 0, 0]], p[0, :-1]]  # black, then L
    pred[1:, 0] = p[:-1, 0]  # T
    return ((p - pred) & 255).astype(np.uint8)


def vp8l(rgb: np.ndarray, tile_bits: int = 4) -> bytes:
    """A lossless WebP of (h, w, 3) RGB: the subtract-green transform, the
    predictor transform with its tiles cycling through the 14 modes, then
    literal pixels under prefix codes built from their counts."""
    h, w = rgb.shape[:2]
    px = np.empty((h, w, 4), np.uint8)  # A, R, G, B
    px[..., 0] = 255
    px[..., 1:] = rgb
    px[..., 1] -= px[..., 2]  # subtract green
    px[..., 3] -= px[..., 2]
    tw, th = -(-w >> tile_bits), -(-h >> tile_bits)
    modes = (np.arange(th)[:, None] + 3 * np.arange(tw)[None, :]) % 14
    res = _vp8l_predict(px, modes, tile_bits)

    def argb(a):
        a = a.astype(np.uint32)
        return (a[..., 0] << 24 | a[..., 1] << 16 | a[..., 2] << 8
                | a[..., 3]).ravel()

    bits = _Bits()
    bits.put(0x2F, 8)
    bits.put(w - 1, 14)
    bits.put(h - 1, 14)
    bits.put(0, 1)  # alpha is not used
    bits.put(0, 3)  # version
    bits.put(1, 1)
    bits.put(2, 2)  # subtract green
    bits.put(1, 1)
    bits.put(0, 2)  # predictor
    bits.put(tile_bits - 2, 3)
    _vp8l_image(bits, (modes.astype(np.uint32) << 8).ravel())
    bits.put(0, 1)  # no more transforms
    _vp8l_image(bits, argb(res), main=True)
    return riff_webp([(b"VP8L", bits.bytes())])


# ------------------------------------------------------------- JPEG 2000
def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2(codestream: bytes, height: int, width: int, ncomp: int, colr=16,
        pclr=None, cdef=None) -> bytes:
    """A JP2 file around a codestream: the signature, ftyp, a jp2h of ihdr,
    colr (an enumerated colour space, "icc" for a stand-in ICC profile,
    None for no box), pclr + cmap (``pclr``: (entries (n, channels) uint8,
    ) applied to one index component) and cdef (``cdef``: (cn, typ, asoc)
    triples), then jp2c."""
    boxes = _box(b"ihdr", struct.pack(">IIHBBBB", height, width, ncomp, 7, 7,
                                      0, 0))
    if colr == "icc":
        boxes += _box(b"colr", bytes([2, 0, 0]) + bytes(128))
    elif colr is not None:
        boxes += _box(b"colr", struct.pack(">BBBI", 1, 0, 0, colr))
    if pclr is not None:
        entries = np.asarray(pclr, np.uint8)
        n, ch = entries.shape
        boxes += _box(b"pclr", struct.pack(">HB", n, ch) + bytes([7] * ch)
                      + entries.tobytes())
        boxes += _box(b"cmap", b"".join(struct.pack(">HBB", 0, 1, i)
                                        for i in range(ch)))
    if cdef is not None:
        boxes += _box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(
            struct.pack(">HHH", *c) for c in cdef))
    return (_box(b"jP  ", b"\r\n\x87\n")
            + _box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")
            + _box(b"jp2h", boxes) + _box(b"jp2c", codestream))


class _J2kBits:
    """Packet header bits, MSB first, 7 bits in the byte after an 0xFF."""

    def __init__(self):
        self.out, self.buf, self.ct = bytearray(), 0, 8

    def _byteout(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        self.out.append(self.buf >> 8)

    def put(self, v: int, n: int = 1):
        for i in range(n - 1, -1, -1):
            if self.ct == 0:
                self._byteout()
            self.ct -= 1
            self.buf |= ((v >> i) & 1) << self.ct

    def flush(self) -> bytes:
        self._byteout()
        if self.ct == 7:
            self._byteout()
        return bytes(self.out)


class _TagTree:
    def __init__(self, w: int, h: int):
        self.parent, self.value, self.low, self.known = [], [], [], []
        lw, lh = [w], [h]
        while lw[-1] * lh[-1] > 1:
            lw.append((lw[-1] + 1) // 2)
            lh.append((lh[-1] + 1) // 2)
        base = [0]
        for a, b in zip(lw, lh):
            base.append(base[-1] + a * b)
        for lv in range(len(lw)):
            for j in range(lh[lv]):
                for i in range(lw[lv]):
                    self.parent.append(
                        base[lv + 1] + (j // 2) * lw[lv + 1] + i // 2
                        if lv + 1 < len(lw) else None)
        n = base[-1]
        self.value, self.low, self.known = [999] * n, [0] * n, [False] * n

    def set(self, leaf: int, v: int):
        node = leaf
        while node is not None and self.value[node] > v:
            self.value[node] = v
            node = self.parent[node]

    def encode(self, bits: _J2kBits, leaf: int, threshold: int):
        stack, node = [], leaf
        while self.parent[node] is not None:
            stack.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold:
                if low >= self.value[node]:
                    if not self.known[node]:
                        bits.put(1)
                        self.known[node] = True
                    break
                bits.put(0)
                low += 1
            self.low[node] = low
            if not stack:
                break
            node = stack.pop()


def _cdiv(a, b):
    return -(-a // b)


def _cdiv2(a, n):
    return -(-a >> n)


def _j2k_geometry(x0, y0, x1, y1, numres, prcw, prch, cblkw, cblkh):
    """A tile-component's resolutions: (x0, y0, x1, y1, pw, ph, bands),
    each band (bandno, x0, y0, x1, y1, precincts), each precinct (cw, ch,
    code-block boxes), as OpenJPEG's tcd.c lays them out."""
    out = []
    for r in range(numres):
        lv = numres - 1 - r
        rx0, ry0 = _cdiv2(x0, lv), _cdiv2(y0, lv)
        rx1, ry1 = _cdiv2(x1, lv), _cdiv2(y1, lv)
        pdx, pdy = prcw[r], prch[r]
        px0, py0 = rx0 >> pdx << pdx, ry0 >> pdy << pdy
        px1, py1 = _cdiv2(rx1, pdx) << pdx, _cdiv2(ry1, pdy) << pdy
        pw = 0 if rx0 == rx1 else (px1 - px0) >> pdx
        ph = 0 if ry0 == ry1 else (py1 - py0) >> pdy
        if r == 0:
            gx0, gy0, gw, gh = px0, py0, pdx, pdy
        else:
            gx0, gy0, gw, gh = _cdiv2(px0, 1), _cdiv2(py0, 1), pdx - 1, pdy - 1
        cbw, cbh = min(cblkw, gw), min(cblkh, gh)
        bands = []
        for b in ([0] if r == 0 else [1, 2, 3]):
            if b == 0:
                bx = (rx0, ry0, rx1, ry1)
            else:
                xo, yo = b & 1, b >> 1
                bx = (_cdiv2(x0 - (xo << lv), lv + 1),
                      _cdiv2(y0 - (yo << lv), lv + 1),
                      _cdiv2(x1 - (xo << lv), lv + 1),
                      _cdiv2(y1 - (yo << lv), lv + 1))
            precs = []
            for p in range(pw * ph):
                cx = gx0 + (p % pw) * (1 << gw)
                cy = gy0 + (p // pw) * (1 << gh)
                qx0, qy0 = max(cx, bx[0]), max(cy, bx[1])
                qx1, qy1 = min(cx + (1 << gw), bx[2]), min(cy + (1 << gh),
                                                            bx[3])
                tx, ty = qx0 >> cbw << cbw, qy0 >> cbh << cbh
                cw = max(0, ((_cdiv2(qx1, cbw) << cbw) - tx) >> cbw)
                ch = max(0, ((_cdiv2(qy1, cbh) << cbh) - ty) >> cbh)
                boxes = []
                for k in range(cw * ch):
                    ax = tx + (k % cw) * (1 << cbw)
                    ay = ty + (k // cw) * (1 << cbh)
                    boxes.append((max(ax, qx0), max(ay, qy0),
                                  min(ax + (1 << cbw), qx1),
                                  min(ay + (1 << cbh), qy1)))
                precs.append((cw, ch, boxes))
            bands.append((b, *bx, precs))
        out.append((rx0, ry0, rx1, ry1, pw, ph, pdx, pdy, bands))
    return out


def _j2k_order(geo, pocs, layers, tile, sub):
    """The packets (layer, resolution, component, precinct) of a tile in
    the order of OpenJPEG's iterators (pi.c), each once."""
    tx0, ty0, tx1, ty1 = tile
    nc = len(geo)
    seen, out = set(), []

    def emit(key):
        if key not in seen:
            seen.add(key)
            out.append(key)

    def at(c, r, x, y):
        if r >= len(geo[c]):
            return None
        rx0, ry0, rx1, ry1, pw, ph, pdx, pdy, _ = geo[c][r]
        lv = len(geo[c]) - 1 - r
        sx, sy = sub[c][0] << lv, sub[c][1] << lv
        trx0, try0 = _cdiv(tx0, sx), _cdiv(ty0, sy)
        trx1, try1 = _cdiv(tx1, sx), _cdiv(ty1, sy)
        rpx, rpy = pdx + lv, pdy + lv
        if not (y % (sub[c][1] << rpy) == 0 or (y == ty0 and (try0 << lv) % (1 << rpy))):
            return None
        if not (x % (sub[c][0] << rpx) == 0 or (x == tx0 and (trx0 << lv) % (1 << rpx))):
            return None
        if pw == 0 or ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_cdiv(x, sx) >> pdx) - (trx0 >> pdx)
        prcj = (_cdiv(y, sy) >> pdy) - (try0 >> pdy)
        return prci + prcj * pw

    def step(cs):
        dx = min(sub[c][0] << (g[4 + 2] + len(geo[c]) - 1 - r)
                 for c in cs for r, g in enumerate(geo[c]))
        dy = min(sub[c][1] << (g[4 + 3] + len(geo[c]) - 1 - r)
                 for c in cs for r, g in enumerate(geo[c]))
        return dx, dy

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    for r0, c0, l1, r1, c1, prg in pocs:
        l1 = min(l1, layers)
        if prg in (0, 1):
            outer = ([(l, r) for l in range(l1) for r in range(r0, r1)]
                     if prg == 0 else
                     [(l, r) for r in range(r0, r1) for l in range(l1)])
            for l, r in outer:
                for c in range(c0, c1):
                    if r < len(geo[c]):
                        for p in range(geo[c][r][4] * geo[c][r][5]):
                            emit((l, r, c, p))
        elif prg == 2:
            dx, dy = step(range(nc))
            for r in range(r0, r1):
                for x, y in positions(dx, dy):
                    for c in range(c0, c1):
                        p = at(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                emit((l, r, c, p))
        elif prg == 3:
            dx, dy = step(range(nc))
            for x, y in positions(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, len(geo[c]))):
                        p = at(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                emit((l, r, c, p))
        else:
            for c in range(c0, c1):
                dx, dy = step([c])
                for x, y in positions(dx, dy):
                    for r in range(r0, min(r1, len(geo[c]))):
                        p = at(c, r, x, y)
                        if p is not None:
                            for l in range(l1):
                                emit((l, r, c, p))
    return out


def _marker(code: int, body: bytes) -> bytes:
    return struct.pack(">HH", code, 2 + len(body)) + body


def _numpasses(bits: _J2kBits, n: int):
    if n == 1:
        bits.put(0, 1)
    elif n == 2:
        bits.put(2, 2)
    elif n <= 5:
        bits.put(0xC | (n - 3), 4)
    elif n <= 36:
        bits.put(0x1E0 | (n - 6), 9)
    else:
        bits.put(0xFF80 | (n - 37), 16)


def j2k_random(width, height, seed, ncomp=None, prec=None, reversible=None,
               numres=None, layers=None, progression=None, cblksty=None,
               tiles=None, precincts=None, sop=None, eph=None, mct=None,
               roi=None, poc=None, packed=None, tile_parts=None,
               coc=None, qcc=None, subsampling=None, psot0=None, wrap=None,
               max_bytes=10, empty=False, bitplanes=5, passes=None) -> bytes:
    """A JPEG 2000 codestream (or a JP2 file, ``wrap``) with valid main,
    tile-part and packet headers around random code-block payloads: every
    code-block's inclusion layer, zero bit-planes, coding passes and
    segment lengths are drawn from ``seed`` and written as the standard
    codes them (tag trees, comma codes, Lblock), and its segments are
    random bytes, which the MQ (or raw) decoder reads as decisions of its
    own contexts.  Each keyword left None is drawn too: ``cblksty`` (the
    six style bits), ``precincts`` (True: sizes drawn a resolution),
    ``roi`` (component, shift), ``poc`` (a list of
    (RSpoc, CSpoc, LYEpoc, REpoc, CEpoc, Ppoc)), ``packed`` ("ppm", "ppt"
    or ""), ``tile_parts`` (most a tile), ``coc`` / ``qcc`` (a component
    given its own coding style / quantisation), ``psot0`` (the last
    tile-part's length left 0: to the EOC).  ``subsampling`` ((XRsiz,
    YRsiz) a component, else 1) and ``wrap`` (None, or jp2()'s keywords)
    are not drawn; ``empty``: every packet empty (no code-block data);
    ``bitplanes``: most magnitude bit-planes a code-block codes;
    ``passes``: (low, high) of the new passes a packet gives a
    code-block (else 1 to 4, or 5 to 44 one time in ten)."""
    rng = np.random.default_rng(seed)

    def pick(v, f):
        return f() if v is None else v

    nc = pick(ncomp, lambda: int(rng.choice([1, 1, 2, 3, 3, 3, 4])))
    precs = pick(prec, lambda: int(rng.choice([8] * 6 + [9, 10, 12, 16, 20])))
    precs = [precs] * nc if np.isscalar(precs) else list(precs)
    rev = pick(reversible, lambda: bool(rng.integers(2)))
    nres = pick(numres, lambda: int(rng.integers(1, 7)))
    nlay = pick(layers, lambda: int(rng.integers(1, 5)))
    prg = pick(progression, lambda: int(rng.integers(5)))
    sty = pick(cblksty, lambda: int(rng.integers(64)) if rng.random() < 0.7
               else 0)
    tdx, tdy = pick(tiles, lambda: (
        (int(rng.integers(8, width + 8)), int(rng.integers(8, height + 8)))
        if rng.random() < 0.35 else (width, height)))
    use_prc = pick(precincts, lambda: rng.random() < 0.5)
    sop = pick(sop, lambda: bool(rng.integers(2)))
    eph = pick(eph, lambda: bool(rng.integers(2)))
    mct = pick(mct, lambda: int(nc >= 3 and rng.random() < 0.7))
    packed = pick(packed, lambda: str(rng.choice(["", "", "", "ppm",
                                                  "ppt"])))
    nparts = pick(tile_parts, lambda: int(rng.integers(1, 4)))
    sub = pick(subsampling, lambda: [(1, 1)] * nc)
    psot0 = pick(psot0, lambda: rng.random() < 0.1)
    xcb = int(rng.integers(2, 7))
    ycb = int(rng.integers(2, min(7, 13 - xcb)))

    def coding(nr):
        """Precinct sizes (log2) of nr resolutions: drawn, or 2^15."""
        if not use_prc:
            return [15] * nr, [15] * nr
        return ([int(rng.integers(0 if r == 0 else 1, 7)) for r in range(nr)]
                for _ in range(2))

    prcw, prch = coding(nres)
    # components: (numres, prcw, prch, xcb, ycb, reversible)
    comps = [(nres, prcw, prch, xcb, ycb, rev)] * nc
    coc_c = pick(coc, lambda: int(rng.integers(nc)) if rng.random() < 0.3
                 else None)
    coc_body = b""
    if coc_c is not None:
        fixed = mct and coc_c < 3  # the component transform needs equal
        nr = nres if fixed else int(rng.integers(1, 7))
        pw, ph = coding(nr)
        cx = int(rng.integers(2, 7))
        cy = int(rng.integers(2, min(7, 13 - cx)))
        crev = rev if fixed else bool(rng.integers(2))
        comps[coc_c] = (nr, pw, ph, cx, cy, crev)
        coc_body = (struct.pack(">BB", coc_c, 1 if use_prc else 0)
                    + struct.pack(">BBBBB", nr - 1, cx - 2, cy - 2, sty,
                                  1 if crev else 0)
                    + (bytes(a | b << 4 for a, b in zip(pw, ph))
                       if use_prc else b""))

    def quant(c_prec, c_rev, nr):
        guard = int(rng.integers(1, 4))
        gains = [0] + [1, 1, 2] * (nr - 1)
        if c_rev:
            expn = [c_prec + g for g in gains]
            return 0, guard, expn, [0] * len(expn), bytes(e << 3 for e in expn)
        style = int(rng.integers(1, 3))
        e0 = c_prec + int(rng.integers(-1, 3))
        if style == 1:
            mant = int(rng.integers(2048))
            expn = [max(e0 - (b - 1) // 3, 0) if b else e0
                    for b in range(3 * nr - 2)]
            return 1, guard, expn, [mant] * len(expn), struct.pack(
                ">H", e0 << 11 | mant)
        expn = [e0 + int(rng.integers(-1, 2)) + g for g in gains]
        mant = [int(rng.integers(2048)) for _ in gains]
        return 2, guard, expn, mant, b"".join(
            struct.pack(">H", e << 11 | m) for e, m in zip(expn, mant))

    qcc_c = pick(qcc, lambda: int(rng.integers(nc)) if rng.random() < 0.3
                 else None)
    qdef = quant(precs[0], rev, nres)
    # a component of its own coding style gets its own steps too
    own = {c: quant(precs[c], comps[c][5], comps[c][0])
           for c in {coc_c, qcc_c} - {None}}
    qs = [own.get(c, qdef) for c in range(nc)]
    roi_c, roi_s = pick(roi, lambda: (int(rng.integers(nc)),
                                      int(rng.integers(1, 9)))
                        if rng.random() < 0.2 else (None, 0))
    pocs = pick(poc, lambda: None if rng.random() < 0.75 else [
        (0, 0, int(rng.integers(1, nlay + 1)), int(rng.integers(1, 8)),
         int(rng.integers(1, nc + 1)), int(rng.integers(5))),
        (0, 0, nlay, 33, nc, int(rng.integers(5)))])

    # main header
    cs = bytearray(b"\xff\x4f")
    cs += _marker(0xFF51, struct.pack(">HIIIIIIIIH", 0, width, height, 0, 0,
                                      tdx, tdy, 0, 0, nc) + b"".join(
        struct.pack(">BBB", p - 1, *d) for p, d in zip(precs, sub)))
    scod = (1 if use_prc else 0) | (2 if sop else 0) | (4 if eph else 0)
    cs += _marker(0xFF52, struct.pack(">BBHB", scod, prg, nlay, mct)
                  + struct.pack(">BBBBB", nres - 1, xcb - 2, ycb - 2, sty,
                                1 if rev else 0)
                  + (bytes(a | b << 4 for a, b in zip(prcw, prch))
                     if use_prc else b""))
    if coc_body:
        cs += _marker(0xFF53, coc_body)
    style, guard, _, _, body = qdef
    cs += _marker(0xFF5C, bytes([guard << 5 | style]) + body)
    for c in sorted(own):
        style, guard, _, _, body = own[c]
        cs += _marker(0xFF5D, bytes([c, guard << 5 | style]) + body)
    if roi_c is not None:
        cs += _marker(0xFF5E, bytes([roi_c, 0, roi_s]))
    if pocs:
        cs += _marker(0xFF5F, b"".join(struct.pack(">BBHBBB", *p)
                                       for p in pocs))
    cs += _marker(0xFF64, b"\x00\x01random code-blocks")
    # tiles
    ntx, nty = _cdiv(width, tdx), _cdiv(height, tdy)
    tiles_out, ppm_chunks = [], []
    for t in range(ntx * nty):
        p, q = t % ntx, t // ntx
        box = (p * tdx, q * tdy, min((p + 1) * tdx, width),
               min((q + 1) * tdy, height))
        geo = [_j2k_geometry(*(_cdiv(v, sub[c][i % 2])
                               for i, v in enumerate(box)), *comps[c][:5])
               for c in range(nc)]
        order = _j2k_order(geo, pocs or [(0, 0, nlay, max(
            g[0] for g in comps), nc, prg)], nlay, box, sub)
        state = {}
        trees = {}
        headers, bodies = [], []
        for nsop, (l, r, c, p) in enumerate(order):
            c_nres, _, _, _, _, c_rev = comps[c]
            qstyle, qguard, expn, _, _ = qs[c]
            bits = _J2kBits()
            blocks = []
            for band in geo[c][r][8]:
                bno, bx0, by0, bx1, by1, precs_ = band
                if bx1 - bx0 == 0 or by1 - by0 == 0:
                    continue
                cw, ch, boxes = precs_[p]
                key = (c, r, bno, p)
                if key not in trees and boxes:
                    incl, imsb = _TagTree(cw, ch), _TagTree(cw, ch)
                    mb = expn[0 if r == 0 else 3 * (r - 1) + bno] + qguard - 1
                    plan = []
                    for k in range(len(boxes)):
                        first = nlay if empty else int(rng.integers(
                            0, nlay + 1))
                        nbps = int(rng.integers(0, min(mb + 1, bitplanes)
                                                + 1))
                        incl.set(k, first if first < nlay else 999)
                        imsb.set(k, mb + 1 - nbps)
                        plan.append(first)
                    trees[key] = (incl, imsb, plan)
                    for k in range(len(boxes)):
                        state[key + (k,)] = {"segs": [], "lenbits": 3}
                if boxes:
                    blocks.append((key, boxes))
            # which code-blocks this packet includes: each at its first
            # layer, then in most later ones
            inc = {}
            for key, boxes in blocks:
                plan = trees[key][2]
                for k in range(len(boxes)):
                    inc[key + (k,)] = (plan[k] == l or plan[k] < l
                                       and rng.random() < 0.7)
            payload = bytearray()
            if not any(inc.values()) and (empty or rng.random() < 0.5):
                bits.put(0)  # an empty packet
            else:
                bits.put(1)
                for key, boxes in blocks:
                    incl, imsb, _ = trees[key]
                    for k in range(len(boxes)):
                        st = state[key + (k,)]
                        if not st["segs"]:
                            incl.encode(bits, k, l + 1)
                        else:
                            bits.put(inc[key + (k,)])
                        if not inc[key + (k,)]:
                            continue
                        if not st["segs"]:
                            imsb.encode(bits, k, 999)
                        if passes:
                            n = int(rng.integers(*passes))
                        elif rng.random() < 0.9:
                            n = int(rng.integers(1, 5))
                        else:
                            n = int(rng.integers(5, 45))
                        _numpasses(bits, n)
                        # the new passes split into segments as t2.c does
                        segs, pieces, left = st["segs"], [], n
                        if not segs or segs[-1][0] == segs[-1][1]:
                            segs.append([0, _maxpasses(sty, segs)])
                        while True:
                            take = min(segs[-1][1] - segs[-1][0], left)
                            segs[-1][0] += take
                            pieces.append(take)
                            left -= take
                            if left <= 0:
                                break
                            segs.append([0, _maxpasses(sty, segs)])
                        lens = [int(rng.integers(0, max_bytes + 1))
                                for _ in pieces]
                        need = max([st["lenbits"]] + [
                            ln.bit_length() - (tk.bit_length() - 1)
                            for ln, tk in zip(lens, pieces)])
                        bits.put((1 << (need - st["lenbits"])) - 1,
                                 need - st["lenbits"])
                        bits.put(0)
                        st["lenbits"] = need
                        for ln, tk in zip(lens, pieces):
                            bits.put(ln, need + tk.bit_length() - 1)
                        payload += rng.integers(0, 256, sum(lens),
                                                np.uint8).tobytes()
            hdr = bits.flush() + (b"\xff\x92" if eph else b"")
            lead = (b"\xff\x91" + struct.pack(">HH", 4, nsop & 0xFFFF)
                    if sop else b"")
            headers.append(hdr)
            bodies.append((lead, bytes(payload)))
        tiles_out.append((headers, bodies))

    # tile-parts
    for t, (headers, bodies) in enumerate(tiles_out):
        if packed:
            packets = [lead + body for lead, body in bodies]
        else:
            packets = [lead + hdr + body
                       for hdr, (lead, body) in zip(headers, bodies)]
        k = 1 if packed == "ppm" else max(1, min(nparts, len(packets)))
        cuts = sorted(rng.choice(np.arange(1, len(packets)), k - 1,
                                 replace=False)) if k > 1 else []
        bounds = [0, *cuts, len(packets)]
        for part in range(k):
            extra = b""
            if packed == "ppt" and part == 0:
                allh = b"".join(headers)
                half = len(allh) // 2
                extra = (_marker(0xFF61, b"\x01" + allh[half:])
                         + _marker(0xFF61, b"\x00" + allh[:half]))
            if packed == "ppm":
                ppm_chunks.append(b"".join(headers))
            data = b"".join(packets[bounds[part]:bounds[part + 1]])
            psot = 12 + len(extra) + 2 + len(data)
            if psot0 and t == len(tiles_out) - 1 and part == k - 1:
                psot = 0  # the last tile-part runs to the EOC
            cs += struct.pack(">HHHIBB", 0xFF90, 10, t, psot, part, k)
            cs += extra + b"\xff\x93" + data
    if packed == "ppm":
        # Nppm and Ippm of each tile-part, over two markers, Zppm 1 first
        allp = b"".join(struct.pack(">I", len(ch)) + ch for ch in ppm_chunks)
        cut = 4 + len(ppm_chunks[0]) if len(ppm_chunks) > 1 else len(allp)
        first = _marker(0xFF60, b"\x00" + allp[:cut])
        second = _marker(0xFF60, b"\x01" + allp[cut:]) if cut < len(allp) \
            else b""
        sot = cs.index(b"\xff\x90\x00\x0a")
        cs[sot:sot] = second + first
    cs += b"\xff\xd9"
    if wrap is None:
        return bytes(cs)
    return jp2(bytes(cs), height, width, nc, **wrap)


def _maxpasses(sty: int, segs) -> int:
    """t2.c's opj_t2_init_seg: the passes a new segment holds."""
    if sty & 4:  # TERMALL
        return 1
    if sty & 1:  # BYPASS
        if len(segs) == 0:
            return 10
        return 2 if segs[-1][1] in (1, 10) else 1
    return 109
