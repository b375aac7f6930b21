"""Image files in the container formats ``cv2.imread`` reads beside JPEG
and PNG, for tests/test_torch_formats.py and chip_smoke.py's fixtures:
BMP (every depth, palettes, bit fields, RLE4 and RLE8 with delta and
end-of-line codes, top-down rows, the v3, v4 and v5 headers), PxM (ASCII
P1-P3, binary P4-P6, PAM, PFM), Sun raster (standard, RLE and RGB types,
colour maps) and TIFF (strips and tiles, both planar configurations, both
byte orders, no compression, PackBits, LZW and Deflate, the horizontal
predictor, grey, RGB and palette data, extra alpha samples).

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
         orientation=None, bigtiff: bool = False) -> bytes:
    """A classic TIFF of ``img`` (h, w) or (h, w, spp) samples (uint8, or
    uint16 at 16 bits; 0/1 or indices below 8 bits, rows packed
    MSB-first): one IFD, strips (``rows_per_strip``) or tiles (``tile``
    (th, tw), multiples of 16), planar 1 or 2, ``colormap`` (3, 2**bps)
    uint16, ``extra`` the ExtraSamples values, ``orientation`` the
    Orientation tag."""
    e = ">" if big_endian else "<"
    a = img if img.ndim == 3 else img[..., None]
    h, w, spp = a.shape
    dt = np.dtype(e + "u2") if bps == 16 else np.dtype(np.uint8)

    def encode(block):
        """(rows, cols, s) samples -> the chunk's bytes."""
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
    tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
            259: (3, [compression]), 262: (3, [photometric]),
            277: (3, [spp]), 284: (3, [planar])}
    if predictor != 1:
        tags[317] = (3, [predictor])
    if colormap is not None:
        tags[320] = (3, [int(v) for v in np.asarray(colormap).ravel()])
    if extra is not None:
        tags[338] = (3, list(extra))
    if sample_format is not None:
        tags[339] = (3, [sample_format] * spp)
    if orientation is not None:
        tags[274] = (3, [orientation])
    if tile is None:
        tags[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    else:
        tags[322] = (4, [tile[1]])
        tags[323] = (4, [tile[0]])
        off_tag, cnt_tag = 324, 325
    # layout: header, chunk data, out-of-line values, the IFD
    body = bytearray()
    offsets = []
    for c in chunks:
        offsets.append(8 + len(body))
        body += c
        if len(body) % 2:
            body += b"\0"
    tags[off_tag] = (4, offsets)
    tags[cnt_tag] = (4, [len(c) for c in chunks])
    fmt = {3: "H", 4: "I"}
    size = {3: 2, 4: 4}
    entries = []
    for tag in sorted(tags):
        typ, vals = tags[tag]
        payload = struct.pack(e + fmt[typ] * len(vals), *vals)
        if len(payload) <= 4:
            entries.append((tag, typ, len(vals), payload.ljust(4, b"\0")))
        else:
            off = 8 + len(body)
            body += payload
            if len(body) % 2:
                body += b"\0"
            entries.append((tag, typ, len(vals), struct.pack(e + "I", off)))
        assert size[typ]
    ifd_off = 8 + len(body)
    ifd = struct.pack(e + "H", len(entries))
    for tag, typ, n, val in entries:
        ifd += struct.pack(e + "HHI", tag, typ, n) + val
    ifd += struct.pack(e + "I", 0)
    if bigtiff:
        head = (b"MM" if big_endian else b"II") + struct.pack(
            e + "HHHQ", 43, 8, 0, 16)
        return head + bytes(body) + ifd
    head = (b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42,
                                                           ifd_off)
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
# the target's file name; cv2.imread decodes by content)
FRAME_FORMATS = (
    (".bmp", ("bmp24", "bmp_rle8", "bmp565", "bmp32")),
    (".tif", ("tiff_lzw", "tiff_deflate_tiles", "tiff_packbits_planar",
              "tiff16")),
    (".ppm", ("p6", "p3", "sun24", "sun8")),
)


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
    if kind == "tiff_lzw":
        return tiff(img, compression=5, rows_per_strip=8)
    if kind == "tiff_deflate_tiles":
        return tiff(img, compression=8, predictor=2, tile=(32, 32))
    if kind == "tiff_packbits_planar":
        return tiff(img, compression=32773, planar=2, big_endian=True,
                    rows_per_strip=16)
    if kind == "tiff16":
        return tiff(img.astype(np.uint16) * 257 + 77, 16, compression=5,
                    predictor=2)
    if kind == "p6":
        return pnm_binary(img, "P6")
    if kind == "p3":
        return pnm_ascii(img, "P3")
    if kind == "sun24":
        return sun_raster(img, 24)
    if kind == "sun8":
        idx, pal = _quantize(img)
        return sun_raster(idx, 8, cmap=pal)
    raise ValueError(kind)
