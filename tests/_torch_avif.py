"""AVIF files for tests/test_torch_avif.py and chip_smoke.py's fixtures:
cv2's and Pillow's writers (libavif with libaom; stills and sequences),
a HEIF rebuilder that edits a file's boxes (properties, colour, items,
references; a sequence's tracks and sample tables) and lays it out
again, and libaom's decoder (bundled beside cv2) through ctypes as the
oracle of the decoded planes.

    python -m tests._torch_avif tables OUT.h

from the repository root rewrites the decoder's tables
(transhuman_tpu_torch/native/av1_tables.h) from libaom's read-only data.

What the port must equal is ``cv2.imread`` of the file, never a writer's
input; libaom's planes hold the decoder before the colour conversion."""

import ctypes
import glob
import io
import os
import struct
import subprocess
import sys

import numpy as np


# ---------------------------------------------------------------- writers
def cv2_avif(img, quality=None, depth=None, speed=None) -> bytes:
    """cv2.imencode('.avif') of a BGR, BGRA or grey image (uint16 samples
    for depth 10 or 12)."""
    import cv2

    params = []
    for key, v in ((cv2.IMWRITE_AVIF_QUALITY, quality),
                   (cv2.IMWRITE_AVIF_DEPTH, depth),
                   (cv2.IMWRITE_AVIF_SPEED, speed)):
        if v is not None:
            params += [key, v]
    ok, buf = cv2.imencode(".avif", img, params)
    assert ok
    return buf.tobytes()


def pil_avif(rgb, **kw) -> bytes:
    """Pillow's AVIF of an RGB or RGBA uint8 image; kw as Image.save
    takes them (quality, speed, subsampling, range, tile_rows, tile_cols,
    advanced aom options, exif)."""
    from PIL import Image

    b = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb)).save(b, "AVIF", **kw)
    return b.getvalue()


def screen_rgb(h, w, seed=0, rects=3):
    """An (h, w) RGB screen capture, the content AV1's screen tools are
    for: lines of cv2.putText text (grey 20 on 250, scale 0.5, every 21
    rows) over seeded coloured rectangles (chroma for UV palettes)."""
    import cv2

    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 250, np.uint8)
    for _ in range(rects):
        x0, y0 = (int(v) for v in rng.integers(0, [w, h]))
        x1 = x0 + int(rng.integers(8, max(w // 2, 9)))
        y1 = y0 + int(rng.integers(8, max(h // 2, 9)))
        colour = tuple(int(v) for v in rng.integers(0, 256, 3))
        cv2.rectangle(img, (x0, y0), (x1, y1), colour, -1)
    line = "The quick brown fox jumps over the lazy dog " * (w // 300 + 1)
    for i in range(h // 21):
        cv2.putText(img, line, (4, 16 + 21 * i), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (20, 20, 20), 1)
    return img


# ------------------------------------------------------------------ boxes
def box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def full_box(kind: bytes, version: int, flags: int, body: bytes) -> bytes:
    return box(kind, bytes([version]) + flags.to_bytes(3, "big") + body)


def boxes(data: bytes, start=0, end=None):
    end = len(data) if end is None else end
    pos = start
    while pos + 8 <= end:
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        yield kind, pos + head, pos + size
        pos += size


class Heif:
    """A still-image AVIF as editable parts: ftyp, items {id: [type, data,
    name]}, the primary id, references [(type, from, to)], properties
    [(type, body)] and associations {id: [(index, essential)]}; bytes()
    lays it out again (meta before mdat, one extent an item, in the order
    of their ids; the items of ``in_idat`` in the meta box's idat, iloc v1
    construction method 1, the rest in mdat)."""

    def __init__(self, data: bytes):
        self.in_idat = set()
        top = {k: (s, e) for k, s, e in boxes(data)}
        s, e = top[b"ftyp"]
        self.ftyp = data[s:e]
        s, e = top[b"meta"]
        meta = {k: (s2, e2) for k, s2, e2 in boxes(data, s + 4, e)}
        s2, e2 = meta[b"pitm"]
        self.primary = struct.unpack_from(">H", data, s2 + 4)[0]
        self.items = {}
        s2, e2 = meta[b"iinf"]
        for k, s3, e3 in boxes(data, s2 + 6, e2):
            iid, _, kind = struct.unpack_from(">HH4s", data, s3 + 4)
            name = data[s3 + 12:e3]
            self.items[iid] = [kind, b"", name]
        s2, e2 = meta[b"iloc"]
        version = data[s2]
        off, length = data[s2 + 4] >> 4, data[s2 + 4] & 15
        base, index = data[s2 + 5] >> 4, data[s2 + 5] & 15 if version else 0
        pos = s2 + 6
        count = struct.unpack_from(">H", data, pos)[0]
        pos += 2
        idat = b""
        if b"idat" in meta:
            idat = data[meta[b"idat"][0]:meta[b"idat"][1]]

        def uint(n):
            nonlocal pos
            v = int.from_bytes(data[pos:pos + n], "big")
            pos += n
            return v
        for _ in range(count):
            iid = uint(2)
            method = uint(2) & 15 if version else 0
            uint(2)
            b = uint(base)
            parts = []
            for _ in range(uint(2)):
                uint(index)
                o, n = b + uint(off), uint(length)
                src = data if method == 0 else idat
                parts.append(src[o:o + n])
            self.items[iid][1] = b"".join(parts)
        self.refs = []
        if b"iref" in meta:
            s2, e2 = meta[b"iref"]
            for k, s3, e3 in boxes(data, s2 + 4, e2):
                src, n = struct.unpack_from(">HH", data, s3)
                for i in range(n):
                    self.refs.append((k, src, struct.unpack_from(
                        ">H", data, s3 + 4 + 2 * i)[0]))
        s2, e2 = meta[b"iprp"]
        iprp = {k: (s3, e3) for k, s3, e3 in boxes(data, s2, e2)}
        s3, e3 = iprp[b"ipco"]
        self.props = [(k, data[s4:e4]) for k, s4, e4 in boxes(data, s3, e3)]
        s3, e3 = iprp[b"ipma"]
        flags = int.from_bytes(data[s3 + 1:s3 + 4], "big")
        pos = s3 + 4
        self.assoc = {}
        for _ in range(uint(4)):
            iid = uint(2)
            for _ in range(uint(1)):
                v = uint(2) if flags & 1 else uint(1)
                bits = 15 if flags & 1 else 7
                self.assoc.setdefault(iid, []).append(
                    (v & ((1 << bits) - 1), v >> bits))

    def prop(self, iid, kind):
        """The body of item iid's first property of type kind, or None."""
        for index, _ in self.assoc.get(iid, ()):
            if self.props[index - 1][0] == kind:
                return self.props[index - 1][1]
        return None

    def add_prop(self, iid, kind, body, essential=0):
        self.props.append((kind, body))
        self.assoc.setdefault(iid, []).append((len(self.props), essential))

    def drop_prop(self, iid, kind):
        self.assoc[iid] = [(i, e) for i, e in self.assoc[iid]
                           if self.props[i - 1][0] != kind]

    def set_prop(self, iid, kind, body):
        for index, _ in self.assoc.get(iid, ()):
            if self.props[index - 1][0] == kind:
                self.props[index - 1] = (kind, body)
                return
        self.add_prop(iid, kind, body)

    def __bytes__(self):
        return self.layout()

    def layout(self, moov=None) -> bytes:
        """ftyp, meta, then ``moov`` where given (a function of the file
        offset its data will start at, returning the moov box and that
        data, which follows the items' data in mdat), then mdat."""
        ids = sorted(self.items)
        infe = b"".join(full_box(b"infe", 2, 0, struct.pack(
            ">HH4s", i, 0, self.items[i][0]) + self.items[i][2]) for i in ids)
        iinf = full_box(b"iinf", 0, 0, struct.pack(">H", len(ids)) + infe)
        refs, groups = b"", {}
        for kind, src, dst in self.refs:
            groups.setdefault((kind, src), []).append(dst)
        for (kind, src), dsts in groups.items():
            refs += box(kind, struct.pack(">HH", src, len(dsts)) + b"".join(
                struct.pack(">H", d) for d in dsts))
        iref = full_box(b"iref", 0, 0, refs) if refs else b""
        ipco = box(b"ipco", b"".join(box(k, b) for k, b in self.props))
        ipma = b""
        for iid in sorted(self.assoc):
            a = self.assoc[iid]
            ipma += struct.pack(">HB", iid, len(a)) + bytes(
                (e << 7) | i for i, e in a)
        ipma = full_box(b"ipma", 0, 0, struct.pack(">I", len(self.assoc))
                        + ipma)
        hdlr = full_box(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
        pitm = full_box(b"pitm", 0, 0, struct.pack(">H", self.primary))
        ftyp = box(b"ftyp", self.ftyp)

        inner = [i for i in ids if i in self.in_idat]
        outer = [i for i in ids if i not in self.in_idat]
        idat = b"".join(self.items[i][1] for i in inner)
        idat = box(b"idat", idat) if inner else b""

        def meta(offsets):
            if inner:  # version 1: construction methods
                entries = b"".join(struct.pack(
                    ">HHHHII", i, int(i in self.in_idat), 0, 1, offsets[i],
                    len(self.items[i][1])) for i in ids)
            else:
                entries = b"".join(struct.pack(
                    ">HHHII", i, 0, 1, offsets[i], len(self.items[i][1]))
                    for i in ids)
            iloc = full_box(b"iloc", int(bool(inner)), 0, bytes(
                [0x44, 0x00]) + struct.pack(">H", len(ids)) + entries)
            return full_box(b"meta", 0, 0, hdlr + pitm + iloc + iinf + iref
                            + box(b"iprp", ipco + ipma) + idat)
        tracks = moov(0)[0] if moov else b""
        start = len(ftyp) + len(meta({i: 0 for i in ids})) + len(tracks) + 8
        offsets, pos = {}, start
        for i in outer:
            offsets[i] = pos
            pos += len(self.items[i][1])
        tracks, samples = moov(pos) if moov else (b"", b"")
        pos = 0
        for i in inner:
            offsets[i] = pos
            pos += len(self.items[i][1])
        mdat = box(b"mdat", b"".join(self.items[i][1] for i in outer)
                   + samples)
        return ftyp + meta(offsets) + tracks + mdat


def set_nclx(data: bytes, cp=None, tc=None, mc=None, full=None) -> bytes:
    """data with its primary item's colr nclx property rewritten (added
    where it has none)."""
    h = Heif(data)
    body = h.prop(h.primary, b"colr")
    old = (struct.unpack_from(">HHHB", body, 4) if body and body[:4]
           == b"nclx" else (2, 2, 2, 0x80))
    new = (old[0] if cp is None else cp, old[1] if tc is None else tc,
           old[2] if mc is None else mc,
           old[3] if full is None else (0x80 if full else 0))
    h.set_prop(h.primary, b"colr", b"nclx" + struct.pack(">HHHB", *new))
    return bytes(h)


# ------------------------------------------------------ libaom, the oracle
def _libs_dir():
    import cv2

    return os.path.join(os.path.dirname(os.path.dirname(cv2.__file__)),
                        "opencv_python.libs")


def libaom_path() -> str:
    found = glob.glob(os.path.join(_libs_dir(), "libaom-*.so*"))
    assert found, "libaom is not beside cv2"
    return found[0]


class _Ctx(ctypes.Structure):
    _fields_ = [("name", ctypes.c_void_p), ("iface", ctypes.c_void_p),
                ("err", ctypes.c_int), ("err_detail", ctypes.c_void_p),
                ("init_flags", ctypes.c_long), ("config", ctypes.c_void_p),
                ("priv", ctypes.c_void_p)]


class _Cfg(ctypes.Structure):
    _fields_ = [("threads", ctypes.c_uint), ("w", ctypes.c_uint),
                ("h", ctypes.c_uint), ("allow_lowbitdepth", ctypes.c_uint)]


_AOM = None


def _aom():
    global _AOM
    if _AOM is None:
        lib = ctypes.CDLL(libaom_path())
        lib.aom_codec_av1_dx.restype = ctypes.c_void_p
        lib.aom_codec_dec_init_ver.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
            ctypes.c_int]
        lib.aom_codec_decode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_size_t, ctypes.c_void_p]
        lib.aom_codec_get_frame.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.aom_codec_get_frame.restype = ctypes.c_void_p
        lib.aom_codec_destroy.argtypes = [ctypes.c_void_p]
        _AOM = lib
    return _AOM


def libaom_planes(obus: bytes) -> list:
    """libaom 3.14's decode of one AV1 still image: [Y] or [Y, U, V] as
    uint16 arrays at the frame's size."""
    lib = _aom()
    ctx, cfg = _Ctx(), _Cfg(1, 0, 0, 1)
    for ver in range(5, 40):  # the decoder ABI version of this build
        if lib.aom_codec_dec_init_ver(ctypes.byref(ctx),
                                      lib.aom_codec_av1_dx(),
                                      ctypes.byref(cfg), 0, ver) == 0:
            break
    else:
        raise RuntimeError("aom_codec_dec_init_ver failed")
    try:
        if lib.aom_codec_decode(ctypes.byref(ctx), obus, len(obus), None):
            raise RuntimeError("aom_codec_decode failed")
        it = ctypes.c_void_p(0)
        img = lib.aom_codec_get_frame(ctypes.byref(ctx), ctypes.byref(it))
        if not img:
            raise RuntimeError("libaom gave no frame")
        raw = ctypes.string_at(img, 112)
        fmt, _, _, _, mono = struct.unpack_from("<5i", raw, 0)
        dw, dh = struct.unpack_from("<2I", raw, 40)
        xs, ys = struct.unpack_from("<2I", raw, 56)
        planes = struct.unpack_from("<3Q", raw, 64)
        strides = struct.unpack_from("<3i", raw, 88)
        wide = fmt & 0x800  # AOM_IMG_FMT_HIGHBITDEPTH
        out = []
        for p in range(1 if mono else 3):
            pw = dw if p == 0 else (dw + xs) >> xs
            ph = dh if p == 0 else (dh + ys) >> ys
            size = 2 if wide else 1
            rows = [np.frombuffer(ctypes.string_at(
                planes[p] + r * strides[p], pw * size),
                np.uint16 if wide else np.uint8) for r in range(ph)]
            out.append(np.stack(rows).astype(np.uint16))
        return out
    finally:
        lib.aom_codec_destroy(ctypes.byref(ctx))


def primary_obus(data: bytes) -> bytes:
    h = Heif(data)
    return h.items[h.primary][1]


# ---------------------------------------------------------------- tables
def write_tables(out: str):
    """The decoder's tables header from libaom's read-only data, read by
    symbol (nm) and from FRAME_CONTEXT after av1_init_mode_probs."""
    path = libaom_path()
    syms = {}
    for line in subprocess.run(["nm", "-S", path], capture_output=True,
                               text=True, check=True).stdout.splitlines():
        p = line.split()
        if len(p) == 4:
            syms.setdefault(p[3], (int(p[0], 16), int(p[1], 16)))
    lib = ctypes.CDLL(path)
    base = (ctypes.cast(lib.aom_codec_version, ctypes.c_void_p).value
            - syms["aom_codec_version"][0])

    def arr(name, dtype):
        a, n = syms[name]
        return np.frombuffer(ctypes.string_at(base + a, n), dtype).copy()
    buf = ctypes.create_string_buffer(1 << 17)
    ctypes.CFUNCTYPE(None, ctypes.c_void_p)(
        base + syms["av1_init_mode_probs"][0])(ctypes.addressof(buf))
    fc = np.frombuffer(buf.raw, np.uint16)
    text = []

    def emit(ctype, name, a, per_line=16):
        a = np.asarray(a)
        dims = "".join(f"[{d}]" for d in a.shape)
        flat = a.reshape(-1).tolist()
        rows = ["  " + ", ".join(str(int(v)) for v in flat[i:i + per_line])
                + "," for i in range(0, len(flat), per_line)]
        text.append(f"static const {ctype} {name}{dims} = {{\n"
                    + "\n".join(rows) + "\n};\n")
    u16 = np.uint16
    emit("uint16_t", "kDefTxbSkip",
         arr("av1_default_txb_skip_cdfs", u16).reshape(4, 5, 13, 3))
    emit("uint16_t", "kDefEobExtra",
         arr("av1_default_eob_extra_cdfs", u16).reshape(4, 5, 2, 9, 3))
    emit("uint16_t", "kDefDcSign",
         arr("av1_default_dc_sign_cdfs", u16).reshape(4, 2, 3, 3))
    for n, k in ((16, 6), (32, 7), (64, 8), (128, 9), (256, 10), (512, 11),
                 (1024, 12)):
        emit("uint16_t", f"kDefEob{n}",
             arr(f"av1_default_eob_multi{n}_cdfs", u16).reshape(4, 2, 2, k))
    emit("uint16_t", "kDefBaseEob", arr(
        "av1_default_coeff_base_eob_multi_cdfs", u16).reshape(4, 5, 2, 4, 4))
    emit("uint16_t", "kDefBase", arr(
        "av1_default_coeff_base_multi_cdfs", u16).reshape(4, 5, 2, 42, 5))
    emit("uint16_t", "kDefBr", arr(
        "av1_default_coeff_lps_multi_cdfs", u16).reshape(4, 5, 2, 21, 5))
    # FRAME_CONTEXT fields, at their uint16 offsets in libaom 3.14
    for name, off, shape in (
            ("kDefSkip", 5935, (3, 3)), ("kDefSegSpatial", 6254, (3, 9)),
            ("kDefFilterIntra", 6281, (22, 3)),
            ("kDefFilterIntraMode", 6347, (6,)),
            ("kDefUvMode", 6419, (2, 13, 15)),
            ("kDefPartition", 6809, (20, 11)), ("kDefKfY", 7093, (5, 5, 14)),
            ("kDefAngleDelta", 7443, (8, 8)), ("kDefTxSize", 7507, (4, 3, 4)),
            ("kDefDeltaQ", 7555, (5,)), ("kDefDeltaLfMulti", 7560, (4, 5)),
            ("kDefDeltaLf", 7580, (5,)),
            ("kDefIntraExtTx", 7585, (3, 4, 13, 17)),
            ("kDefCflSign", 10509, (9,)), ("kDefCflAlpha", 10518, (6, 17)),
            ("kDefSwitchableRestore", 6353, (4,)),
            ("kDefWienerRestore", 6357, (3,)),
            ("kDefSgrprojRestore", 6360, (3,)),
            # screen content: palette sizes, colour indices (palette sizes
            # 2-8) and modes; the transform split of an IntraBC block, its
            # flag and its transform types (inter sets 1-3)
            ("kDefPaletteYSize", 4860, (7, 8)),
            ("kDefPaletteUvSize", 4916, (7, 8)),
            ("kDefPaletteYColor", 4972, (7, 5, 9)),
            ("kDefPaletteUvColor", 5287, (7, 5, 9)),
            ("kDefPaletteYMode", 5602, (7, 3, 3)),
            ("kDefPaletteUvMode", 5665, (2, 3)),
            ("kDefTxfmSplit", 5827, (21, 3)), ("kDefIntrabc", 6242, (3,)),
            ("kDefInterExtTx", 10237, (4, 4, 17))):
        n = int(np.prod(shape))
        emit("uint16_t", name, fc[off:off + n].reshape(shape))
    assert (fc[7093:7093 + 350] == arr("default_kf_y_mode_cdf", u16)).all()
    for name, off in (("default_palette_y_color_index_cdf", 4972),
                      ("default_palette_uv_color_index_cdf", 5287),
                      ("default_inter_ext_tx_cdf", 10237)):
        a = arr(name, u16)
        assert (fc[off:off + a.size] == a).all(), name
    # the IntraBC vector's context (ndvc: joints, then per component
    # classes, class0_fp, fp, sign, class0_hp, hp, class0, bits), which
    # av1_init_mv_probs copies from default_nmv_context
    emit("uint16_t", "kDefDv", arr("default_nmv_context", u16))
    # the transform types of each set's symbols, and each set's types
    i32 = np.int32
    emit("int32_t", "kExtTxInv", arr("av1_ext_tx_inv", i32).reshape(6, 16))
    emit("int32_t", "kExtTxUsed", arr("av1_ext_tx_used", i32).reshape(6, 16))
    i16 = np.int16
    emit("int16_t", "kDcQ", np.stack([arr(f"dc_qlookup{s}_QTX", i16)
                                      for s in ("", "_10", "_12")]))
    emit("int16_t", "kAcQ", np.stack([arr(f"ac_qlookup{s}_QTX", i16)
                                      for s in ("", "_10", "_12")]))
    emit("uint8_t", "kIqm", arr("iwt_matrix_ref", np.uint8).reshape(
        15, 2, 3344), 32)
    sizes = ((4, 4), (8, 8), (16, 16), (32, 32), (4, 8), (8, 4), (8, 16),
             (16, 8), (16, 32), (32, 16), (4, 16), (16, 4), (8, 32), (32, 8))
    for kind in ("default", "mrow", "mcol"):
        for w, h in sizes:
            s = arr(f"{kind}_scan_{w}x{h}", i16).astype(int)
            emit("uint16_t", f"kScan_{kind}_{w}x{h}", s % h * w + s // h)
    emit("uint16_t", "kDrIntraDerivative", arr("dr_intra_derivative", u16))
    emit("uint8_t", "kSmWeights", arr("smooth_weights", np.uint8))
    emit("int8_t", "kFilterIntraTaps",
         arr("av1_filter_intra_taps", np.int8).reshape(5, 8, 8))
    emit("int32_t", "kCospi",
         arr("av1_cospi_arr_data", np.int32).reshape(4, 64)[2])
    emit("int32_t", "kSinpi", arr("av1_sinpi_arr_data", np.int32).reshape(
        4, 5)[2])
    # loop restoration: each set's radii and scales {r0, r1, s0, s1}, the
    # reciprocals and A's lookup; the references each tile starts from, as
    # av1_reset_loop_restoration writes them into a MACROBLOCKD (three
    # WienerInfo {vfilter[8], hfilter[8]}, then three SgrprojInfo {ep,
    # xqd[2]})
    emit("int32_t", "kSgrParams", arr("av1_sgr_params", i32).reshape(16, 4))
    emit("int32_t", "kOneByX", arr("av1_one_by_x", i32))
    emit("int32_t", "kXByXplus1", arr("av1_x_by_xplus1", i32))
    xd = ctypes.create_string_buffer(1 << 20)
    ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_int)(
        base + syms["av1_reset_loop_restoration"][0])(
            ctypes.addressof(xd), 3)
    raw = np.frombuffer(xd.raw, np.uint8)
    at = int(np.nonzero(raw)[0].min()) & ~15
    wiener = np.frombuffer(xd.raw, np.int16, 3 * 16, at).reshape(3, 2, 8)
    sgr = np.frombuffer(xd.raw, i32, 3 * 3, at + 96).reshape(3, 3)
    assert (wiener == wiener[0, 0]).all() and (sgr == sgr[0]).all()
    assert not raw[at + 96 + 36:].any()
    emit("int32_t", "kWienerTapsMid", wiener[0, 0, :3])
    emit("int32_t", "kSgrprojXqdMid", sgr[0, 1:])
    # film grain: the Gaussian sequence its templates are drawn from
    emit("int32_t", "kGaussianSequence", arr("gaussian_sequence", i32))
    head = (
        "// Tables of the AV1 intra decoder in av1.cc: the default CDFs (in "
        "the\n// inverted form 32768 - CDF, a counter slot after each; the "
        "IntraBC\n// vector's too), the transform types of each transform "
        "set, the quantizer\n// lookups at 8, 10 and 12 bits, the inverse "
        "quantizer matrices (levels\n// 0-14, luma and chroma, each transform size's "
        "block column by column),\n// the scan orders (as row-major "
        "positions), Dr_Intra_Derivative, the smooth\n// weights, the "
        "filter-intra taps, the 12-bit cosine and sine constants,\n// the "
        "loop restoration parameter sets, reciprocals and reference taps,\n"
        "// and the film grain's Gaussian sequence.\n//\n"
        "// Origin: read from libaom 3.14.1's read-only data (its default "
        "CDF\n// arrays, FRAME_CONTEXT after av1_init_mode_probs, "
        "default_nmv_context,\n// av1_ext_tx_inv/used, "
        "dc/ac_qlookup_*_QTX,\n// iwt_matrix_ref, *_scan_*, "
        "dr_intra_derivative, smooth_weights,\n// av1_filter_intra_taps, "
        "av1_cospi/sinpi_arr_data, av1_sgr_params,\n// av1_one_by_x, "
        "av1_x_by_xplus1, gaussian_sequence) and from what\n// "
        "av1_reset_loop_restoration writes, by "
        "tests/_torch_avif.py::write_tables.\n"
        "// Copyright (c) 2016, Alliance for Open Media. All rights reserved."
        "\n// This source code is subject to the terms of the BSD 2 Clause "
        "License and\n// the Alliance for Open Media Patent License 1.0.\n"
        "#pragma once\n#include <cstdint>\n\n")
    with open(out, "w") as f:
        f.write(head + "\n".join(text))



# ------------------------------------------------------------- edited files
def obus_of(payload: bytes) -> list:
    """[(header byte, body)] of an item's OBUs (each with its size field,
    no extension)."""
    out, pos = [], 0
    while pos < len(payload):
        head = payload[pos]
        size, n, shift = 0, pos + 1, 0
        while True:
            b = payload[n]
            size |= (b & 0x7F) << shift
            n, shift = n + 1, shift + 7
            if not b & 0x80:
                break
        out.append((head, payload[n:n + size]))
        pos = n + size
    return out


def obu_bytes(obus: list) -> bytes:
    out = bytearray()
    for head, body in obus:
        size, leb = len(body), bytearray()
        while True:
            b, size = size & 0x7F, size >> 7
            leb.append(b | (0x80 if size else 0))
            if not size:
                break
        out += bytes([head]) + leb + body
    return bytes(out)


def _bits(body: bytes) -> list:
    return [(body[i >> 3] >> (7 - (i & 7))) & 1 for i in range(8 * len(body))]


def _bytes(bits: list) -> bytes:
    bits = bits + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def with_superres(data: bytes) -> bytes:
    """data (a file with a reduced still-picture header and no
    screen-content tools) with superres enabled in its sequence header and
    used by its frame header; the tile data no longer lines up, so only
    the headers mean anything."""
    h = Heif(data)
    obus = []
    for head, body in obus_of(h.items[h.primary][1]):
        bits = _bits(body)
        kind = (head >> 3) & 15
        if kind == 1:
            assert bits[4] == 1, "not a reduced still-picture header"
            fwb = int("".join(map(str, bits[10:14])), 2) + 1
            fhb = int("".join(map(str, bits[14:18])), 2) + 1
            bits[18 + fwb + fhb + 3] = 1  # enable_superres
        elif kind == 6:
            assert bits[1] == 0, "screen-content tools are on"
            bits.insert(2, 1)  # use_superres
        obus.append((head, _bytes(bits)))
    h.items[h.primary][1] = obu_bytes(obus)
    return bytes(h)


def as_grid(data: bytes, rows: int = 1, columns: int = 2, size=None,
            tiles=None, idat: bool = False, wide: bool = False,
            old: bool = False) -> bytes:
    """A grid derived image (the primary item) of rows x columns tiles:
    the primary items of ``tiles`` (AVIF files, row-major; data's primary
    item in every place by default), an ImageGrid of output ``size`` (w,
    h; the tiles' whole extent by default) with 32-bit fields if ``wide``,
    in idat if ``idat``, as libavif writes one: the grid item first (its
    payload leading mdat, where cv2's signature check reads it), with
    ispe, and pixi and colr from the first tile.  Where the tile files
    have alpha items, an alpha grid of them follows, with the same
    ImageGrid.  ``old``: the layout this helper wrote before, data's
    primary item twice side by side, the grid item last and without pixi,
    which libavif's strict mode and so cv2 read as nothing."""
    h = Heif(data)
    if old:
        tile = h.primary
        ispe = h.prop(tile, b"ispe")
        w, hh = struct.unpack_from(">II", ispe, 4)
        second = max(h.items) + 1
        grid = second + 1
        h.items[second] = list(h.items[tile])
        h.assoc[second] = list(h.assoc[tile])
        h.items[grid] = [b"grid", struct.pack(">BBBBHH", 0, 0, 0, 1, 2 * w,
                                              hh), b"\0"]
        h.refs += [(b"dimg", grid, tile), (b"dimg", grid, second)]
        h.add_prop(grid, b"ispe", b"\0" * 4 + struct.pack(">II", 2 * w, hh))
        h.primary = grid
        return bytes(h)
    files = [Heif(f) for f in (tiles or [data] * (rows * columns))]
    assert len(files) == rows * columns
    tw, th = struct.unpack_from(">II", files[0].prop(files[0].primary,
                                                     b"ispe"), 4)
    w, hh = size or (columns * tw, rows * th)
    payload = struct.pack(">BBBB", 0, int(wide), rows - 1, columns - 1) + \
        struct.pack(">II" if wide else ">HH", w, hh)
    alphas = [next((s for r, s, d in f.refs if r == b"auxl"
                    and d == f.primary), None) for f in files]
    h.items, h.refs, h.props, h.assoc = {}, [], [], {}
    h.primary, n = 1, len(files)

    def add(iid, f, src):
        h.items[iid] = list(f.items[src])
        for index, essential in f.assoc.get(src, ()):
            h.add_prop(iid, *f.props[index - 1], essential)

    def add_grid(iid, first, src):
        h.items[iid] = [b"grid", payload, b"\0"]
        h.add_prop(iid, b"ispe", b"\0" * 4 + struct.pack(">II", w, hh))
        for kind in (b"pixi", b"colr", b"auxC"):
            if first.prop(src, kind) is not None:
                h.add_prop(iid, kind, first.prop(src, kind))
        if idat:
            h.in_idat.add(iid)
    add_grid(1, files[0], files[0].primary)
    for k, f in enumerate(files):
        add(2 + k, f, f.primary)
        h.refs.append((b"dimg", 1, 2 + k))
    if all(a is not None for a in alphas):
        add_grid(n + 2, files[0], alphas[0])
        h.refs.append((b"auxl", n + 2, 1))
        for k, f in enumerate(files):
            add(n + 3 + k, f, alphas[k])
            h.refs.append((b"dimg", n + 2, n + 3 + k))
    return bytes(h)


# -------------------------------------------------------------- sequences
class Track:
    """One trak of an image sequence as editable parts: its tkhd body
    (``id``, ``width`` and ``height`` read and set through it), tref
    entries [(type, [track ids])], its other boxes kept as they are (edts,
    meta; mdhd, the mdia handler type, vmhd and dinf), its sample entry
    (format, the 78-byte VisualSampleEntry head, child boxes [(type,
    body)]), the samples' data, and how its sample table lays them out:
    samples per chunk (one chunk a sample by default), one constant
    sample size, co64 offsets, the sync samples (stss; None for no box)
    and extra stbl boxes."""

    def __init__(self, data: bytes, s: int, e: int):
        self.refs, self.others, self.minf = [], [], []
        self.stbl_extra, self.stss = [], None
        self.constant_size = self.co64 = False
        for k, s2, e2 in boxes(data, s, e):
            if k == b"tkhd":
                self.tkhd = bytearray(data[s2:e2])
            elif k == b"tref":
                for k3, s3, e3 in boxes(data, s2, e2):
                    self.refs.append((k3, list(struct.unpack_from(
                        f">{(e3 - s3) // 4}I", data, s3))))
            elif k == b"mdia":
                for k3, s3, e3 in boxes(data, s2, e2):
                    if k3 == b"mdhd":
                        self.mdhd = data[s3:e3]
                    elif k3 == b"hdlr":
                        self.hdlr = bytearray(data[s3:e3])
                    elif k3 == b"minf":
                        for k4, s4, e4 in boxes(data, s3, e3):
                            if k4 == b"stbl":
                                self._stbl(data, s4, e4)
                            else:
                                self.minf.append((k4, data[s4:e4]))
            else:
                self.others.append((k, data[s2:e2]))

    def _stbl(self, data, s, e):
        t = {k: (s2, e2) for k, s2, e2 in boxes(data, s, e)}
        s2, e2 = t[b"stsd"]
        size, self.format = struct.unpack_from(">I4s", data, s2 + 8)
        self.visual = data[s2 + 16:s2 + 16 + 78]
        self.entry = [(k, data[a:b]) for k, a, b in boxes(
            data, s2 + 16 + 78, s2 + 8 + size)]
        s2, _ = t[b"stts"]
        self.stts = data[s2:t[b"stts"][1]]
        if b"stss" in t:
            s2, _ = t[b"stss"]
            n = struct.unpack_from(">I", data, s2 + 4)[0]
            self.stss = list(struct.unpack_from(f">{n}I", data, s2 + 8))
        s2, _ = t[b"stsc"]
        runs = struct.unpack_from(">I", data, s2 + 4)[0]
        runs = [struct.unpack_from(">III", data, s2 + 8 + 12 * i)
                for i in range(runs)]
        kind = b"stco" if b"stco" in t else b"co64"
        s2, _ = t[kind]
        n = struct.unpack_from(">I", data, s2 + 4)[0]
        offsets = struct.unpack_from(f">{n}{'I' if kind == b'stco' else 'Q'}",
                                     data, s2 + 8)
        s2, _ = t[b"stsz"]
        const, count = struct.unpack_from(">II", data, s2 + 4)
        sizes = [const] * count if const else list(struct.unpack_from(
            f">{count}I", data, s2 + 12))
        self.samples, self.chunks = [], []
        for c, off in enumerate(offsets):
            per = [r[1] for r in runs if r[0] <= c + 1][-1]
            self.chunks.append(per)
            for _ in range(per):
                n = sizes[len(self.samples)]
                self.samples.append(data[off:off + n])
                off += n

    def _field(self, at_v0, at_v1):
        return at_v1 if self.tkhd[0] == 1 else at_v0

    @property
    def id(self):
        return struct.unpack_from(">I", self.tkhd, self._field(12, 20))[0]

    @id.setter
    def id(self, v):
        struct.pack_into(">I", self.tkhd, self._field(12, 20), v)

    @property
    def size(self):
        w, h = struct.unpack_from(">II", self.tkhd, len(self.tkhd) - 8)
        return w >> 16, h >> 16

    @size.setter
    def size(self, wh):
        struct.pack_into(">II", self.tkhd, len(self.tkhd) - 8,
                         wh[0] << 16, wh[1] << 16)

    @property
    def handler(self):
        return bytes(self.hdlr[8:12])

    @handler.setter
    def handler(self, v):
        self.hdlr[8:12] = v

    def entry_box(self, kind):
        return next((b for k, b in self.entry if k == kind), None)

    def layout(self, base: int):
        """(the trak box, its samples' data) with that data at file offset
        base."""
        sizes = [len(x) for x in self.samples]
        offsets, pos, i = [], base, 0
        for per in self.chunks:
            offsets.append(pos)
            pos += sum(sizes[i:i + per])
            i += per
        runs = [(c + 1, per, 1) for c, per in enumerate(self.chunks)
                if not c or per != self.chunks[c - 1]]
        stsc = struct.pack(">I", len(runs)) + b"".join(
            struct.pack(">III", *r) for r in runs)
        if self.constant_size:
            stsz = struct.pack(">II", sizes[0], len(sizes))
        else:
            stsz = struct.pack(f">II{len(sizes)}I", 0, len(sizes), *sizes)
        co = struct.pack(">I", len(offsets)) + b"".join(
            struct.pack(">Q" if self.co64 else ">I", o) for o in offsets)
        entry = box(self.format, self.visual + b"".join(
            box(k, b) for k, b in self.entry))
        stbl = (full_box(b"stsd", 0, 0, struct.pack(">I", 1) + entry)
                + box(b"stts", self.stts)
                + full_box(b"stsc", 0, 0, stsc)
                + full_box(b"stsz", 0, 0, stsz)
                + full_box(b"co64" if self.co64 else b"stco", 0, 0, co))
        if self.stss is not None:
            stbl += full_box(b"stss", 0, 0, struct.pack(
                f">I{len(self.stss)}I", len(self.stss), *self.stss))
        stbl += b"".join(box(k, b) for k, b in self.stbl_extra)
        minf = b"".join(box(k, b) for k, b in self.minf) + box(b"stbl", stbl)
        mdia = (box(b"mdhd", self.mdhd) + box(b"hdlr", bytes(self.hdlr))
                + box(b"minf", minf))
        tref = b"".join(box(k, struct.pack(f">{len(ids)}I", *ids))
                        for k, ids in self.refs)
        trak = (box(b"tkhd", bytes(self.tkhd))
                + (box(b"tref", tref) if tref else b"")
                + b"".join(box(k, b) for k, b in self.others)
                + box(b"mdia", mdia))
        return box(b"trak", trak), b"".join(self.samples)


class Sequence:
    """An AVIF image sequence as editable parts: the ftyp body (``major``
    its major brand), the meta box's items (a Heif; None for a file
    without meta), mvhd and the Tracks; bytes() lays it out as its
    writers do: ftyp, meta, moov, then mdat with the items' data before
    the samples'."""

    def __init__(self, data: bytes):
        top = {k: (s, e) for k, s, e in boxes(data)}
        s, e = top[b"ftyp"]
        self.ftyp = data[s:e]
        self.heif = Heif(data) if b"meta" in top else None
        self.tracks, self.mvhd = [], b""
        for k, s, e in boxes(data, *top[b"moov"]):
            if k == b"mvhd":
                self.mvhd = data[s:e]
            elif k == b"trak":
                self.tracks.append(Track(data, s, e))

    @property
    def major(self):
        return self.ftyp[:4]

    @major.setter
    def major(self, brand):
        self.ftyp = brand + self.ftyp[4:]

    def moov(self, base: int):
        traks, samples = b"", b""
        for t in self.tracks:
            trak, d = t.layout(base + len(samples))
            traks += trak
            samples += d
        return box(b"moov", box(b"mvhd", self.mvhd) + traks), samples

    def __bytes__(self):
        if self.heif is not None:
            self.heif.ftyp = self.ftyp
            return self.heif.layout(self.moov)
        ftyp = box(b"ftyp", self.ftyp)
        start = len(ftyp) + len(self.moov(0)[0]) + 8
        moov, samples = self.moov(start)
        return ftyp + moov + box(b"mdat", samples)


def pil_sequence(frames, **kw) -> bytes:
    """Pillow's AVIF image sequence of RGB or RGBA uint8 frames (an RGBA
    one with an alpha track); kw as Image.save takes them."""
    from PIL import Image

    b = io.BytesIO()
    ims = [Image.fromarray(np.ascontiguousarray(f)) for f in frames]
    ims[0].save(b, "AVIF", save_all=True, append_images=ims[1:], **kw)
    return b.getvalue()


def cv2_sequence(frames, depth=None, quality=None) -> bytes:
    """cv2.imencodemulti('.avif') of BGR or grey frames (uint16 samples
    for depth 10 or 12): an image sequence."""
    import cv2

    params = []
    for key, v in ((cv2.IMWRITE_AVIF_DEPTH, depth),
                   (cv2.IMWRITE_AVIF_QUALITY, quality)):
        if v is not None:
            params += [key, v]
    ok, buf = cv2.imencodemulti(".avif", list(frames), params)
    assert ok
    return buf.tobytes()


def with_exif(data: bytes, orientation: int, offset: int = 0) -> bytes:
    """data with an Exif item (TIFF of the given orientation after a
    4-byte header offset, and ``offset`` bytes of an "Exif" prefix) that
    describes the primary item."""
    tiff = (b"MM\0*" + struct.pack(">IH", 8, 1)
            + struct.pack(">HHII", 0x0112, 3, 1, orientation << 16)
            + b"\0" * 4)
    h = Heif(data)
    iid = max(h.items) + 1
    prefix = b"Exif\0\0"[:offset]
    h.items[iid] = [b"Exif", struct.pack(">I", offset) + prefix + tiff, b"\0"]
    h.refs.append((b"cdsc", iid, h.primary))
    return bytes(h)


if __name__ == "__main__":
    if sys.argv[1:2] == ["tables"] and len(sys.argv) == 3:
        write_tables(sys.argv[2])
    else:
        sys.exit(__doc__)
