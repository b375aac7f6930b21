"""AVIF frames through the port's reader (data/image_formats.py's HEIF
parser, native/av1.cc's AV1 decoder and colour conversion) against
``cv2.imread`` (OpenCV 5, libavif 1.4 with libaom 3.14) and, before the
colour conversion, the decoded planes against libaom's (bundled beside
cv2, loaded with ctypes). Every expected array is cv2's or libaom's reading
of the file, never a writer's input."""

import ctypes
import os

import cv2
import numpy as np
import pytest

from tests import _torch_avif as A
from transhuman_tpu_torch.data import image_formats, image_io

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "torch_zju", "cv2_q95_420.jpg")
_BGR = None


def bgr(h, w, seed):
    """An (h, w) crop of the committed 1024x1024 fixture's decode (BGR)."""
    global _BGR
    if _BGR is None:
        _BGR = cv2.imread(SOURCE)
    rng = np.random.default_rng(seed)
    y, x = int(rng.integers(0, 1024 - h)), int(rng.integers(0, 1024 - w))
    return np.ascontiguousarray(_BGR[y:y + h, x:x + w])


def deep(img, depth):
    return img.astype(np.uint16) << (depth - 8)


def _grey(img):
    return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)


def _alpha(img, seed):
    a = np.random.default_rng(seed).integers(0, 256, img.shape[:2], np.uint8)
    return np.dstack([img, a])


def _pil(img, **kw):
    return A.pil_avif(img[..., ::-1], **kw)


def _edit(data, fn):
    h = A.Heif(data)
    fn(h)
    return bytes(h)


# name -> file: the writers' variants (the Motivation table), and the
# properties libavif reads but cv2 does not apply
VARIANTS = {
    "cv2_default": lambda: A.cv2_avif(bgr(72, 96, 1)),
    "cv2_q50": lambda: A.cv2_avif(bgr(61, 83, 2), quality=50),
    "cv2_q95": lambda: A.cv2_avif(bgr(72, 96, 3), quality=95),
    "cv2_q100_lossless": lambda: A.cv2_avif(bgr(45, 70, 4), quality=100),
    "cv2_10bit": lambda: A.cv2_avif(deep(bgr(71, 89, 5), 10), depth=10),
    "cv2_12bit": lambda: A.cv2_avif(deep(bgr(71, 89, 6), 12), depth=12),
    "cv2_10bit_lossless": lambda: A.cv2_avif(deep(bgr(33, 40, 7), 10),
                                             depth=10, quality=100),
    "cv2_grey": lambda: A.cv2_avif(_grey(bgr(72, 96, 8))),
    "cv2_grey_12bit": lambda: A.cv2_avif(deep(_grey(bgr(50, 66, 9)), 12),
                                         depth=12),
    "cv2_bgra": lambda: A.cv2_avif(_alpha(bgr(72, 96, 10), 10)),
    "pil_420": lambda: _pil(bgr(72, 96, 11)),
    "pil_422": lambda: _pil(bgr(72, 96, 12), subsampling="4:2:2"),
    "pil_444": lambda: _pil(bgr(72, 96, 13), subsampling="4:4:4"),
    "pil_400": lambda: _pil(bgr(72, 96, 14), subsampling="4:0:0"),
    "pil_rgba": lambda: _pil(_alpha(bgr(72, 96, 15), 15)),
    "pil_irot_exif_6": lambda: _pil(bgr(72, 96, 16), exif=_exif6()),
    "pil_limited_range": lambda: _pil(bgr(57, 77, 17), range="limited"),
    "pil_sb128_tiles": lambda: _pil(
        bgr(150, 270, 18), speed=8, tile_rows=1, tile_cols=1,
        advanced={"sb-size": "128"}),
    "pil_qm_deltaq_segments": lambda: _pil(
        bgr(96, 112, 19), quality=40, speed=6,
        advanced={"enable-qm": "1", "qm-min": "2", "qm-max": "10",
                  "deltaq-mode": "1", "aq-mode": "1"}),
    "pil_reduced_tx_set_sharpness": lambda: _pil(
        bgr(80, 64, 20), quality=35, speed=7,
        advanced={"reduced-tx-type-set": "1", "sharpness": "3"}),
    "pil_tx64": lambda: _pil(bgr(128, 128, 21), quality=42, speed=5,
                             subsampling="4:4:4"),
    "imir_essential": lambda: _edit(A.cv2_avif(bgr(40, 56, 22)), lambda h: (
        h.add_prop(h.primary, b"imir", b"\x01", 1))),
    "clap_essential": lambda: _edit(A.cv2_avif(bgr(40, 56, 23)), lambda h: (
        h.add_prop(h.primary, b"clap", bytes(range(32)), 1))),
    "exif_item_orientation_6": lambda: A.with_exif(
        A.cv2_avif(bgr(40, 56, 24)), 6),
    "exif_item_after_exif_prefix": lambda: A.with_exif(
        A.cv2_avif(bgr(40, 56, 25)), 6, offset=6),
    "ycgco_full": lambda: A.set_nclx(_pil(bgr(40, 56, 26)), mc=8, full=1),
}

# loop restoration as libaom's encoder picks it (at speed 0-4 and a high
# quality): name -> (file, restoration type of each plane (1 Wiener, 2
# self-guided), unit size, whether a plane's last unit is enlarged past the
# unit size). libaom switches between unit types only where a plane has
# several units (COMMITTED_TOOLS' files), leaves lr_uv_shift 0 and clears
# enable_restoration in a 12-bit file's sequence header.
LR_VARIANTS = {
    "pil_lr_s0_444": (lambda: _pil(bgr(64, 64, 40), quality=97, speed=0,
                                   subsampling="4:4:4"), (0, 2, 2), 256,
                      False),
    "pil_lr_s1_420": (lambda: _pil(bgr(150, 150, 102), quality=75, speed=1),
                      (2, 2, 2), 128, True),
    "pil_lr_s3_420": (lambda: _pil(bgr(150, 150, 100), quality=85, speed=3),
                      (2, 2, 2), 128, True),
    "pil_lr_s4_422": (lambda: _pil(bgr(150, 140, 7), quality=80, speed=4,
                                   subsampling="4:2:2"), (2, 1, 0), 128,
                      True),
    "pil_lr_s4_400": (lambda: _pil(bgr(150, 140, 7), quality=80, speed=4,
                                   subsampling="4:0:0"), (2,), 128, True),
    "pil_lr_sb128": (lambda: _pil(bgr(150, 150, 8), quality=95, speed=4,
                                  advanced={"sb-size": "128"}), (0, 1, 1),
                     128, False),
    "pil_lr_tiles_2x2": (lambda: _pil(bgr(150, 150, 9), quality=85, speed=1,
                                      tile_rows=1, tile_cols=1), (2, 0, 1),
                         128, True),
    "cv2_lr_10bit": (lambda: A.cv2_avif(deep(bgr(150, 140, 10), 10),
                                        depth=10, speed=2, quality=90),
                     (1, 2, 2), 128, True),
    "cv2_lr_10bit_grey": (lambda: A.cv2_avif(
        deep(_grey(bgr(150, 140, 11)), 10), depth=10, speed=4, quality=80),
        (2,), 128, True),
}
# film grain: each of libaom's test vectors on an odd-sized 4:2:0 frame,
# and one vector at the other subsamplings (Pillow writes 8 bits only)
GRAIN_VARIANTS = {
    f"pil_grain_v{v:02d}": lambda v=v: _pil(
        bgr(61, 63, 100 + v), quality=60, speed=6,
        advanced={"film-grain-test": str(v)}) for v in range(1, 17)}
GRAIN_VARIANTS.update({
    f"pil_grain_{sub.replace(':', '')}": lambda sub=sub: _pil(
        bgr(61, 63, 80), quality=60, speed=6, subsampling=sub,
        advanced={"film-grain-test": "3"})
    for sub in ("4:2:2", "4:4:4", "4:0:0")})
VARIANTS.update({k: v[0] for k, v in LR_VARIANTS.items()})
VARIANTS.update(GRAIN_VARIANTS)


def _exif6():
    from PIL import Image

    ex = Image.Exif()
    ex[0x0112] = 6
    return ex.tobytes()


_FILES = {}


def variant(name) -> bytes:
    if name not in _FILES:
        _FILES[name] = VARIANTS[name]()
    return _FILES[name]


def cv2_imread(path):
    img = cv2.imread(str(path))
    return None if img is None else np.ascontiguousarray(img[..., ::-1])


def _same(got, want, what=""):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    diff = got.astype(np.int32) - want
    assert not diff.any(), (what, int(np.abs(diff).max()),
                            int((diff != 0).sum()))


def _read_both(tmp_path, name, data):
    p = tmp_path / f"{name}.avif"
    p.write_bytes(data)
    return cv2_imread(p), p


def port_planes(obus):
    """The port's decoded planes of an AV1 payload (before conversion)."""
    planes, _ = image_formats._av1_planes(obus)
    return planes


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_each_variant_reads_as_cv2_imread(name, tmp_path):
    want, p = _read_both(tmp_path, name, variant(name))
    assert want is not None, name
    _same(image_io.imread_rgb(str(p)), want, name)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_each_variant_decodes_to_libaom_planes(name):
    data = variant(name)
    h = A.Heif(data)
    items = [h.primary] + [s for r, s, d in h.refs if r == b"auxl"]
    for item in items:
        obus = h.items[item][1]
        want = A.libaom_planes(obus)
        got = port_planes(obus)
        assert len(got) == len(want), (name, item)
        for p, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape and (g == w).all(), (
                name, item, p, int((g != w).sum()))


def _meta(obus):
    """The decoder's meta of an AV1 payload: (restoration type of each
    plane, unit size of each, unit types read in each (bit 1 << type),
    film grain applied), as thc_av1_decode writes them."""
    _, meta = image_formats._av1_planes(obus)
    return (tuple(int(v) for v in meta[10:13]),
            tuple(int(v) for v in meta[13:16]),
            tuple(int(v) for v in meta[16:19]), int(meta[19]), meta)


@pytest.mark.parametrize("name", sorted([*LR_VARIANTS, *GRAIN_VARIANTS]))
def test_each_tool_variant_carries_its_tool(name):
    """The decoder's meta shows the loop restoration or the film grain a
    variant is there for."""
    types, sizes, read, grain, meta = _meta(A.primary_obus(variant(name)))
    if name in GRAIN_VARIANTS:
        assert grain == 1 and types == (0, 0, 0), (name, types, grain)
        return
    _, want, unit, enlarged = LR_VARIANTS[name]
    n = len(want)
    assert types[:n] == want and not grain, (name, types, grain)
    # each plane reads units of its own type only (every unit is one)
    assert read[:n] == tuple(1 << t if t else 0 for t in want), (name, read)
    w, h, mono, sx, sy = (int(v) for v in (meta[0], meta[1], meta[3],
                                           meta[4], meta[5]))
    assert sizes[0] == unit and sizes[1:] == ((0, 0) if mono else (unit,) * 2)
    longest = 0
    for p, t in enumerate(want):
        if t:
            for side in ((w + sx) >> sx if p else w, (h + sy) >> sy if p
                         else h):
                count = max((side + unit // 2) // unit, 1)
                longest = max(longest, side - (count - 1) * unit)
    assert (longest > unit) == enlarged, (name, longest, unit)


# the committed fixtures of phase e with loop restoration or film grain
# (tests/test_torch_formats.py makes them): (restoration type of each
# plane (3 switchable), unit types read in each (bit 1 << type), grain)
FORMAT_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "fixtures", "torch_zju_formats")
COMMITTED_TOOLS = {
    # none, Wiener and self-guided units in a switchable luma plane
    "avif_pil_lr_switchable.avif": ((3, 1, 1), (7, 2, 2), 0),
    # Wiener and self-guided units in a switchable chroma plane
    "pil_lr_1024.avif": ((0, 3, 1), (0, 6, 2), 0),
    "avif_pil_film_grain.avif": ((0, 0, 0), (0, 0, 0), 1),
    "pil_grain_1024.avif": ((0, 0, 0), (0, 0, 0), 1),
}


@pytest.mark.parametrize("name", sorted(COMMITTED_TOOLS))
def test_committed_tool_fixtures_carry_their_tools(name):
    path = os.path.join(FORMAT_FIXTURES, name)
    with open(path, "rb") as f:
        obus = A.primary_obus(f.read())
    types, _, read, grain, _ = _meta(obus)
    assert (types, read, grain) == COMMITTED_TOOLS[name], (types, read, grain)
    for p, (g, w) in enumerate(zip(port_planes(obus), A.libaom_planes(obus))):
        assert g.shape == w.shape and (g == w).all(), (name, p)
    _same(image_io.imread_rgb(path), cv2_imread(path), name)


def test_tool_cases_cover_the_slice():
    """Between them the variants and the committed fixtures hold Wiener,
    self-guided and switchable planes, no-filter units in a switchable
    plane, an enlarged last unit, 64 and 128 superblocks, every
    subsampling, 8 and 10 bits, and all 16 film grain test vectors."""
    types = {t for _, ts, _, _ in LR_VARIANTS.values() for t in ts}
    types |= {t for ts, _, _ in COMMITTED_TOOLS.values() for t in ts}
    assert {1, 2, 3} <= types
    assert any(t == 3 and m & 1 for ts, ms, _ in COMMITTED_TOOLS.values()
               for t, m in zip(ts, ms))
    assert any(v[3] for v in LR_VARIANTS.values())
    names = " ".join(LR_VARIANTS)
    for part in ("444", "420", "422", "400", "sb128", "tiles", "10bit",
                 "s0", "s1", "s3", "s4"):
        assert part in names, part
    assert {f"pil_grain_v{v:02d}" for v in range(1, 17)} <= set(
        GRAIN_VARIANTS)


# ---------------------------------------------------- the seeded sweep
def sweep_file(seed: int) -> bytes:
    """A file of random size, quality, speed, subsampling, depth, tiles
    and superblock size (seeded): Pillow's 8-bit files at even seeds,
    cv2's 8-, 10- and 12-bit ones at odd seeds; from seed 36 at speeds
    0-4 and qualities 70-100, where libaom picks loop restoration."""
    rng = np.random.default_rng(1000 + seed)
    h, w = int(rng.integers(9, 140)), int(rng.integers(9, 140))
    img = bgr(h, w, 2000 + seed)
    if seed < 36:
        q, speed = int(rng.integers(0, 101)), int(rng.integers(2, 11))
    else:
        q, speed = int(rng.integers(70, 101)), int(rng.integers(0, 5))
    if seed % 2:
        depth = int(rng.choice([8, 10, 12]))
        return A.cv2_avif(img if depth == 8 else deep(img, depth),
                          quality=q, speed=speed, depth=depth)
    adv = {}
    if rng.random() < 0.4:
        adv["sb-size"] = "128"
    if rng.random() < 0.3:
        adv.update({"enable-qm": "1", "qm-min": str(int(rng.integers(0, 8))),
                    "qm-max": str(int(rng.integers(8, 16)))})
    if rng.random() < 0.3:
        adv["deltaq-mode"] = "1"
    kw = dict(quality=q, speed=speed,
              subsampling=["4:2:0", "4:2:2", "4:4:4", "4:0:0"][
                  int(rng.integers(4))],
              tile_rows=int(rng.integers(0, 2)),
              tile_cols=int(rng.integers(0, 2)))
    if rng.random() < 0.25:
        kw["range"] = "limited"
    if adv:
        kw["advanced"] = adv
    return _pil(img, **kw)


@pytest.mark.parametrize("chunk", range(5))
def test_seeded_files_read_as_cv2_and_decode_as_libaom(chunk, tmp_path):
    """Every seeded file decodes (none is refused) as cv2 and libaom read
    it."""
    for seed in range(chunk * 9, chunk * 9 + 9):
        data = sweep_file(seed)
        want, p = _read_both(tmp_path, f"sweep_{seed}", data)
        assert want is not None, seed
        _same(image_io.imread_rgb(str(p)), want, f"seed {seed}")
        obus = A.primary_obus(data)
        for g, w in zip(port_planes(obus), A.libaom_planes(obus)):
            assert (g == w).all(), seed


# ------------------------------------------- conversions on known planes
def _libyuv():
    import glob

    found = glob.glob(os.path.join(A._libs_dir(), "libavif-*.so*"))
    assert found, "libavif is not beside cv2"
    return ctypes.CDLL(found[0])


def _to_rgb(planes, params):
    out = np.empty((params[1], params[0], 3), np.uint8)
    p = np.asarray(params, np.int32)
    y = np.ascontiguousarray(planes[0], np.uint16)
    u = np.ascontiguousarray(planes[1], np.uint16)
    v = np.ascontiguousarray(planes[2], np.uint16)
    from transhuman_tpu_torch.native import build as codec

    codec.call("thc_avif_to_rgb", y.ctypes.data, u.ctypes.data, v.ctypes.data,
               p.ctypes.data, out.ctypes.data, what="planes", lib="av1")
    return out


# libyuv's constants libavif picks: (matrix, full range) -> name
LIBYUV = {(6, 1): "kYuvJPEGConstants", (6, 0): "kYuvI601Constants",
          (1, 1): "kYuvF709Constants", (1, 0): "kYuvH709Constants",
          (9, 1): "kYuvV2020Constants", (9, 0): "kYuv2020Constants"}


@pytest.mark.parametrize("key", sorted(LIBYUV))
def test_every_triple_converts_as_libyuv_converts_it(key):
    """Every 8-bit (Y, U, V) triple of a 4096x4096 4:4:4 frame through the
    port's conversion against libyuv's I444ToARGBMatrix (cv2's libavif),
    with the constants libavif takes for the matrix and range."""
    mc, full = key
    v = np.arange(1 << 24, dtype=np.uint32)
    y = (v >> 16).astype(np.uint16).reshape(4096, 4096)
    u = ((v >> 8) & 255).astype(np.uint16).reshape(4096, 4096)
    vv = (v & 255).astype(np.uint16).reshape(4096, 4096)
    got = _to_rgb((y, u, vv), (4096, 4096, 8, 0, 0, 0, 2, mc, full))
    lib = _libyuv()
    want = np.empty((4096, 4096, 4), np.uint8)
    y8, u8, v8 = (a.astype(np.uint8) for a in (y, u, vv))
    const = ctypes.addressof(ctypes.c_char.in_dll(lib, LIBYUV[key]))
    P, I = ctypes.c_void_p, ctypes.c_int
    assert lib.I444ToARGBMatrix(
        P(y8.ctypes.data), I(4096), P(u8.ctypes.data), I(4096),
        P(v8.ctypes.data), I(4096), P(want.ctypes.data), I(4096 * 4),
        P(const), I(4096), I(4096)) == 0
    _same(got, np.ascontiguousarray(want[..., 2::-1]), str(key))


@pytest.mark.parametrize("fmt", ["420", "422"])
def test_chroma_upsampling_as_libyuv_filters_it(fmt):
    """4:2:0 (bilinear) and 4:2:2 (linear) chroma of odd and even sizes,
    every value, against libyuv's I420/I422ToARGBMatrixFilter."""
    lib = _libyuv()
    rng = np.random.default_rng(int(fmt))
    P, I = ctypes.c_void_p, ctypes.c_int
    const = ctypes.addressof(ctypes.c_char.in_dll(lib, "kYuvJPEGConstants"))
    for h, w in ((1, 1), (2, 3), (7, 5), (64, 255), (257, 256)):
        sy = fmt == "420"
        ch, cw = (h + sy) >> sy, (w + 1) >> 1
        y = rng.integers(0, 256, (h, w)).astype(np.uint8)
        u = rng.integers(0, 256, (ch, cw)).astype(np.uint8)
        v = rng.integers(0, 256, (ch, cw)).astype(np.uint8)
        got = _to_rgb([a.astype(np.uint16) for a in (y, u, v)],
                      (w, h, 8, 0, 1, int(sy), 2, 6, 1))
        want = np.empty((h, w, 4), np.uint8)
        fn = lib.I420ToARGBMatrixFilter if sy else lib.I422ToARGBMatrixFilter
        assert fn(P(y.ctypes.data), I(w), P(u.ctypes.data), I(cw),
                  P(v.ctypes.data), I(cw), P(want.ctypes.data), I(w * 4),
                  P(const), I(w), I(h), I(2 if sy else 1)) == 0
        _same(got, np.ascontiguousarray(want[..., 2::-1]), (fmt, h, w))


def _lossless(depth, fmt):
    """A lossless file whose planes hold every value of each channel:
    cv2's identity 4:4:4 (its Y, U, V are the G, B, R written), Pillow's
    4:2:0 and 4:2:2 at quality 100, cv2's grey."""
    n = 1 << depth
    side = 64 if depth == 8 else 128
    i = np.arange(side * side)
    rng = np.random.default_rng(depth)
    img = np.stack([i % n, (i * 7 + 3) % n, rng.permutation(i) % n],
                   -1).reshape(side, side, 3)
    if fmt == "444":
        return A.cv2_avif(img.astype(np.uint16 if depth > 8 else np.uint8),
                          quality=100, depth=depth)
    if fmt == "400":
        g = np.ascontiguousarray(img[..., 0])
        return A.cv2_avif(g.astype(np.uint16 if depth > 8 else np.uint8),
                          quality=100, depth=depth)
    return A.pil_avif(img.astype(np.uint8), quality=100,
                      subsampling=f"4:{fmt[1]}:{fmt[2]}")


FORMATS = [(8, "444"), (8, "420"), (8, "422"), (8, "400"), (10, "444"),
           (12, "444"), (10, "400")]
MATRICES = (0, 1, 2, 4, 5, 6, 7, 8, 9, 12)


@pytest.mark.parametrize("depth,fmt", FORMATS)
def test_every_matrix_and_range_read_as_cv2(depth, fmt, tmp_path):
    """The same lossless payload under a colr nclx box rewritten to each
    matrix (identity, BT.709, unspecified, FCC, BT.470BG, BT.601, SMPTE
    240M, YCgCo, BT.2020 NCL, chroma-derived NCL) and range: the port reads
    what cv2 reads, or refuses by name what cv2 reads as nothing (identity
    of subsampled chroma, limited-range YCgCo)."""
    data = _lossless(depth, fmt)
    for mc in MATRICES:
        for full in (1, 0):
            name = f"m{mc}_f{full}"
            want, p = _read_both(tmp_path, name, A.set_nclx(
                data, cp=1, mc=mc, full=full))
            if want is None:
                with pytest.raises(FileNotFoundError, match=name):
                    image_io.imread_rgb(str(p))
            else:
                _same(image_io.imread_rgb(str(p)), want, name)


# ------------------------------------------------------------ refusals
def _refused():
    img = bgr(64, 64, 40)
    return {
        # (file, what the error names, cv2 reads it as nothing)
        "superres": (lambda: A.with_superres(A.cv2_avif(img)), "superres",
                     True),
    }


REFUSED = _refused()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_tools_name_the_path_and_the_tool(name, tmp_path):
    make, what, cv2_none = REFUSED[name]
    want, p = _read_both(tmp_path, name, make())
    assert (want is None) == cv2_none, name
    with pytest.raises(FileNotFoundError, match=f"{name}.avif.*{what}"):
        image_io.imread_rgb(str(p))


def _rejected():
    img = bgr(48, 64, 41)
    base = A.cv2_avif(img)
    alpha = A.cv2_avif(_alpha(img, 41))

    def alpha_item(h, data):
        aid = [s for r, s, d in h.refs if r == b"auxl"][0]
        h.items[aid][1] = data(h.items[aid][1])

    cases = {
        f"not_essential_{k}": lambda k=k, b=b: _edit(base, lambda h: (
            h.add_prop(h.primary, k.encode(), b, 0)))
        for k, b in (("irot", b"\x01"), ("imir", b"\x00"),
                     ("clap", bytes(32)), ("a1op", b"\x00"))}
    cases.update({
        "no_ispe": lambda: _edit(base, lambda h: h.drop_prop(h.primary,
                                                             b"ispe")),
        "no_av1C": lambda: _edit(base, lambda h: h.drop_prop(h.primary,
                                                             b"av1C")),
        "unknown_essential_property": lambda: _edit(base, lambda h: (
            h.add_prop(h.primary, b"xyzw", b"abc", 1))),
        "two_nclx": lambda: _edit(base, lambda h: h.add_prop(
            h.primary, b"colr", b"nclx" + bytes([0, 1, 0, 1, 0, 1, 0]))),
        "alpha_cut": lambda: _edit(alpha, lambda h: alpha_item(
            h, lambda d: d[:len(d) // 2])),
        "alpha_not_av1": lambda: _edit(alpha, lambda h: alpha_item(
            h, lambda d: b"\x12\x00" + bytes(40))),
        **{f"cut_{k}": lambda k=k: base[:len(base) * k // 100]
           for k in (5, 30, 60, 90, 99)},
    })
    return cases


REJECTED = _rejected()


@pytest.mark.parametrize("name", sorted(REJECTED))
def test_what_libavif_rejects_reads_as_nothing(name, tmp_path):
    """cv2.imread reads nothing of these (libavif fails them); the port
    raises FileNotFoundError naming the path."""
    want, p = _read_both(tmp_path, name, REJECTED[name]())
    assert want is None, name
    with pytest.raises(FileNotFoundError, match=f"{name}.avif"):
        image_io.imread_rgb(str(p))
