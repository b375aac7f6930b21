"""AVIF grid images, an ispe other than the frame's size, the matrix
coefficients libavif converts in float32 (chroma-derived NCL of any
primaries, and 15), cv2's signature check, and AVIF decodes on several
threads, through the port's reader (data/image_formats.py, native/av1.cc)
against ``cv2.imread`` (OpenCV 5, libavif 1.4 with libaom 3.14) bit for
bit; before the conversion, the joined planes against libaom's (bundled
beside cv2) and the scaled ones against libyuv's ScalePlane (in cv2's
libavif). Every expected array is cv2's, libaom's or libyuv's, never a
writer's input."""

import ctypes
import glob
import os
import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from tests import _torch_avif as A
from tests.test_torch_avif import (_alpha, _grey, _lossless, _pil, _same,
                                   bgr, cv2_imread, deep)
from transhuman_tpu_torch.data import image_formats, image_io


def _read_both(tmp_path, name, data):
    p = tmp_path / f"{name}.avif"
    p.write_bytes(data)
    return cv2_imread(p), p


def _with_ispe(data, w, h):
    x = A.Heif(data)
    x.set_prop(x.primary, b"ispe", b"\0" * 4 + struct.pack(">II", w, h))
    return bytes(x)


def _edit(data, fn):
    h = A.Heif(data)
    fn(h)
    return bytes(h)


def _tile(seed, size=64, depth=8, sub=None, grey=False):
    img = bgr(size, size, seed)
    if grey:
        img = _grey(img)
    if sub:
        return _pil(img, subsampling=sub)
    if depth > 8:
        return A.cv2_avif(deep(img, depth), depth=depth)
    return A.cv2_avif(img)


def _tiles(n, seed=0, **kw):
    return [_tile(seed + k, **kw) for k in range(n)]


def _planes_of(data):
    """The port's planes of data's primary item, before the conversion."""
    heif = image_formats._Heif(data)
    planes, _ = image_formats._image(heif, heif.primary)
    return planes


# ----------------------------------------------------------------- grids
# name -> (tile files, rows, columns, ImageGrid size or None, as_grid
# options, whether the tiles' planes join as they are (no ispe scaling))
def _grids():
    t = _tiles(6, 20)
    scaled = [_with_ispe(f, 64, 64) for f in _tiles(4, 60, size=128)]
    scaled10 = [_with_ispe(f, 64, 64) for f in _tiles(2, 64, size=96,
                                                      depth=10)]
    return {
        "1x2": (t[:2], 1, 2, None, {}, True),
        "2x1": (t[:2], 2, 1, None, {}, True),
        "2x2": (t[:4], 2, 2, None, {}, True),
        "3x2": (t, 3, 2, None, {}, True),
        "pil_420_2x2": (_tiles(4, 30, sub="4:2:0"), 2, 2, None, {}, True),
        "pil_422_2x2": (_tiles(4, 34, sub="4:2:2"), 2, 2, None, {}, True),
        "pil_444_1x2": (_tiles(2, 38, sub="4:4:4"), 1, 2, None, {}, True),
        "grey_2x1_idat": (_tiles(2, 40, grey=True), 2, 1, None,
                          {"idat": True}, True),
        "10bit_2x2": (_tiles(4, 42, depth=10), 2, 2, None, {}, True),
        "crop_2x2": (t[:4], 2, 2, (100, 90), {}, True),
        "crop_3x2_444": (_tiles(6, 46, sub="4:4:4"), 3, 2, (101, 151), {},
                         True),
        "idat": (t[:4], 2, 2, None, {"idat": True}, True),
        "wide_fields": (t[:4], 2, 2, None, {"wide": True}, True),
        "wide_fields_idat_crop": (t[:4], 2, 2, (128, 66),
                                  {"wide": True, "idat": True}, True),
        "alpha_2x2": ([A.cv2_avif(_alpha(bgr(64, 64, 50 + k), k))
                       for k in range(4)], 2, 2, None, {}, True),
        "ispe_scaled_tiles_crop": (scaled, 2, 2, (120, 100), {}, False),
        "ispe_scaled_tiles_10bit": (scaled10, 1, 2, None, {}, False),
    }


GRIDS = _grids()


def _grid(name):
    tiles, rows, cols, size, kw, _ = GRIDS[name]
    return A.as_grid(tiles[0], rows, cols, size=size, tiles=tiles, **kw)


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_grids_read_as_cv2_imread(name, tmp_path):
    """Each grid reads as cv2 reads it; its planes are libaom's of its
    tiles, joined row-major and cropped to the grid's output size (for
    tiles scaled to their ispe, each tile's planes are libaom's)."""
    data = _grid(name)
    want, p = _read_both(tmp_path, name, data)
    assert want is not None, name
    _same(image_io.imread_rgb(str(p)), want, name)
    tiles, rows, cols, size, _, joined = GRIDS[name]
    decoded = [A.libaom_planes(A.primary_obus(f)) for f in tiles]
    for f, planes in zip(tiles, decoded):
        got, _ = image_formats._av1_planes(A.primary_obus(f))
        assert all((g == w).all() for g, w in zip(got, planes)), name
    if joined:
        w, h = size or (want.shape[1], want.shape[0])
        sx = sy = 0
        if len(decoded[0]) == 3:
            sx = int(decoded[0][1].shape[1] < decoded[0][0].shape[1])
            sy = int(decoded[0][1].shape[0] < decoded[0][0].shape[0])
        for i, got in enumerate(_planes_of(data)):
            ssx, ssy = (sx, sy) if i else (0, 0)
            whole = np.block([[decoded[r * cols + c][i] for c in range(cols)]
                              for r in range(rows)])
            assert (got == whole[:(h + ssy) >> ssy, :(w + ssx) >> ssx]
                    ).all(), (name, i)


def test_grid_joins_planes_before_one_conversion(tmp_path):
    """A 1x2 grid of one tile twice: each half differs from the lone
    tile's read at the seam (the conversion's chroma upsampling crosses
    it), and equals cv2's read of the grid."""
    tile = _tile(70)
    lone, _ = _read_both(tmp_path, "lone", tile)
    data = A.as_grid(tile, 1, 2)
    want, p = _read_both(tmp_path, "twice", data)
    got = image_io.imread_rgb(str(p))
    _same(got, want, "twice")
    assert (got[:, :64] != lone).any() and (got[:, 64:] != lone).any()


def test_grid_exif_orientation_turns_the_joined_image(tmp_path):
    data = A.with_exif(A.as_grid(_tile(72), 1, 2, tiles=_tiles(2, 72)), 6)
    want, p = _read_both(tmp_path, "grid_exif_6", data)
    assert want is not None and want.shape == (128, 64, 3)
    _same(image_io.imread_rgb(str(p)), want, "grid_exif_6")


def _grid_rejected():
    t = _tiles(4, 80)

    def level(h):  # the second tile's av1C with another seq_level_idx
        body = bytearray(h.prop(3, b"av1C"))
        body[1] ^= 1
        h.set_prop(3, b"av1C", bytes(body))

    def payload(fn):
        def edit(h):
            h.items[1][1] = fn(h.items[1][1])
        return lambda: _edit(A.as_grid(t[0], 2, 2, tiles=t), edit)

    def alpha_cut(h):
        tile = max(h.items)
        h.items[tile][1] = h.items[tile][1][:len(h.items[tile][1]) // 2]

    return {
        # the layout as_grid wrote before: the grid item last, after its
        # tiles' data, where cv2's signature check cannot reach it
        "old_layout": lambda: A.as_grid(t[0], old=True),
        "tiles_of_different_depths": lambda: A.as_grid(
            t[0], 1, 2, tiles=[t[0], _tile(81, depth=10)]),
        "tiles_whose_av1C_fields_differ": lambda: _edit(
            A.as_grid(t[0], 1, 2, tiles=t[:2]), level),
        "tiles_of_different_sizes": lambda: A.as_grid(
            t[0], 1, 2, tiles=[t[0], _tile(82, size=80)], size=(128, 64)),
        "three_dimg_references_for_four_tiles": lambda: _edit(
            A.as_grid(t[0], 2, 2, tiles=t), lambda h: h.refs.pop()),
        "odd_width_of_420": lambda: A.as_grid(t[0], 2, 2, tiles=t,
                                              size=(101, 90)),
        "tiles_short_of_the_output": lambda: A.as_grid(t[0], 2, 2, tiles=t,
                                                       size=(130, 90)),
        "tiles_past_the_output": lambda: A.as_grid(t[0], 2, 2, tiles=t,
                                                   size=(64, 90)),
        "tiles_below_64": lambda: A.as_grid(_tile(83, size=48), 1, 2,
                                            tiles=_tiles(2, 83, size=48)),
        "ispe_not_the_output_size": lambda: _edit(
            A.as_grid(t[0], 2, 2, tiles=t), lambda h: h.set_prop(
                1, b"ispe", b"\0" * 4 + struct.pack(">II", 120, 100))),
        "imagegrid_version_1": payload(lambda b: b"\1" + b[1:]),
        "imagegrid_trailing_byte": payload(lambda b: b + b"\0"),
        "imagegrid_of_zero_width": payload(lambda b: b[:4] + b"\0\0" + b[6:]),
        "tiles_with_superres": lambda: A.as_grid(
            A.with_superres(t[0]), 1, 2),
        "alpha_grid_tile_cut": lambda: _edit(A.as_grid(
            A.cv2_avif(_alpha(bgr(64, 64, 84), 1)), 1, 2), alpha_cut),
    }


GRID_REJECTED = _grid_rejected()


@pytest.mark.parametrize("name", sorted(GRID_REJECTED))
def test_grids_libavif_fails_read_as_nothing(name, tmp_path):
    """cv2.imread reads nothing of these; the port raises
    FileNotFoundError naming the path."""
    want, p = _read_both(tmp_path, name, GRID_REJECTED[name]())
    assert want is None, name
    with pytest.raises(FileNotFoundError, match=f"{name}.avif"):
        image_io.imread_rgb(str(p))


# ------------------------------------------------------------------ ispe
def _libyuv():
    found = glob.glob(os.path.join(A._libs_dir(), "libavif-*.so*"))
    assert found, "libavif is not beside cv2"
    return ctypes.CDLL(found[0])


def _libyuv_scale(plane, w, h, depth):
    """libyuv's ScalePlane (8 bits) or ScalePlane_12 with kFilterBox, as
    libavif's avifImageScale calls it."""
    lib, P, I = _libyuv(), ctypes.c_void_p, ctypes.c_int
    sh, sw = plane.shape
    kind = np.uint8 if depth == 8 else np.uint16
    src = np.ascontiguousarray(plane, kind)
    dst = np.zeros((h, w), kind)
    fn = lib.ScalePlane if depth == 8 else lib.ScalePlane_12
    fn(P(src.ctypes.data), I(sw), I(sw), I(sh), P(dst.ctypes.data), I(w),
       I(w), I(h), I(3))
    return dst.astype(np.uint16)


def _port_scale(plane, w, h, depth):
    from transhuman_tpu_torch.native import build as codec

    src = np.ascontiguousarray(plane, np.uint16)
    dst = np.zeros((h, w), np.uint16)
    codec.library("av1").thc_avif_scale_plane(
        src.ctypes.data, src.shape[1], src.shape[0], dst.ctypes.data, w, h,
        depth)
    return dst


# name -> (frame file, ispe): each ratio libyuv has a routine of its own,
# others, and upsampling
ISPE = {
    "2x_down": (lambda: _tile(90), (32, 32)),
    "4x_down": (lambda: _tile(91), (16, 16)),
    "3_4": (lambda: _tile(92), (48, 48)),
    "3_4_with_a_c_tail": (lambda: A.cv2_avif(bgr(80, 100, 93)), (75, 60)),
    "3_8": (lambda: _tile(94), (24, 24)),
    "64_to_21": (lambda: _tile(95), (21, 21)),
    "64x48": (lambda: _tile(96), (64, 48)),
    "63x64": (lambda: _tile(97), (63, 64)),
    "2x_up": (lambda: _tile(98), (128, 128)),
    "up_100x90": (lambda: _tile(99), (100, 90)),
    "odd_33x31": (lambda: _tile(100), (33, 31)),
    "pil_422_3_4": (lambda: _tile(101, sub="4:2:2"), (48, 48)),
    "pil_444_up_70x90": (lambda: _tile(102, sub="4:4:4"), (70, 90)),
    "grey_2x_down": (lambda: _tile(103, grey=True), (32, 32)),
    "10bit_2x_down": (lambda: _tile(104, depth=10), (32, 32)),
    "10bit_3_4": (lambda: _tile(105, depth=10), (48, 48)),
    "10bit_64_to_21": (lambda: _tile(106, depth=10), (21, 21)),
    "10bit_2x_up": (lambda: _tile(107, depth=10), (128, 128)),
    "10bit_up_90x70": (lambda: _tile(108, depth=10), (90, 70)),
}


@pytest.mark.parametrize("name", sorted(ISPE))
def test_ispe_scales_the_frame_as_cv2_reads_it(name, tmp_path):
    """A file whose ispe is not its frame's size reads as cv2 reads it:
    libaom's planes scaled as libyuv's ScalePlane scales each (chroma at
    its subsampled size), then converted."""
    make, (w, h) = ISPE[name]
    frame = make()
    data = _with_ispe(frame, w, h)
    want, p = _read_both(tmp_path, name, data)
    assert want is not None and want.shape == (h, w, 3), name
    _same(image_io.imread_rgb(str(p)), want, name)
    planes = A.libaom_planes(A.primary_obus(frame))
    depth = 8 if planes[0].max() < 256 and "10bit" not in name else 10
    for i, got in enumerate(_planes_of(data)):
        want_plane = _libyuv_scale(planes[i], got.shape[1], got.shape[0],
                                   depth)
        assert (got == want_plane).all(), (name, i)


@pytest.mark.parametrize("depth", [8, 10, 12])
def test_scale_plane_as_libyuv_scales_it(depth):
    """native/av1.cc's scaler against libyuv's ScalePlane / ScalePlane_12
    (kFilterBox) over seeded sizes, up and down, and every routine's
    ratio at widths whose SIMD body has a C tail."""
    rng = np.random.default_rng(depth)
    cases = [(int(a), int(b), int(c), int(d)) for a, b, c, d in
             rng.integers(1, 160, (150, 4))]
    for sw, sh in ((64, 64), (100, 80), (40, 37), (248, 30), (63, 64),
                   (33, 31), (7, 5), (9, 1), (1, 9), (2, 2)):
        cases += [(sw, sh, max(sw // 2, 1), max(sh // 2, 1)),
                  (sw, sh, max(sw // 4, 1), max(sh // 4, 1)),
                  (sw, sh, max(sw * 3 // 4, 1), max(sh * 3 // 4, 1)),
                  (sw, sh, max(sw * 3 // 8, 1), max((sh * 3 + 7) // 8, 1)),
                  (sw, sh, max(sw * 3 // 8, 1), max(sh * 3 // 8, 1)),
                  (sw, sh, sw, max(sh * 3 // 4, 1)), (sw, sh, sw, sh * 2),
                  (sw, sh, 2 * sw, 2 * sh), (sw, sh, 2 * sw - 1, 2 * sh - 1),
                  (sw, sh, 2 * sw, sh), (sw, sh, max(sw // 3, 1), sh),
                  (sw, sh, sw * 5 // 3 + 1, sh * 4 // 3 + 1)]
    for sw, sh, w, h in cases:
        src = rng.integers(0, 1 << depth, (sh, sw)).astype(np.uint16)
        got, want = _port_scale(src, w, h, depth), _libyuv_scale(src, w, h,
                                                                 depth)
        assert (got == want).all(), (sw, sh, w, h)


# -------------------------------------------------------------- matrices
# chroma-derived NCL of primaries libyuv has no constants for (and codes
# libavif's table lacks, read as BT.709's), and 15 at every primaries
MATRICES = ([(12, cp) for cp in (0, 3, 4, 7, 8, 10, 11, 12, 13, 22)]
            + [(15, cp) for cp in (1, 2, 4, 5, 6, 7, 8, 9, 10, 11, 12, 22)])
_LOSSLESS = {}


@pytest.mark.parametrize("mc,cp", MATRICES)
def test_float_matrices_read_as_cv2(mc, cp, tmp_path):
    """Lossless 8-bit 4:2:0 and 10-bit 4:4:4 payloads holding every value,
    their nclx rewritten to the matrix and primaries, in both ranges, read
    as cv2 reads them (libavif's float conversion, Kr and Kb of the
    primaries for 12, BT.601's for 15)."""
    for depth, fmt in ((8, "420"), (10, "444")):
        if (depth, fmt) not in _LOSSLESS:
            _LOSSLESS[depth, fmt] = _lossless(depth, fmt)
        for full in (1, 0):
            name = f"m{mc}_c{cp}_{depth}_{fmt}_f{full}"
            want, p = _read_both(tmp_path, name, A.set_nclx(
                _LOSSLESS[depth, fmt], cp=cp, mc=mc, full=full))
            assert want is not None, name
            _same(image_io.imread_rgb(str(p)), want, name)


# ------------------------------------------------- cv2's signature check
def _after_filler(data, n, at=1):
    """data with an item of an unknown type and n bytes numbered ``at``
    (the items from ``at`` on renumbered after it), so that its data comes
    before theirs in mdat and pushes them back."""
    h = A.Heif(data)
    ids = {k: k + (k >= at) for k in h.items}
    h.items = {ids[k]: v for k, v in h.items.items()}
    h.refs = [(k, ids[s], ids[d]) for k, s, d in h.refs]
    h.assoc = {ids[k]: v for k, v in h.assoc.items()}
    h.primary = ids[h.primary]
    h.items[at] = [b"zzzz", bytes(n), b"\0"]
    return bytes(h)


def _lean_grid(nclx):
    """A 1x2 grid whose tiles share their properties (a meta box within
    cv2's 500 bytes), the grid numbered first; nclx on the grid or not."""
    h = A.Heif(A.as_grid(_tile(110), old=True))
    h.items = {1: h.items[3], 2: h.items[1], 3: h.items[2]}
    h.refs = [(b"dimg", 1, 2), (b"dimg", 1, 3)]
    h.assoc = {1: h.assoc[3], 2: h.assoc[1], 3: h.assoc[2]}
    h.primary = 1
    if nclx:
        h.add_prop(1, b"colr", h.prop(2, b"colr"))
    return bytes(h)


def _no_nclx(data):
    return _edit(data, lambda h: h.drop_prop(h.primary, b"colr"))


# name -> (file, whether cv2 reads it)
SIGNATURE = {
    "exif_past_500_bytes": (lambda: A.with_exif(A.cv2_avif(
        bgr(128, 128, 111), quality=95), 6), False),
    "exif_within_500_bytes": (lambda: A.with_exif(_tile(112), 6), True),
    "no_nclx_frame_past_500_bytes": (lambda: _after_filler(
        _no_nclx(_tile(113)), 600), False),
    "nclx_frame_past_500_bytes": (lambda: _after_filler(_tile(113), 600),
                                  True),
    "no_nclx_frame_across_500_bytes": (lambda: _after_filler(
        _no_nclx(_tile(113)), 120), True),
    "no_nclx_grid_tile_past_500_bytes": (lambda: _after_filler(
        _lean_grid(False), 600, at=2), False),
    "nclx_grid_tile_past_500_bytes": (lambda: _after_filler(
        _lean_grid(True), 600, at=2), True),
    "grid_data_past_500_bytes": (lambda: _after_filler(
        _lean_grid(True), 600), False),
}


@pytest.mark.parametrize("name", sorted(SIGNATURE))
def test_cv2_signature_check(name, tmp_path):
    """cv2 picks its AVIF decoder by libavif's parse of the file's first
    500 bytes: a grid's ImageGrid, an Exif item or (without nclx) the AV1
    data that parse reads must not start past them; the port reads what
    cv2 reads and refuses, naming the path, what it reads as nothing."""
    make, reads = SIGNATURE[name]
    want, p = _read_both(tmp_path, name, make())
    assert (want is not None) == reads, name
    if reads:
        _same(image_io.imread_rgb(str(p)), want, name)
    else:
        with pytest.raises(FileNotFoundError, match=f"{name}.avif"):
            image_io.imread_rgb(str(p))


# ------------------------------------------------------ threads (fault F3)
def test_concurrent_decodes_equal_the_serial_decode_and_cv2(tmp_path):
    """24 AVIFs of 256x256 (cv2's, and Pillow's 4:2:0 q60 of photographs
    and of screen captures, whose chroma is mostly predicted from luma:
    CfL) and a 2x2 grid, decoded through imread_rgb (what the loader's
    thread pool calls) on 8 threads, each twice in every round: every
    result equals the serial decode, which equals cv2's."""
    files = {f"cv2_{k}": A.cv2_avif(bgr(256, 256, 120 + k)) for k in range(8)}
    files.update({f"pil_{k}": _pil(bgr(256, 256, 140 + k), quality=60)
                  for k in range(8)})
    files.update({f"screen_{k}": A.pil_avif(A.screen_rgb(256, 256, k,
                                                         rects=8), quality=60)
                  for k in range(8)})
    files["grid"] = A.as_grid(_tile(160, size=128), 2, 2,
                              tiles=_tiles(4, 160, size=128))
    paths, serial = [], {}
    for name, data in files.items():
        want, p = _read_both(tmp_path, name, data)
        serial[str(p)] = image_io.imread_rgb(str(p))
        _same(serial[str(p)], want, name)
        paths.append(str(p))
    rng = np.random.default_rng(0)
    with ThreadPoolExecutor(8) as pool:
        for _ in range(6):
            jobs = list(rng.permutation(paths * 2))
            for path, got in zip(jobs, pool.map(image_io.imread_rgb, jobs)):
                assert (got == serial[path]).all(), path
