"""The port's readers of the frame formats ``cv2.imread`` reads beside JPEG
and PNG (data/image_formats.py through data/image_io.py::imread_rgb): each
variant of BMP, PxM (PBM, PGM, PPM, PAM, PFM), Sun raster and TIFF bit for
bit against ``cv2.imread`` of the same file + BGR -> RGB; what either side
refuses; and a ZJU-MoCap layout whose frames mix BMP, PPM, Sun raster and
TIFF, read by the port's loader and the JAX package's at the loader bounds
of PERF.md section 2.

The files come from cv2.imwrite where it writes the variant and otherwise
from tests/_torch_formats.py; every expected array is cv2's reading of the
file, never a writer's input.  The committed fixtures in
tests/fixtures/torch_zju_formats/ are made by ``make_fixtures`` below
(``python -m tests.test_torch_formats`` from the repository root remakes
them); ``digests.json`` holds the sha256 of cv2's decode of each, which
chip_smoke.py phase e holds the card machine's decode against.
"""

import hashlib
import json
import os

import cv2
import numpy as np
import pytest

from tests import _torch_formats as F
from transhuman_tpu_torch.data import image_formats, image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_zju_formats")


def _rng(seed):
    return np.random.default_rng(seed)


def _rgb(h, w, seed):
    return _rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _idx(h, w, n, seed, runs=True):
    """Palette indices below n with runs in them (so run-length codings
    have something to code)."""
    r = _rng(seed)
    v = r.integers(0, n, (h, w)).astype(np.uint8)
    if runs:
        for y in range(0, h, 3):
            x = r.integers(0, max(1, w - 5))
            v[y, x:x + r.integers(2, 9)] = r.integers(0, n)
        v[h // 2] = v[h // 2, 0]
    return v


def _pal(n, seed):
    return _rng(seed).integers(0, 256, (n, 3), dtype=np.uint8)


def _cv2_write(ext, img, params=()):
    ok, buf = cv2.imencode(ext, img, list(params))
    assert ok
    return buf.tobytes()


# ---------------------------------------------------------------- variants
def _bmp_cases():
    px16 = _rng(3).integers(0, 1 << 16, (13, 11)).astype(np.uint16)
    c = {
        "bmp24_cv2": lambda: _cv2_write(".bmp", _rgb(17, 23, 1)),
        "bmp24_topdown": lambda: F.bmp(_rgb(9, 14, 2), 24, top_down=True),
        "bmp32": lambda: F.bmp(_rgb(9, 14, 4), 32),
        "bmp32_bitfields_any_masks": lambda: F.bmp(
            _rgb(6, 5, 5), 32, compression=3, masks=(0xFF, 0xFF00, 0xFF0000)),
        "bmp32_v4_bitfields": lambda: F.bmp(
            _rgb(7, 9, 6), 32, compression=3,
            masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=108),
        "bmp24_v5": lambda: F.bmp(_rgb(7, 10, 7), 24, header=124),
        "bmp16_555": lambda: F.bmp(px16, 16),
        "bmp16_bitfields_555": lambda: F.bmp(
            px16, 16, compression=3, masks=(0x7C00, 0x3E0, 0x1F)),
        "bmp16_bitfields_565": lambda: F.bmp(
            px16, 16, compression=3, masks=(0xF800, 0x7E0, 0x1F)),
        "bmp8_palette": lambda: F.bmp(_idx(10, 13, 256, 8), 8,
                                      palette=_pal(256, 8)),
        "bmp8_short_palette": lambda: F.bmp(_idx(10, 13, 40, 9), 8,
                                            palette=_pal(40, 9), clrused=17),
        "bmp8_topdown_v5": lambda: F.bmp(_idx(6, 7, 256, 10), 8,
                                         palette=_pal(256, 10), header=124,
                                         top_down=True),
        "bmp4": lambda: F.bmp(_idx(9, 11, 16, 11), 4, palette=_pal(16, 11)),
        "bmp1": lambda: F.bmp(_idx(9, 19, 2, 12), 1, palette=_pal(2, 12)),
        "bmp_rle8": lambda: F.bmp(_idx(12, 21, 7, 13), 8,
                                  palette=_pal(256, 13), compression=1),
        "bmp_rle8_delta": lambda: F.bmp(_idx(12, 21, 7, 14), 8,
                                        palette=_pal(256, 14), compression=1,
                                        delta_at=(3, 5, 4, 2)),
        "bmp_rle8_delta_wraps": lambda: F.bmp(_idx(9, 10, 7, 15), 8,
                                              palette=_pal(256, 15),
                                              compression=1,
                                              delta_at=(1, 8, 5, 1)),
        "bmp_rle8_topdown": lambda: F.bmp(_idx(8, 9, 7, 16), 8,
                                          palette=_pal(256, 16),
                                          compression=1, top_down=True),
        "bmp_rle8_early_eof": lambda: _rle8_early_eof(),
        "bmp_rle4": lambda: F.bmp(_idx(12, 21, 16, 17), 4,
                                  palette=_pal(16, 17), compression=2),
        "bmp_rle4_v4": lambda: F.bmp(_idx(7, 30, 16, 18), 4,
                                     palette=_pal(16, 18), compression=2,
                                     header=108),
    }
    return c


def _rle8_without_eol():
    idx = _idx(6, 8, 5, 20)
    body = F._rle8(idx[::-1], eol_after_full=False)
    return _with_rle_body(idx, body, 8, _pal(256, 20))


def _rle8_early_eof():
    idx = _idx(6, 8, 5, 21)
    body = F._rle8(idx[::-1][:3])  # 3 rows, then end-of-bitmap
    return _with_rle_body(idx, body, 8, _pal(256, 21))


def _with_rle_body(idx, body, bits, pal):
    """A BMP header for idx's shape around a hand-made run-length body."""
    base = F.bmp(idx, bits, palette=pal, compression=1 if bits == 8 else 2)
    off = int.from_bytes(base[10:14], "little")
    return base[:off] + body


def _pxm_cases():
    g8 = _rng(30).integers(0, 256, (9, 13))
    c16 = _rng(31).integers(0, 65536, (7, 9, 3))
    g_odd = _rng(32).integers(0, 101, (8, 11))
    bits = _rng(33).integers(0, 2, (7, 19))
    return {
        "ppm_cv2": lambda: _cv2_write(".ppm", _rgb(11, 15, 34)),
        "pgm_cv2": lambda: _cv2_write(".pgm", g8.astype(np.uint8)),
        "pbm_cv2": lambda: _cv2_write(".pbm", (bits * 255).astype(np.uint8)),
        "ppm_cv2_ascii": lambda: _cv2_write(".ppm", _rgb(5, 6, 35),
                                            (cv2.IMWRITE_PXM_BINARY, 0)),
        "pam_cv2": lambda: _cv2_write(".pam", _rgb(8, 9, 36)),
        "pfm_cv2": lambda: _cv2_write(
            ".pfm", (_rng(37).random((6, 7, 3)) * 300 - 20).astype(
                np.float32)),
        "p1": lambda: F.pnm_ascii(bits, "P1"),
        "p1_packed_digits": lambda: (
            b"P1\n19 7\n" + b"\n".join(b"".join(b"%d" % v for v in row)
                                       for row in bits) + b"\n"),
        "p2": lambda: F.pnm_ascii(g8, "P2"),
        "p2_maxval_100_clipped": lambda: F.pnm_ascii(
            np.minimum(g_odd + 20, 140), "P2", 100),
        "p2_16bit": lambda: F.pnm_ascii(c16[..., 0], "P2", 65535),
        "p3": lambda: F.pnm_ascii(c16 >> 8, "P3", 255),
        "p3_maxval_7": lambda: F.pnm_ascii(c16 % 8, "P3", 7),
        "p3_maxval_1000": lambda: F.pnm_ascii(c16 % 1001, "P3", 1000),
        "p4": lambda: F.pnm_binary(bits, "P4"),
        "p5_maxval_100": lambda: F.pnm_binary(g_odd, "P5", 100),
        "p5_16bit": lambda: F.pnm_binary(c16[..., 1], "P5", 65535),
        "p5_maxval_1000": lambda: F.pnm_binary(c16[..., 2] % 1001, "P5",
                                               1000),
        "p6_16bit": lambda: F.pnm_binary(c16, "P6", 65535),
        "p6_maxval_7": lambda: F.pnm_binary(c16 % 8, "P6", 7),
        "p7_grey": lambda: F.pam(g8, 255, "GRAYSCALE"),
        "p7_rgb_16bit": lambda: F.pam(c16, 65535),
        "p7_rgb_maxval_100": lambda: F.pam(c16 % 101, 100),
        "pfm_big_endian": lambda: F.pfm(_pfm_values(38), little=False),
        "pfm_scale_0_3": lambda: F.pfm(_pfm_values(39), scale=0.3),
        "pfm_scale_7_big_endian": lambda: F.pfm(_pfm_values(40), little=False,
                                                scale=7.0),
    }


def _pfm_values(seed):
    f = (_rng(seed).random((9, 8, 3)) * 340 - 30).astype(np.float32)
    f[0, :6, 0] = [0.5, 1.5, 2.5, np.nan, np.inf, 3e9]
    return f


def _sun_cases():
    idx = _idx(9, 13, 256, 50)
    return {
        "sun24_cv2": lambda: _cv2_write(".ras", _rgb(9, 13, 51)),
        "sun24_odd_width": lambda: F.sun_raster(_rgb(6, 7, 52), 24),
        "sun32": lambda: F.sun_raster(_rgb(6, 7, 53), 32),
        "sun8_grey": lambda: F.sun_raster(idx, 8),
        "sun8_colour_map": lambda: F.sun_raster(idx, 8, cmap=_pal(256, 54)),
        "sun8_short_colour_map": lambda: F.sun_raster(idx % 40, 8,
                                                      cmap=_pal(30, 55)),
        "sun1": lambda: F.sun_raster(_idx(7, 21, 2, 56), 1),
        "sun1_colour_map": lambda: F.sun_raster(_idx(7, 21, 2, 57), 1,
                                                cmap=_pal(2, 57)),
        "sun_old_type_0": lambda: _sun_type(F.sun_raster(_rgb(5, 6, 58), 24),
                                            0),
    }


def _sun_type(data, t):
    return data[:20] + t.to_bytes(4, "big") + data[24:]


def _tiff_cases():
    rgb = _rgb(21, 37, 60)
    r16 = _rng(61).integers(0, 65536, (21, 37, 3)).astype(np.uint16)
    g8 = _rng(62).integers(0, 256, (21, 37)).astype(np.uint8)
    g16 = _rng(63).integers(0, 65536, (21, 37)).astype(np.uint16)
    b1 = _idx(21, 37, 2, 64)
    rgba = _rng(65).integers(0, 256, (21, 37, 4), dtype=np.uint8)
    rgba16 = _rng(66).integers(0, 65536, (21, 37, 4)).astype(np.uint16)
    ga = _rng(67).integers(0, 256, (21, 37, 2), dtype=np.uint8)
    ga16 = _rng(68).integers(0, 65536, (21, 37, 2)).astype(np.uint16)
    cm16 = _rng(69).integers(0, 65536, (3, 256))
    cm8 = _rng(70).integers(0, 256, (3, 16))
    bgr = rgb[..., ::-1]
    c = {f"tiff_cv2_c{k}": (lambda k=k: _cv2_write(
        ".tif", bgr, (cv2.IMWRITE_TIFF_COMPRESSION, k)))
        for k in (1, 5, 8, 32773)}
    c.update({
        "tiff_cv2_lzw_predictor": lambda: _cv2_write(
            ".tif", bgr, (cv2.IMWRITE_TIFF_COMPRESSION, 5,
                          cv2.IMWRITE_TIFF_PREDICTOR, 2)),
        "tiff_cv2_16bit_rgb": lambda: _cv2_write(".tif", r16[..., ::-1]),
        "tiff_cv2_grey": lambda: _cv2_write(".tif", g8),
        "tiff_cv2_rows_per_strip_4": lambda: _cv2_write(
            ".tif", bgr, (cv2.IMWRITE_TIFF_ROWSPERSTRIP, 4,
                          cv2.IMWRITE_TIFF_COMPRESSION, 8)),
        "tiff_strips_packbits": lambda: F.tiff(rgb, compression=32773,
                                               rows_per_strip=5),
        "tiff_packbits_predictor_ignored": lambda: F.tiff(
            rgb, compression=32773, predictor=2),
        "tiff_raw_predictor_ignored": lambda: F.tiff(rgb, predictor=2),
        "tiff_lzw_tiles": lambda: F.tiff(rgb, compression=5, tile=(16, 16)),
        "tiff_deflate_tiles_predictor": lambda: F.tiff(
            rgb, compression=8, predictor=2, tile=(16, 32)),
        "tiff_adobe_deflate_planar": lambda: F.tiff(
            rgb, compression=32946, planar=2, rows_per_strip=6),
        "tiff_lzw_planar_tiles_big_endian": lambda: F.tiff(
            rgb, compression=5, planar=2, tile=(16, 16), big_endian=True,
            predictor=2),
        "tiff_big_endian_16bit_predictor": lambda: F.tiff(
            r16, 16, compression=5, predictor=2, big_endian=True,
            rows_per_strip=7),
        "tiff_16bit_planar": lambda: F.tiff(r16, 16, planar=2),
        "tiff_grey_min_is_white": lambda: F.tiff(g8, photometric=0),
        "tiff_grey16": lambda: F.tiff(g16, 16, photometric=1,
                                      compression=8),
        "tiff_grey16_min_is_white": lambda: F.tiff(g16, 16, photometric=0),
        "tiff_bilevel": lambda: F.tiff(b1, 1, photometric=1,
                                       compression=32773),
        "tiff_bilevel_min_is_white": lambda: F.tiff(b1, 1, photometric=0,
                                                    rows_per_strip=3),
        "tiff_palette8_16bit_map": lambda: F.tiff(
            _idx(21, 37, 256, 71), 8, photometric=3, colormap=cm16,
            compression=5),
        "tiff_palette4_8bit_map": lambda: F.tiff(
            _idx(21, 37, 16, 72), 4, photometric=3, colormap=cm8),
        "tiff_palette1": lambda: F.tiff(
            b1, 1, photometric=3, colormap=_rng(73).integers(0, 65536,
                                                             (3, 2))),
        "tiff_rgba_unspecified": lambda: F.tiff(rgba, extra=[0]),
        "tiff_rgba_no_extra_tag": lambda: F.tiff(rgba),
        "tiff_rgba_associated": lambda: F.tiff(rgba, extra=[1],
                                               compression=5),
        "tiff_rgba_unassociated": lambda: F.tiff(rgba, extra=[2]),
        "tiff_rgba_unassociated_planar": lambda: F.tiff(rgba, extra=[2],
                                                        planar=2),
        "tiff_rgba16_unassociated": lambda: F.tiff(rgba16, 16, extra=[2]),
        "tiff_rgba16_associated_tiles": lambda: F.tiff(
            rgba16, 16, extra=[1], tile=(16, 16), compression=8),
        "tiff_grey_alpha": lambda: F.tiff(ga, photometric=1, extra=[2]),
        "tiff_grey_alpha_planar_unassociated": lambda: F.tiff(
            ga, photometric=1, extra=[2], planar=2),
        "tiff_grey_alpha_planar_min_is_white": lambda: F.tiff(
            ga, photometric=0, extra=[1], planar=2),
        "tiff_grey16_alpha_planar": lambda: F.tiff(
            ga16, 16, photometric=1, extra=[2], planar=2),
        "tiff_grey16_alpha": lambda: F.tiff(ga16, 16, photometric=1,
                                            extra=[1]),
        "tiff_signed_samples": lambda: F.tiff(rgb, sample_format=2),
    })
    square = _rgb(19, 19, 74)
    c.update({f"tiff_orientation_{o}": (lambda o=o: F.tiff(
        rgb if o < 5 else square, orientation=o, compression=5,
        rows_per_strip=4 if o % 2 else None)) for o in range(1, 9)})
    return c


CASES = {**_bmp_cases(), **_pxm_cases(), **_sun_cases(), **_tiff_cases()}


def cv2_imread(path) -> np.ndarray:
    img = cv2.imread(str(path))
    return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, (
        what, got.shape, want.shape)
    # bit for bit: the count of differing values is 0
    assert int((got != want).sum()) == 0, what


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_variant_reads_as_cv2_imread(name, tmp_path):
    p = tmp_path / name
    p.write_bytes(CASES[name]())
    want = cv2_imread(p)
    assert want is not None, f"cv2.imread reads nothing of {name}"
    _same(image_io.imread_rgb(str(p)), want, name)


# ---------------------------------------------------------------- refusals
def _refusal_cases():
    rgb = _rgb(20, 24, 80)
    bgr = rgb[..., ::-1]
    px16 = _rng(81).integers(0, 1 << 16, (5, 6)).astype(np.uint16)
    idx = _idx(6, 8, 4, 82)
    return {
        # cv2 reads nothing of these either
        "pfm_grey": (lambda: F.pfm(_pfm_values(83)[..., 0]), r"grey PFM",
                     True),
        "sun_rle": (lambda: F.sun_raster(_idx(6, 8, 9, 84), 8, rtype=2),
                    "Sun raster of type 2", True),
        "sun_rgb_type": (lambda: F.sun_raster(_rgb(4, 6, 85), 24, rtype=3),
                         "Sun raster of type 3", True),
        "bmp16_v5_565": (lambda: F.bmp(px16, 16, compression=3,
                                       masks=(0xF800, 0x7E0, 0x1F),
                                       header=124),
                         "16-bit BMP with bit-field masks", True),
        "bmp16_444": (lambda: F.bmp(px16, 16, compression=3,
                                    masks=(0xF00, 0xF0, 0xF)),
                      "16-bit BMP with bit-field masks", True),
        "tiff_float": (lambda: F.tiff(rgb, sample_format=3),
                       "float or complex samples", True),
        "tiff_grey4": (lambda: F.tiff(idx, 4, photometric=1),
                       "photometric interpretation 1 at 4 bits", True),
        "tiff_palette2": (lambda: F.tiff(idx, 2, photometric=3,
                                         colormap=np.zeros((3, 4), int)),
                          "photometric interpretation 3 at 2 bits", True),
        "tiff_five_samples": (lambda: F.tiff(
            np.concatenate([rgb, rgb[..., :2]], -1), extra=[2, 0]),
            "5 samples a pixel", True),
        "tiff_orientation_6_not_square": (lambda: F.tiff(
            rgb, orientation=6), "orientation 6 on a 24x20 image", True),
        "tiff_tiles_orientation_3": (lambda: F.tiff(
            rgb, orientation=3, tile=(16, 16)),
            "tiled TIFF with orientation 3", False),
        # the port refuses these by name; cv2 may read them
        "tiff_jpeg": (lambda: _tiff_compression(7), "JPEG compression",
                      False),
        "tiff_ccitt_g4": (lambda: _tiff_compression(4),
                          "CCITT G4 compression", False),
        "bigtiff": (lambda: F.tiff(rgb, bigtiff=True), "BigTIFF", False),
        "pam_rgba": (lambda: F.pam(_rng(86).integers(0, 256, (4, 5, 4)),
                                   255, "RGB_ALPHA"),
                     "PAM with 4 channels", False),
        "pam_grey_alpha": (lambda: F.pam(_rng(87).integers(0, 256, (4, 5, 2)),
                                         255, "GRAYSCALE_ALPHA"),
                           "PAM with 2 channels", False),
        "gif": (lambda: _cv2_write(".gif", bgr), "GIF is not read", False),
        "radiance_hdr": (lambda: _cv2_write(".hdr", bgr),
                         "Radiance HDR is not read", False),
        "webp": (lambda: _cv2_write(".webp", bgr), "WebP is not read",
                 False),
        "avif": (lambda: _cv2_write(".avif", bgr), "AVIF is not read",
                 False),
        "jpeg2000": (lambda: _cv2_write(".jp2", _rgb(64, 64, 88)),
                     "JPEG 2000 is not read", False),
    }


def _tiff_compression(k):
    """An RGB TIFF whose compression tag names k (its data is raw)."""
    data = bytearray(F.tiff(_rgb(8, 8, 89)))
    ifd = int.from_bytes(data[4:8], "little")
    n = int.from_bytes(data[ifd:ifd + 2], "little")
    for i in range(n):
        e = ifd + 2 + 12 * i
        if int.from_bytes(data[e:e + 2], "little") == 259:
            data[e + 8:e + 10] = k.to_bytes(2, "little")
    return bytes(data)


REFUSALS = _refusal_cases()


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refused_formats_name_the_path_and_the_format(name, tmp_path):
    make, what, cv2_none = REFUSALS[name]
    p = tmp_path / f"{name}.frame"
    p.write_bytes(make())
    if cv2_none:
        assert cv2.imread(str(p)) is None, name
    with pytest.raises(FileNotFoundError, match=f"{name}.frame.*{what}"):
        image_io.imread_rgb(str(p))


def test_malformed_files_are_errors_not_images(tmp_path):
    """A file cut short raises (ValueError naming the path), as cv2.imread
    returns nothing for it."""
    cut = {name: CASES[name]()
           for name in ("bmp24_cv2", "p6_16bit", "sun8_grey", "tiff_cv2_c5",
                        "bmp_rle8")}
    cut = {k: v[:len(v) * 2 // 3] for k, v in cut.items()}
    # rows that end in an absolute run, then a run with no end-of-line: a
    # run past the row's end
    cut["bmp_rle8_no_eol"] = _rle8_without_eol()
    for name, data in cut.items():
        p = tmp_path / name
        p.write_bytes(data)
        assert cv2.imread(str(p)) is None, name
        with pytest.raises((ValueError, FileNotFoundError), match=name):
            image_io.imread_rgb(str(p))


# ---------------------------------------------------------------- fixtures
FIXTURE_CASES = {
    "bmp_rle8_delta.bmp": "bmp_rle8_delta",
    "bmp16_bitfields_565.bmp": "bmp16_bitfields_565",
    "p3_maxval_1000.ppm": "p3_maxval_1000",
    "p6_16bit.ppm": "p6_16bit",
    "pfm_scale_0_3.pfm": "pfm_scale_0_3",
    "sun8_colour_map.ras": "sun8_colour_map",
    "tiff_lzw_planar_tiles_big_endian.tif":
        "tiff_lzw_planar_tiles_big_endian",
    "tiff_rgba16_unassociated.tif": "tiff_rgba16_unassociated",
}
# the LZW and Deflate TIFFs phase e times, in cv2's layout (strips of
# 8 KiB of raw rows)
LARGE = {"cv2_lzw_64.tif": 5, "cv2_deflate_64.tif": 8}


def _large_tiff(k, size=64):
    from tests.test_torch_zju_codec import smooth_image

    img = smooth_image(size, size, seed=k)
    return _cv2_write(".tif", np.ascontiguousarray(img[..., ::-1]),
                      (cv2.IMWRITE_TIFF_COMPRESSION, k))


def make_fixtures(out=FIXTURES) -> dict:
    """Write the fixtures and digests.json (cv2.imread's arrays)."""
    os.makedirs(out, exist_ok=True)
    files = {name: CASES[case]() for name, case in FIXTURE_CASES.items()}
    files.update({name: _large_tiff(k) for name, k in LARGE.items()})
    digests = {}
    for name, data in sorted(files.items()):
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2_imread(path)
        digests[name] = {"sha256": hashlib.sha256(img.tobytes()).hexdigest(),
                         "shape": list(img.shape), "by": "cv2.imread"}
    with open(os.path.join(out, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
    return digests


def test_committed_fixtures_decode_to_their_digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    assert sorted(digests) == sorted([*FIXTURE_CASES, *LARGE])
    for name, want in digests.items():
        path = os.path.join(FIXTURES, name)
        got = image_io.imread_rgb(path)
        assert list(got.shape) == want["shape"], name
        assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], (
            name)
        _same(got, cv2_imread(path), name)


@pytest.mark.parametrize("k", [5, 8, 32773])
def test_no_frame_decode_loops_over_bytes_in_python(k, tmp_path):
    """The byte-serial codings run in the C++ codec (zlib for Deflate): a
    1024x1024 TIFF of cv2's layout (512 strips) and a 1024x1024 RLE8 BMP
    decode with Python line events a few per strip, far fewer than
    bytes."""
    import sys

    p = tmp_path / "big.tif"
    p.write_bytes(_large_tiff(k, 1024))
    idx = _idx(1024, 1024, 7, 90)
    rle = F.bmp(idx, 8, palette=_pal(256, 90), compression=1)
    events = [0]

    def trace(frame, event, arg):
        events[0] += 1
        return trace

    sys.settrace(trace)
    try:
        tif = image_io.imread_rgb(str(p))
        bmp = image_formats.decode_bmp(rle)
    finally:
        sys.settrace(None)
    _same(tif, cv2_imread(p))
    _same(bmp, cv2.cvtColor(cv2.imdecode(np.frombuffer(rle, np.uint8),
                                         cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB))
    assert events[0] < 100 * 512, events[0]  # against 3 MiB of samples


# ------------------------------------------ a ZJU tree of mixed formats
@pytest.fixture(scope="module")
def zju_formats_root(tmp_path_factory):
    """tests/test_torch_zju.py's fake human (jitter-free JPEG frames), each
    frame then re-coded: frame 0 as BMPs, 1 as TIFFs, 2 as PPMs and Sun
    rasters (F.FRAME_FORMATS), named by the frame's extension."""
    from tests.test_torch_zju import HUMAN, NC, NF, write_fake_zju

    root = str(tmp_path_factory.mktemp("zju_formats"))
    write_fake_zju(root, seed=3)
    annots_path = os.path.join(root, HUMAN, "annots.npy")
    annots = np.load(annots_path, allow_pickle=True).item()
    for f in range(NF):
        ext, kinds = F.FRAME_FORMATS[f]
        names = []
        for c in range(NC):
            old = os.path.join(root, HUMAN, f"Camera_B{c + 1}", f"{f:06d}.jpg")
            img = cv2_imread(old)
            os.remove(old)
            with open(old[:-4] + ext, "wb") as fh:
                fh.write(F.encode_frame(img, kinds[c]))
            names.append(f"Camera_B{c + 1}/{f:06d}{ext}")
        annots["ims"][f]["ims"] = names
    np.save(annots_path, annots)
    return root


def test_mixed_format_frames_are_on_disk_and_read_as_cv2(zju_formats_root):
    from tests.test_torch_zju import HUMAN, NC, NF

    seen = set()
    for f in range(NF):
        ext, _ = F.FRAME_FORMATS[f]
        for c in range(NC):
            p = os.path.join(zju_formats_root, HUMAN, f"Camera_B{c + 1}",
                             f"{f:06d}{ext}")
            with open(p, "rb") as fh:
                seen.add(image_formats.sniff(fh.read(8)))
            _same(image_io.imread_rgb(p), cv2_imread(p), p)
    assert seen == {"bmp", "tiff", "pxm", "sun"}


def test_mixed_format_items_equal_the_jax_dataset(zju_formats_root):
    """Every train sample (jitter off) and eval item of the tree through
    the port's loader and the JAX package's (cv2.imread): images within
    1e-6, everything else exact."""
    from tests.test_torch_zju import (
        IMG_TOL,
        NC,
        NF,
        _pair,
        _same_eval_item,
        _same_frame,
        _same_rays,
    )

    j, t = _pair(zju_formats_root, "train", ["jitter", "False"])
    assert len(t) == len(j) == NF * NC
    for index in range(NF * NC):
        j.set_epoch(index)
        t.set_epoch(index)
        js, ts = j.get_train_sample(index), t.get_train_sample(index)
        _same_frame(ts.frame, js.frame, IMG_TOL)
        _same_rays(ts.rays, js.rays)
        np.testing.assert_allclose(ts.target_patches.numpy(),
                                   js.target_patches, rtol=0, atol=IMG_TOL)
    j, t = _pair(zju_formats_root, "test")
    for index in range(len(t)):
        _same_eval_item(t.get_eval_item(index), j.get_eval_item(index))


if __name__ == "__main__":
    print(json.dumps(make_fixtures(), indent=1))
