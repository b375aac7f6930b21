"""The port's TIFF reader (data/image_formats.py through
data/image_io.py::imread_rgb) on the codings and colour spaces libtiff's
RGBA image gives cv2.imread beside the plain ones test_torch_formats.py
holds: JPEG-compressed strips and tiles (RGB, YCbCr 4:4:4, 4:2:2 and
4:2:0, grey, CMYK; progressive, restart intervals, no JPEGTables, a last
strip coded at a full strip's height), YCbCr without JPEG at each libtiff
subsampling with ReferenceBlackWhite and YCbCrCoefficients, CMYK at 8 bits
(contiguous and separate), 8- and 16-bit CIELab with and without a
WhitePoint, CCITT RLE, Group 3 (1-D and 2-D) and Group 4 bilevel in both
fill orders, BigTIFF, FillOrder 2 on the other codings and tiles under
every orientation; each bit for bit against ``cv2.imread`` of the same
file + BGR -> RGB.  Then every 8-bit YCbCr and CIELab triple in one
4096x4096 frame, and what stays refused: what cv2 reads as nothing (LZMA,
ZSTD, 16-bit CMYK, another InkSet, ICCLab, ITULab, ...) and what no writer
here makes (old-style JPEG, CCITT RLEW, ...).

The files come from Pillow (libtiff 4.7) where it writes the variant and
otherwise from tests/_torch_formats.py's TIFF writer around cv2's JPEG
streams, packed YCbCr units or Pillow's CCITT strips; every expected array
is cv2's reading of the file.
"""

import io
import os
import sys

import cv2
import numpy as np
import pytest

if __name__ == "__main__":  # run as a script: import from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tests import _torch_formats as F  # noqa: E402
from tests.test_torch_formats import _same, cv2_imread  # noqa: E402
from transhuman_tpu_torch.data import image_io  # noqa: E402


def _rng(seed):
    return np.random.default_rng(seed)


def _smooth(h, w, seed):
    """A smooth RGB image (JPEG codes it with few bits)."""
    from tests.test_torch_zju_codec import smooth_image

    return smooth_image(h, w, seed)


def _pil(arr, mode, **kw) -> bytes:
    """Pillow's TIFF (libtiff) of arr converted to mode."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, "TIFF", **kw)
    return buf.getvalue()


def _set_tag(data: bytes, tag: int, value: int) -> bytes:
    """A classic little-endian TIFF with the SHORT (or LONG) entry ``tag``
    set to value."""
    data = bytearray(data)
    ifd = int.from_bytes(data[4:8], "little")
    n = int.from_bytes(data[ifd:ifd + 2], "little")
    for i in range(n):
        e = ifd + 2 + 12 * i
        if int.from_bytes(data[e:e + 2], "little") == tag:
            data[e + 8:e + 12] = value.to_bytes(4, "little")
            return bytes(data)
    raise KeyError(tag)


SAMPLING = {(1, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            (2, 1): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            (2, 2): cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420}


def _jpeg_tiff(img, photometric=6, sub=(2, 2), grey=False, tables=True,
               progressive=False, restart=0, full_last_strip=False,
               quality=90, rgb_stream=False, **kw):
    """A JPEG-compressed TIFF of img: each strip or tile cv2's JPEG
    (``quality``) split into the JPEGTables stream and an abbreviated
    stream (with tables False, whole streams and no tag 347); with
    rgb_stream, Pillow's JPEG of the RGB samples as they are (an Adobe
    marker of transform 0), what libtiff writes for photometric RGB."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if not grey:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sub]]
    if progressive:
        params += [cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    parts = {}
    img = img[..., :1] if grey else img
    h = img.shape[0]
    rps = kw.get("rows_per_strip") or h

    def code(block):
        if full_last_strip and block.shape[0] < rps:
            block = np.concatenate([block, np.repeat(
                block[-1:], rps - block.shape[0], 0)])
        if rgb_stream:
            from PIL import Image

            out = io.BytesIO()
            Image.fromarray(np.ascontiguousarray(block)).save(
                out, "JPEG", quality=quality, subsampling=0, keep_rgb=True)
            stream = out.getvalue()
        else:
            a = block[..., 0] if grey else np.ascontiguousarray(
                block[..., ::-1])
            ok, buf = cv2.imencode(".jpg", a, params)
            assert ok
            stream = buf.tobytes()
        parts["tables"], body = F.jpeg_tables_split(stream)
        return body if tables else stream

    F.tiff(img, photometric=photometric, compression=7, code=code, **kw)
    tags = dict(kw.pop("tags", {}))
    if tables:
        tags[347] = (7, parts["tables"])
    if photometric == 6:
        tags[530] = (3, list(sub))
    return F.tiff(img, photometric=photometric, compression=7, code=code,
                  tags=tags, **kw)


def _ycbcr_tiff(ycc, sub, compression=1, **kw):
    """Contiguous YCbCr of (h, w, 3) samples, subsampled sub in packed
    data units, raw or LZW."""
    hs, vs = sub
    tags = {530: (3, [hs, vs]), **kw.pop("tags", {})}
    return F.tiff(ycc, photometric=6, compression=compression, tags=tags,
                  code=lambda b: F._COMPRESS[compression](
                      F.ycbcr_units(b, hs, vs)), **kw)


def _fax_pil(bits, compression, fill_order=1, min_is_white=False,
             info=None):
    """Pillow's CCITT TIFF of a bilevel image, ``info`` more tags for
    libtiff; with min_is_white the photometric tag says 0 (the same
    bits)."""
    tiffinfo = dict(info or {})
    if fill_order == 2:
        tiffinfo[266] = 2
    data = _pil(bits, "1", compression=compression, tiffinfo=tiffinfo)
    return _set_tag(data, 262, 0) if min_is_white else data


def _fax_tiles(bits, compression, tile=(16, 32), fill_order=1, info=None):
    """A tiled CCITT TIFF of a bilevel image: each tile (padded white)
    Pillow's one-strip coding of that tile."""
    def code(block):
        data = _fax_pil(block[..., 0].astype(bool), compression, fill_order,
                        info=info)
        from PIL import Image

        t = Image.open(io.BytesIO(data)).tag_v2
        off, n = t[273][0], t[279][0]
        return data[off:off + n]

    tags = {262: (3, [1]), 266: (3, [fill_order])}
    if compression == "group3":
        tags[292] = (4, [(info or {}).get(292, 0)])
    return F.tiff(bits.astype(np.uint8), 1, photometric=1,
                  compression={"group3": 3, "group4": 4,
                               "tiff_ccitt": 2}[compression],
                  tile=tile, code=code, tags=tags)


def _bits(h, w, seed):
    """Bilevel pixels with runs of every length up to the row."""
    r = _rng(seed)
    rows = []
    for _ in range(h):
        row, x, v = [], 0, bool(r.integers(2))
        while x < w:
            n = int(min(w - x, r.choice([1, 2, 3, 7, 30, 64, 200, 2000])))
            row += [v] * n
            x += n
            v = not v
        rows.append(row)
    b = np.array(rows, bool)
    b[h // 2] = b[h // 2 - 1]  # a row like the one above (2-D V0 codes)
    return b


def _fill_order_2(compression):
    """An RGB TIFF of ``compression`` whose stored bits are reversed in
    each byte, FillOrder 2 set."""
    rev = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)
    img = _rgb(21, 37, 300 + compression)
    return F.tiff(img, compression=compression, rows_per_strip=8,
                  tags={266: (3, [2])},
                  code=lambda b: rev[np.frombuffer(F._COMPRESS[compression](
                      b.astype(np.uint8).tobytes()), np.uint8)].tobytes())


def _rgb(h, w, seed):
    return _rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _cases():
    img = _smooth(45, 61, 400)
    sq = _smooth(35, 35, 401)
    ycc = _rng(402).integers(0, 256, (21, 37, 3), dtype=np.uint8)
    cmyk = _rng(403).integers(0, 256, (21, 37, 4), dtype=np.uint8)
    lab = _rng(404).integers(0, 256, (21, 37, 3), dtype=np.uint8)
    lab16 = _rng(405).integers(0, 65536, (21, 37, 3)).astype(np.uint16)
    bits = _bits(40, 70, 406)
    wide = _bits(6, 3000, 407)
    c = {
        # JPEG (compression 7)
        "jpeg_pil_rgb": lambda: _pil(img, "RGB", compression="jpeg"),
        "jpeg_pil_rgb_strips": lambda: _pil(img, "RGB", compression="jpeg",
                                            tiffinfo={278: 16}),
        "jpeg_pil_ycbcr_444": lambda: _pil(img, "YCbCr", compression="jpeg"),
        "jpeg_pil_grey": lambda: _pil(img, "L", compression="jpeg",
                                      tiffinfo={278: 8}),
        "jpeg_pil_cmyk": lambda: _pil(img, "CMYK", compression="jpeg"),
        "jpeg_ycbcr_420_strips": lambda: _jpeg_tiff(img, rows_per_strip=16),
        "jpeg_ycbcr_420_tiles": lambda: _jpeg_tiff(img, tile=(16, 32)),
        "jpeg_ycbcr_420_one_strip": lambda: _jpeg_tiff(img),
        "jpeg_ycbcr_422_strips": lambda: _jpeg_tiff(img, sub=(2, 1),
                                                    rows_per_strip=8),
        "jpeg_ycbcr_422_tiles": lambda: _jpeg_tiff(img, sub=(2, 1),
                                                   tile=(32, 16)),
        "jpeg_ycbcr_444_tiles": lambda: _jpeg_tiff(img, sub=(1, 1),
                                                   tile=(16, 16)),
        "jpeg_ycbcr_420_progressive_tiles": lambda: _jpeg_tiff(
            img, tile=(32, 32), progressive=True),
        "jpeg_ycbcr_420_restarts": lambda: _jpeg_tiff(
            img, rows_per_strip=32, restart=2),
        "jpeg_ycbcr_420_no_tables": lambda: _jpeg_tiff(
            img, rows_per_strip=16, tables=False),
        "jpeg_ycbcr_420_full_last_strip": lambda: _jpeg_tiff(
            img, rows_per_strip=16, full_last_strip=True),
        "jpeg_rgb_over_ycc_stream": lambda: _jpeg_tiff(
            img, photometric=2, sub=(1, 1), rows_per_strip=16),
        "jpeg_rgb_strips": lambda: _jpeg_tiff(
            img, photometric=2, sub=(1, 1), rows_per_strip=8,
            rgb_stream=True),
        "jpeg_rgb_tiles": lambda: _jpeg_tiff(
            img, photometric=2, sub=(1, 1), tile=(16, 32), rgb_stream=True),
        "jpeg_grey_strips": lambda: _jpeg_tiff(img, photometric=1, grey=True,
                                               rows_per_strip=8),
        "jpeg_grey_min_is_white_tiles": lambda: _jpeg_tiff(
            img, photometric=0, grey=True, tile=(16, 16)),
        "jpeg_bigtiff_big_endian": lambda: _jpeg_tiff(
            img, rows_per_strip=16, bigtiff=True, big_endian=True),
        # YCbCr without JPEG
        **{f"ycbcr_{hs}{vs}_{kind}": (
            lambda hs=hs, vs=vs, kind=kind: _ycbcr_tiff(
                ycc, (hs, vs), **{"strips": dict(rows_per_strip=4),
                                  "tiles": dict(tile=(16, 16)),
                                  "lzw": dict(compression=5,
                                              rows_per_strip=8),
                                  "lzw_tiles": dict(compression=5,
                                                    tile=(16, 32))}[kind]))
           for hs, vs in ((1, 1), (1, 2), (2, 1), (2, 2), (4, 1), (4, 2),
                          (4, 4))
           for kind in ("strips", "tiles", "lzw", "lzw_tiles")},
        "ycbcr_44_tiles_right_edge": lambda: _ycbcr_tiff(
            _rng(408).integers(0, 256, (20, 40, 3), dtype=np.uint8), (4, 4),
            tile=(16, 32)),
        "ycbcr_22_default_subsampling": lambda: F.tiff(
            ycc, photometric=6, code=lambda b: F.ycbcr_units(b, 2, 2)),
        "ycbcr_11_planar": lambda: F.tiff(ycc, photometric=6, planar=2,
                                          tags={530: (3, [1, 1])}),
        "ycbcr_11_lzw_predictor": lambda: F.tiff(
            ycc, photometric=6, compression=5, predictor=2,
            tags={530: (3, [1, 1])}),
        "ycbcr_22_reference_black_white": lambda: _ycbcr_tiff(
            ycc, (2, 2), tags={532: (5, [(16, 1), (235, 1), (128, 1),
                                         (240, 1), (128, 1), (240, 1)])}),
        "ycbcr_11_bt709_half_steps": lambda: _ycbcr_tiff(
            ycc, (1, 1), tags={529: (5, [(2126, 10000), (7152, 10000),
                                         (722, 10000)]),
                               532: (5, [(15, 2), (471, 2), (257, 2),
                                         (479, 2), (255, 2), (481, 2)])}),
        "ycbcr_pil_raw": lambda: _pil(img, "YCbCr"),
        "ycbcr_pil_lzw": lambda: _pil(img, "YCbCr", compression="tiff_lzw"),
        # CMYK
        "cmyk_pil": lambda: _pil(img, "CMYK"),
        "cmyk_pil_lzw": lambda: _pil(img, "CMYK", compression="tiff_lzw"),
        "cmyk_planar": lambda: F.tiff(cmyk, photometric=5, planar=2),
        "cmyk_tiles_deflate_predictor": lambda: F.tiff(
            cmyk, photometric=5, tile=(16, 16), compression=8, predictor=2),
        "cmyk_five_inks_tag": lambda: F.tiff(cmyk, photometric=5,
                                             tags={332: (3, [1]),
                                                   334: (3, [5])}),
        "cmyk_alpha_extra": lambda: F.tiff(cmyk, photometric=5, extra=[2]),
        # CIELab
        "lab_pil": lambda: _pil(img, "LAB"),
        "lab_d50_default": lambda: F.tiff(lab, photometric=8),
        "lab_white_point_d65": lambda: F.tiff(
            lab, photometric=8, tags={318: (5, [(3127, 10000),
                                                (3290, 10000)])}),
        "lab_white_point_rounding": lambda: F.tiff(
            lab, photometric=8, tags={318: (5, [(1006851808, 1106653215),
                                                (33, 100)])}),
        "lab_tiles_lzw": lambda: F.tiff(lab, photometric=8, tile=(16, 16),
                                        compression=5),
        "lab16": lambda: F.tiff(lab16, 16, photometric=8),
        "lab16_big_endian": lambda: F.tiff(lab16, 16, photometric=8,
                                           big_endian=True,
                                           rows_per_strip=5),
        # CCITT bilevel, as Pillow writes it
        **{f"ccitt_{name}_fill{fo}": (
            lambda comp=comp, info=info, fo=fo: _fax_pil(bits, comp, fo,
                                                         info=info))
           for name, comp, info in (
               ("rle", "tiff_ccitt", {}), ("g3", "group3", {}),
               ("g3_2d", "group3", {292: 1}),
               ("g3_2d_fill_bits", "group3", {292: 5}),
               ("g4", "group4", {}))
           for fo in (1, 2)},
        "ccitt_g4_strips_min_is_white": lambda: _fax_pil(
            bits, "group4", min_is_white=True, info={278: 7}),
        "ccitt_g3_2d_strips": lambda: _fax_pil(bits, "group3",
                                               info={292: 1, 278: 9}),
        **{f"ccitt_{name}_tiles_fill{fo}": (
            lambda comp=comp, info=info, fo=fo: _fax_tiles(
                bits, comp, fill_order=fo, info=info))
           for name, comp, info in (
               ("rle", "tiff_ccitt", {}), ("g3_2d", "group3", {292: 1}),
               ("g4", "group4", {}))
           for fo in (1, 2)},
        "ccitt_rle_wide": lambda: _fax_pil(wide, "tiff_ccitt"),
        "ccitt_g3_wide": lambda: _fax_pil(wide, "group3"),
        "ccitt_g4_wide": lambda: _fax_pil(wide, "group4"),
        # BigTIFF
        "bigtiff_pil": lambda: _pil(img, "RGB", big_tiff=True),
        "bigtiff_lzw_tiles_big_endian": lambda: F.tiff(
            _rgb(21, 37, 409), compression=5, tile=(16, 16), bigtiff=True,
            big_endian=True),
        "bigtiff_cmyk_planar": lambda: F.tiff(cmyk, photometric=5, planar=2,
                                              bigtiff=True),
        # FillOrder 2 on the other codings
        **{f"fill_order_2_c{k}": (lambda k=k: _fill_order_2(k))
           for k in (1, 5, 8, 32773)},
    }
    # tiles under each orientation (5-8 on a square image), partial tiles
    # at the right and bottom edges
    for o in range(2, 9):
        c[f"tiles_orientation_{o}"] = (lambda o=o: F.tiff(
            img if o < 5 else sq, orientation=o, tile=(16, 32),
            compression=5))
    c["tiles_orientation_6_ycbcr_44"] = lambda: _ycbcr_tiff(
        _rng(410).integers(0, 256, (36, 36, 3), dtype=np.uint8), (4, 4),
        tile=(16, 16), tags={274: (3, [6])})
    c["tiles_orientation_3_jpeg"] = lambda: _jpeg_tiff(
        img, tile=(16, 16), tags={274: (3, [3])})
    c["strips_orientation_7_lab"] = lambda: F.tiff(
        _rng(411).integers(0, 256, (19, 19, 3), dtype=np.uint8),
        photometric=8, orientation=7, rows_per_strip=4)
    return c


CASES = _cases()


@pytest.mark.parametrize("name", sorted(CASES))
def test_each_tiff_variant_reads_as_cv2_imread(name, tmp_path):
    p = tmp_path / f"{name}.tif"
    p.write_bytes(CASES[name]())
    want = cv2_imread(p)
    assert want is not None, f"cv2.imread reads nothing of {name}"
    _same(image_io.imread_rgb(str(p)), want, name)


def _every_triple() -> np.ndarray:
    """Every 8-bit triple once: 4096 x 4096 x 3."""
    v = np.arange(1 << 24, dtype=np.uint32)
    return np.stack([v >> 16, v >> 8 & 255, v & 255], -1).astype(
        np.uint8).reshape(4096, 4096, 3)


@pytest.mark.parametrize("photometric", [6, 8])
def test_every_ycbcr_and_cielab_triple_reads_as_cv2(photometric, tmp_path):
    """Each of the 2^24 YCbCr (1x1, libtiff's default coefficients and
    ReferenceBlackWhite) or CIELab (D50) triples in one 4096x4096 frame:
    the port's RGB bit for bit cv2's."""
    tags = {530: (3, [1, 1])} if photometric == 6 else {}
    p = tmp_path / "every.tif"
    p.write_bytes(F.tiff(_every_triple(), photometric=photometric,
                         rows_per_strip=256, tags=tags))
    _same(image_io.imread_rgb(str(p)), cv2_imread(p), f"{photometric}")


def _refusals():
    rgb = _rgb(20, 24, 420)
    cmyk16 = _rng(421).integers(0, 65536, (20, 24, 4)).astype(np.uint16)
    return {
        # cv2 reads nothing of these either
        "lzma": (lambda: _pil(rgb, "RGB", compression="lzma"),
                 "LZMA compression \\(cv2 reads nothing", True),
        "zstd": (lambda: _pil(rgb, "RGB", compression="zstd"),
                 "ZSTD compression \\(cv2 reads nothing", True),
        "cmyk16": (lambda: F.tiff(cmyk16, 16, photometric=5),
                   "photometric interpretation 5 at 16 bits", True),
        "cmyk_inkset_2": (lambda: F.tiff(cmyk16.astype(np.uint8),
                                         photometric=5,
                                         tags={332: (3, [2])}),
                          "InkSet 2", True),
        "cmy": (lambda: F.tiff(rgb, photometric=5),
                "3 samples of 8 bits at photometric interpretation 5", True),
        "icclab": (lambda: F.tiff(rgb, photometric=9),
                   "photometric interpretation 9", True),
        "itulab": (lambda: F.tiff(rgb, photometric=10),
                   "photometric interpretation 10", True),
        "lab_planar": (lambda: F.tiff(rgb, photometric=8, planar=2),
                       "CIELab TIFF in separate planes", True),
        "ycbcr_24": (lambda: _ycbcr_tiff(rgb, (2, 4)),
                     "YCbCr TIFF subsampled 2x4", True),
        "ycbcr_22_planar": (lambda: F.tiff(rgb, photometric=6, planar=2),
                            "subsampled 2x2 in separate planes", True),
        "ycbcr16": (lambda: F.tiff(cmyk16[..., :3], 16, photometric=6,
                                   tags={530: (3, [1, 1])}),
                    "photometric interpretation 6 at 16 bits", True),
        "ccitt_of_8_bit_samples": (lambda: _set_tag(
            F.tiff(rgb[..., 0].copy(), photometric=1), 259, 4),
            "CCITT-compressed TIFF of 1 samples of 8 bits", True),
        # no writer here (Pillow, cv2) makes these
        "old_style_jpeg": (lambda: _set_tag(F.tiff(rgb), 259, 6),
                           "old-style JPEG compression \\(no writer", False),
        "ccitt_rlew": (lambda: _set_tag(_fax_pil(_bits(8, 16, 422),
                                                 "tiff_ccitt"), 259, 32771),
                       "CCITT RLEW compression \\(no writer", False),
        "ycbcr_22_predictor": (lambda: _ycbcr_tiff(
            rgb, (2, 2), compression=5, tags={317: (3, [2])}),
            "subsampled YCbCr TIFF with the horizontal predictor", False),
    }


REFUSALS = _refusals()


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refused_tiffs_name_the_path_and_the_format(name, tmp_path):
    make, what, cv2_none = REFUSALS[name]
    p = tmp_path / f"{name}.frame"
    p.write_bytes(make())
    if cv2_none:
        assert cv2.imread(str(p)) is None, name
    with pytest.raises(FileNotFoundError, match=f"{name}.frame.*{what}"):
        image_io.imread_rgb(str(p))
