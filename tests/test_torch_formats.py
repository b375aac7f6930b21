"""The port's readers of the frame formats ``cv2.imread`` reads beside JPEG
and PNG (data/image_formats.py through data/image_io.py::imread_rgb): each
variant of BMP, PxM (PBM, PGM, PPM, PAM, PFM), Sun raster, TIFF, GIF,
Radiance HDR, WebP and JPEG 2000 bit for bit against ``cv2.imread`` of the
same file + BGR -> RGB (and 120 seeds of tests/_torch_formats.py's
j2k_random); what either side refuses; and a ZJU-MoCap layout whose
frames mix BMP, PPM, Sun raster, TIFF, GIF, HDR, WebP and JP2, read by the
port's loader and the JAX package's at the loader bounds of PERF.md
section 2.

The files come from cv2.imwrite or Pillow where they write the variant and
otherwise from tests/_torch_formats.py; every expected array is cv2's
reading of the file, never a writer's input.  The committed fixtures in
tests/fixtures/torch_zju_formats/ are made by ``make_fixtures`` below
(``python tests/test_torch_formats.py`` or ``python -m
tests.test_torch_formats`` from the repository root remakes them);
``digests.json`` holds the sha256 of cv2's decode of each, which
chip_smoke.py phase e holds the card machine's decode against.
"""

import hashlib
import json
import os
import struct
import sys

import cv2
import numpy as np
import pytest

if __name__ == "__main__":  # run as a script: import from the repo root
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from tests import _torch_avif as AV  # noqa: E402
from tests import _torch_formats as F  # noqa: E402
from transhuman_tpu_torch.data import image_formats, image_io  # noqa: E402

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
    c.update({
        # read since the TIFF reader took libtiff's other codings
        # (tests/test_torch_tiff.py holds each of them)
        "tiff_tiles_orientation_3": lambda: F.tiff(rgb, orientation=3,
                                                   tile=(16, 16)),
        "tiff_jpeg": lambda: _tiff_test()._pil(rgb, "RGB",
                                               compression="jpeg"),
        "tiff_ccitt_g4": lambda: _tiff_test()._pil(b1.astype(bool), "1",
                                                   compression="group4"),
        "bigtiff": lambda: F.tiff(rgb, bigtiff=True),
    })
    c.update({f"tiff_orientation_{o}": (lambda o=o: F.tiff(
        rgb if o < 5 else square, orientation=o, compression=5,
        rows_per_strip=4 if o % 2 else None)) for o in range(1, 9)})
    return c


def _gif_cases():
    pal = _pal(16, 100)
    idx = _idx(11, 13, 16, 101)
    big = _idx(61, 67, 256, 102, runs=False)
    frame = _idx(7, 9, 16, 103)
    return {
        "gif_cv2": lambda: _cv2_write(".gif", _rgb(19, 23, 104)[..., ::-1]),
        "gif87a": lambda: F.gif([{"idx": idx}], palette=pal, version=b"87a"),
        "gif89a_interlaced": lambda: F.gif(
            [{"idx": _idx(23, 9, 16, 105), "interlace": True}], palette=pal),
        "gif_local_table": lambda: F.gif(
            [{"idx": idx, "palette": _pal(16, 106)}], palette=pal),
        "gif_local_table_only_offset": lambda: F.gif(
            [{"idx": frame, "palette": pal, "pos": (3, 2)}], screen=(15, 13)),
        "gif_offset_background": lambda: F.gif(
            [{"idx": frame, "pos": (5, 4)}], screen=(17, 12), palette=pal,
            bg=6),
        "gif_transparent": lambda: F.gif(
            [{"idx": frame, "pos": (2, 3), "transparent": 4}],
            screen=(14, 12), palette=pal, bg=9),
        "gif_transparent_background_index": lambda: F.gif(
            [{"idx": frame, "pos": (2, 3), "transparent": 5, "disposal": 2}],
            screen=(14, 12), palette=pal, bg=5),
        "gif_animated_first_frame": lambda: F.gif(
            [{"idx": idx}, {"idx": idx[::-1], "palette": _pal(16, 107)}],
            palette=pal, loop=True),
        "gif_odd_size_1x1": lambda: F.gif([{"idx": np.zeros((1, 1),
                                                              np.uint8)}],
                                          palette=pal[:2]),
        "gif_8bit_table_full": lambda: F.gif([{"idx": big}],
                                             palette=_pal(256, 108)),
        "gif_code_size_8_two_colours": lambda: F.gif(
            [{"idx": idx % 2}], palette=pal[:2], min_code_size=8),
        # extensions cv2 reads past: NETSCAPE2.0 with any sub-blocks, other
        # applications without a 3-byte one, any control extension after
        # the first frame
        **{f"gif_extension_{kind}": (lambda kind=kind: _gif_extension(kind))
           for kind in ("netscape_three_bytes", "xmp_two_bytes",
                        "disposal_7_after_first_frame",
                        "control_of_5_bytes_after_first_frame")},
        # LZW data cv2 reads past the full frame: the last byte's codes
        # after the frame's last pixel, a pixel code or one the table lacks
        "gif_lzw_extra_code_in_the_last_byte": lambda: _gif_lzw_tail(
            "gif_offset_background", byte=0),
        "gif_lzw_bad_code_in_the_last_byte": lambda: _gif_lzw_tail(
            "gif_offset_background", byte=1),
    }


def _gif_lzw_tail(name, byte=None, append=None) -> bytes:
    """GIF case ``name`` whose LZW data's last byte is set to ``byte``, or
    with the byte ``append`` added after it (the sub-block one longer)."""
    data = bytearray(_gif_cases()[name]())
    pos = data.index(b"\x2c", 13 + 48) + 10  # one sub-block of LZW data
    n = data[pos + 1]
    if byte is not None:
        data[pos + 1 + n] = byte
    else:
        data[pos + 1] = n + 1
        data[pos + 2 + n:pos + 2 + n] = bytes([append])
    return bytes(data)


# an application extension of identifier ``ident`` and data sub-blocks
def _gif_app(ident: bytes, *subs: bytes) -> bytes:
    return (b"\x21\xff" + bytes([len(ident)]) + ident
            + b"".join(bytes([len(x)]) + x for x in subs) + b"\0")


def _gif_extension(kind) -> bytes:
    """gif_animated_first_frame with the extension ``kind`` before its
    first frame or its second one (the control extensions)."""
    data = _gif_cases()["gif_animated_first_frame"]()
    head = 13 + 48  # header and global table
    # the second image descriptor: past the first one's blocks
    second = data.index(b"\x2c", head)
    second += 10  # descriptor, no local table
    second += 1  # LZW minimum code size
    while data[second]:
        second += data[second] + 1
    second += 1
    assert data[second] == 0x2C
    ext = {
        "netscape_three_bytes": _gif_app(b"NETSCAPE2.0", b"abc"),
        "xmp_two_bytes": _gif_app(b"XMP DataXMP", b"ab", b"abcd"),
        "disposal_7_after_first_frame": b"\x21\xf9\x04\x1c\0\0\0\0",
        "control_of_5_bytes_after_first_frame":
            b"\x21\xf9\x05\0\0\0\0\0\0",
        # cv2 reads nothing of these
        "disposal_4": b"\x21\xf9\x04\x10\0\0\0\0",
        "control_of_5_bytes": b"\x21\xf9\x05\0\0\0\0\0\0",
        "xmp_three_bytes": _gif_app(b"XMP DataXMP", b"abcd", b"abc"),
        "xmp_three_bytes_after_first_frame": _gif_app(b"XMP DataXMP",
                                                       b"abc"),
    }[kind]
    at = second if "after" in kind else head
    return data[:at] + ext + data[at:]


def _float_rgb(h, w, seed, scale=1.0):
    return _rng(seed).random((h, w, 3)) * scale


def _hdr_cases():
    bgr = _rgb(13, 21, 110)[..., ::-1]
    bright = _float_rgb(9, 19, 111, 3.0)
    bright[0, :3] = 0
    runs = np.repeat(_float_rgb(6, 5, 112), 7, axis=1)
    head = (b"#?RGBE\n# a comment\nGAMMA=2.2\nEXPOSURE=1.5\n"
            b"FORMAT=32-bit_rle_rgbe\n\n")
    return {
        "hdr_cv2_rle": lambda: _cv2_write(".hdr", bgr),
        "hdr_cv2_flat": lambda: _cv2_write(
            ".hdr", bgr, (cv2.IMWRITE_HDR_COMPRESSION,
                          cv2.IMWRITE_HDR_COMPRESSION_NONE)),
        "hdr_cv2_narrow_flat": lambda: _cv2_write(".hdr", bgr[:, :5]),
        "hdr_runs_bright_saturated": lambda: F.hdr(bright),
        "hdr_runs": lambda: F.hdr(runs),
        "hdr_rgbe_header_lines": lambda: F.hdr(runs, header=head),
        "hdr_flat_from_row_3": lambda: F.hdr(runs, flat_from=3),
        "hdr_flat": lambda: F.hdr(bright, rle=False),
        "hdr_past_int32_reads_0": lambda: F.hdr(_float_rgb(5, 11, 113,
                                                          2e7)),
    }


def _pil_webp(img, **kw) -> bytes:
    import io

    from PIL import Image

    frames = kw.pop("frames", None)
    buf = io.BytesIO()
    if frames is None:
        Image.fromarray(img).save(buf, "WEBP", **kw)
    else:
        Image.fromarray(img).save(
            buf, "WEBP", save_all=True,
            append_images=[Image.fromarray(f) for f in frames], **kw)
    return buf.getvalue()


def _smooth(h, w, seed):
    """A smooth image with noise (what a lossy coder is for)."""
    y, x = np.mgrid[:h, :w]
    img = np.stack([128 + 100 * np.sin(x / 7 + seed) * np.cos(y / 9),
                    128 + 90 * np.sin((x + y) / 11),
                    128 + 80 * np.cos(x / 5 - y / 13)], -1)
    img = img + _rng(seed).normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _rgba(h, w, seed):
    a = _rng(seed).integers(0, 256, (h, w, 1), dtype=np.uint8)
    a[_rng(seed + 1).random((h, w)) < 0.3] = 0
    return np.concatenate([_smooth(h, w, seed), a], -1)


def _webp_image_chunk(data):
    return [c for c in F.webp_chunks(data) if c[0] in (b"VP8 ", b"VP8L")]


def _webp_exif(orientation):
    """An EXIF chunk's TIFF block holding only an orientation."""
    import struct

    return (b"II*\0" + struct.pack("<IHHHIHH", 8, 1, 0x112, 3, 1,
                                    orientation, 0) + b"\0" * 4)


def _vp8_short_tokens():
    """A lossy key frame whose token partition ends 50 bytes in, too soon
    for its macroblocks, followed by another chunk: libwebp's last
    partition runs to the end of the file, so cv2 reads the frame."""
    frame = F.webp_chunks(F.vp8_random(64, 64, 136, data_per_mb=40))[0][1]
    first = 10 + (int.from_bytes(frame[:3], "little") >> 5)
    return F.riff_webp([(b"VP8 ", frame[:first + 50]),
                        (b"JUNK", bytes(range(200)))])


def _webp_cases():
    img = _smooth(37, 45, 120)
    big = _smooth(70, 90, 121)
    pal4 = _pal(4, 122)[_rng(123).integers(0, 4, (21, 26))]
    pal40 = _pal(40, 124)[_rng(125).integers(0, 40, (25, 31))]
    two = np.where(_rng(126).random((13, 21, 1)) < 0.5, 10, 200).repeat(3, -1)
    rgba = _rgba(20, 24, 127)
    small = _smooth(8, 10, 128)
    ll, ly = (_webp_image_chunk(_pil_webp(small, **kw)) for kw in
              ({"lossless": True}, {"quality": 60}))
    alpha_plane = rgba[..., 3]
    lossy_alpha = lambda: F.webp_chunks(_pil_webp(rgba, quality=80))

    def raw_alpha(f):
        chunks = lossy_alpha()
        vp8 = [c for c in chunks if c[0] == b"VP8 "][0]
        return F.vp8x(24, 20, [(b"ALPH", bytes([f << 2])
                                + alpha_plane.tobytes()), vp8], alpha=True)

    c = {
        # lossless (VP8L)
        "webp_cv2_lossless": lambda: _cv2_write(".webp", img[..., ::-1]),
        "webp_lossless_predictor_cross_colour": lambda: _pil_webp(
            big, lossless=True),
        "webp_lossless_subtract_green": lambda: _pil_webp(
            big, lossless=True, method=0),
        "webp_lossless_meta_codes": lambda: _pil_webp(
            big, lossless=True, quality=100, method=6),
        "webp_lossless_colour_cache": lambda: _pil_webp(
            (img // 64 * 64).astype(np.uint8), lossless=True),
        "webp_lossless_palette_2": lambda: _pil_webp(two.astype(np.uint8),
                                                     lossless=True),
        "webp_lossless_palette_4": lambda: _pil_webp(pal4, lossless=True),
        "webp_lossless_palette_40": lambda: _pil_webp(pal40,
                                                      lossless=True),
        "webp_lossless_every_predictor": lambda: F.vp8l(_smooth(40, 77, 129),
                                                        tile_bits=2),
        "webp_lossless_1x1": lambda: _pil_webp(img[:1, :1], lossless=True),
        "webp_lossless_alpha": lambda: _pil_webp(rgba, lossless=True,
                                                 exact=True),
        # lossy (VP8)
        "webp_cv2_lossy_q90": lambda: _cv2_write(
            ".webp", img[..., ::-1], (cv2.IMWRITE_WEBP_QUALITY, 90)),
        "webp_lossy_q30": lambda: _pil_webp(big, quality=30),
        "webp_lossy_odd_size": lambda: _pil_webp(_smooth(17, 33, 130),
                                                 quality=75),
        "webp_vp8_8_partitions_normal_filter": lambda: F.vp8_random(
            45, 70, 131, partitions=3, level=30, sharpness=3),
        "webp_vp8_simple_filter": lambda: F.vp8_random(
            64, 48, 132, partitions=1, simple=True, level=40, sharpness=6),
        "webp_vp8_segments_deltas": lambda: F.vp8_random(
            50, 50, 133, segments=(True, False, (-5, 3, 10, -20),
                                   (3, -2, 10, -30)),
            lf_deltas=((2, -1, 3, 0), (5, -4, 1, 2)),
            quant_deltas=(1, -2, 3, -4, 5)),
        "webp_vp8_segments_absolute": lambda: F.vp8_random(
            50, 50, 134, segments=(True, True, (5, 30, 80, 127),
                                   (0, 20, 63, 10)), level=10),
        "webp_vp8_no_filter": lambda: F.vp8_random(33, 17, 135, level=0),
        "webp_vp8_tokens_read_past_their_chunk": _vp8_short_tokens,
        # the VP8X container
        "webp_lossy_alpha": lambda: _pil_webp(rgba, quality=80),
        "webp_lossy_alpha_quality_50": lambda: _pil_webp(
            rgba, quality=80, alpha_quality=50),
        "webp_animated_lossless": lambda: _pil_webp(
            img, frames=[img[::-1].copy()], lossless=True),
        "webp_animated_lossy_alpha": lambda: _pil_webp(
            rgba, frames=[rgba[::-1].copy()], quality=70),
        "webp_animated_frame_offset": lambda: F.vp8x(24, 20, [
            (b"ANIM", b"\x11\x22\x33\xff\0\0"), F.anmf(4, 6, 10, 8, ll),
            F.anmf(0, 0, 10, 8, ly)], animation=True),
        "webp_exif_orientation_6": lambda: F.vp8x(45, 37, [
            *_webp_image_chunk(_cv2_write(".webp", img[..., ::-1])),
            (b"EXIF", _webp_exif(6))]),
        "webp_exif_without_the_flag": lambda: F.riff_webp([
            (b"VP8X", bytes(4) + (44).to_bytes(3, "little")
             + (36).to_bytes(3, "little")),
            *_webp_image_chunk(_cv2_write(".webp", img[..., ::-1])),
            (b"EXIF", _webp_exif(6))]),
    }
    c.update({f"webp_raw_alpha_filter_{f}": (lambda f=f: raw_alpha(f))
              for f in range(4)})
    return c


def _pil_j2k(img, **kw) -> bytes:
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG2000", **kw)
    return buf.getvalue()


PROGRESSIONS = ("LRCP", "RLCP", "RPCL", "PCRL", "CPRL")


def _jpeg2000_cases():
    """Pillow's and cv2's JPEG 2000 writers (OpenJPEG) and j2k_random:
    JP2 and raw codestreams, 5/3 and 9/7, grey, 16-bit grey, RGB, RGBA,
    quality layers, tiles at a size they do not divide, the five
    progression orders over precincts, code-blocks of 16x8, 1 and 6
    resolutions, PLT and COM markers; then what no writer here sets: the
    code-block style bits, ROI, SOP/EPH, PPM/PPT, POC, tile-parts,
    COC/QCC, precisions above 8, palettes, channel definitions, sYCC."""
    img = _smooth(80, 96, 140)
    grey = img[..., 1].copy()
    g16 = (_smooth(80, 96, 141)[..., 0].astype(np.uint16) * 257
           + _rng(141).integers(0, 256, (80, 96))).astype(np.uint16)
    rgba = _rgba(80, 96, 142)
    lossy = {"irreversible": True, "quality_layers": [20],
             "quality_mode": "rates"}
    c = {
        # the former refusal case: cv2's writer
        "jpeg2000": lambda: _cv2_write(".jp2", _rgb(64, 64, 88)),
        "jpeg2000_cv2_lossless": lambda: _cv2_write(
            ".jp2", img[..., ::-1], (cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                                     1000)),
        "jpeg2000_cv2_lossy": lambda: _cv2_write(
            ".jp2", img[..., ::-1], (cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
                                     100)),
        "jpeg2000_cv2_16bit_lossless": lambda: _cv2_write(
            ".jp2", _rng(148).integers(0, 1 << 16, (70, 90, 3)).astype(
                np.uint16), (cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 1000)),
        "jpeg2000_cv2_16bit_lossy": lambda: _cv2_write(
            ".jp2", g16, (cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, 300)),
        "jpeg2000_cv2_grey_odd_size": lambda: _cv2_write(
            ".jp2", _smooth(65, 97, 149)[..., 0].copy()),
        "jpeg2000_jp2_53": lambda: _pil_j2k(img),
        "jpeg2000_jp2_97": lambda: _pil_j2k(img, **lossy),
        "jpeg2000_j2k_53": lambda: _pil_j2k(img, no_jp2=True),
        "jpeg2000_j2k_97": lambda: _pil_j2k(img, no_jp2=True, **lossy),
        "jpeg2000_grey": lambda: _pil_j2k(grey),
        "jpeg2000_grey_97": lambda: _pil_j2k(grey, **lossy),
        "jpeg2000_grey16": lambda: _pil_j2k(g16),
        "jpeg2000_grey16_97": lambda: _pil_j2k(g16, irreversible=True),
        "jpeg2000_rgba": lambda: _pil_j2k(rgba),
        "jpeg2000_rgba_97": lambda: _pil_j2k(rgba, **lossy),
        "jpeg2000_mct_0": lambda: _pil_j2k(img, mct=0),
        "jpeg2000_mct_0_97": lambda: _pil_j2k(img, mct=0, **lossy),
        "jpeg2000_3_layers": lambda: _pil_j2k(
            img, quality_layers=[40, 20, 10], quality_mode="rates"),
        "jpeg2000_3_layers_97": lambda: _pil_j2k(
            img, quality_layers=[40, 20, 10], quality_mode="rates",
            irreversible=True),
        "jpeg2000_tiles_32": lambda: _pil_j2k(img, tile_size=(32, 32)),
        "jpeg2000_tiles_32_97": lambda: _pil_j2k(img, tile_size=(32, 32),
                                                 **lossy),
        "jpeg2000_codeblocks_16x8": lambda: _pil_j2k(
            img, codeblock_size=(16, 8)),
        "jpeg2000_codeblocks_16x8_97": lambda: _pil_j2k(
            img, codeblock_size=(16, 8), **lossy),
        "jpeg2000_1_resolution": lambda: _pil_j2k(img, num_resolutions=1),
        "jpeg2000_1_resolution_97": lambda: _pil_j2k(
            img, num_resolutions=1, **lossy),
        "jpeg2000_precincts_128": lambda: _pil_j2k(
            img, precinct_size=(128, 128)),
        "jpeg2000_plt_com": lambda: _pil_j2k(img, add_plt=True,
                                             comment="a comment"),
    }
    for prog in PROGRESSIONS:
        c[f"jpeg2000_{prog}_precincts"] = (lambda prog=prog: _pil_j2k(
            img, progression=prog, precinct_size=(32, 32),
            num_resolutions=3, quality_layers=[30, 10],
            quality_mode="rates"))
        c[f"jpeg2000_{prog}_precincts_97"] = (lambda prog=prog: _pil_j2k(
            img, progression=prog, precinct_size=(64, 64),
            num_resolutions=3, quality_layers=[30, 10],
            quality_mode="rates", irreversible=True))
    # j2k_random: one feature each (the rest of the header drawn)
    for bit, name in ((1, "bypass"), (2, "reset"), (4, "termall"),
                      (8, "vsc"), (16, "pterm"), (32, "segsym"),
                      (63, "every_style_bit"), (5, "bypass_termall")):
        for rev in (True, False):
            c[f"jpeg2000_random_{name}_{'53' if rev else '97'}"] = (
                lambda bit=bit, rev=rev: F.j2k_random(
                    37, 29, 150 + bit, ncomp=3, cblksty=bit, reversible=rev,
                    layers=3, max_bytes=14, bitplanes=9, passes=(3, 12)))
    rand = {
        "roi_shift": dict(ncomp=3, roi=(1, 5)),
        "roi_shift_bypass": dict(ncomp=3, roi=(0, 3), cblksty=1,
                                 bitplanes=9, passes=(4, 14)),
        "sop_eph": dict(ncomp=3, sop=True, eph=True, layers=3),
        "ppm": dict(ncomp=3, packed="ppm", tiles=(16, 16), sop=True),
        "ppt": dict(ncomp=3, packed="ppt", tiles=(24, 16), eph=True),
        "poc": dict(ncomp=3, poc=[(0, 0, 2, 2, 2, 2), (1, 0, 3, 33, 3, 4),
                                  (0, 0, 3, 33, 3, 0)], layers=3),
        "tile_parts": dict(ncomp=3, tiles=(20, 13), tile_parts=3, layers=4),
        "psot_0": dict(ncomp=3, psot0=True, tiles=(40, 40)),
        "coc_qcc": dict(ncomp=3, mct=0, coc=1, qcc=2),
        "precision_12": dict(ncomp=3, prec=12),
        "precision_20": dict(ncomp=3, prec=20, reversible=False),
        "precisions_8_16_10": dict(ncomp=3, prec=[8, 16, 10], mct=0),
        "small_precincts": dict(ncomp=3, precincts=True, numres=4),
        "grey_jp2": dict(ncomp=1, wrap={"colr": 17}),
        "grey_alpha_jp2": dict(ncomp=2, wrap={"colr": 17, "cdef": [
            (0, 0, 1), (1, 1, 0)]}),
        "palette": dict(ncomp=1, wrap={"colr": 16, "pclr": _pal(200, 143)}),
        "rgba_alpha_first": dict(ncomp=4, wrap={"colr": 16, "cdef": [
            (0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)]}),
        "channels_reordered": dict(ncomp=3, wrap={"colr": 16, "cdef": [
            (0, 0, 3), (1, 0, 2), (2, 0, 1)]}),
        "sycc": dict(ncomp=3, wrap={"colr": 18}),
        "icc_profile": dict(ncomp=3, wrap={"colr": "icc"}),
        "no_colour_box": dict(ncomp=3, wrap={"colr": None}),
        "one_pixel": dict(ncomp=3, width=1, height=1, numres=6),
    }
    for kind in ("colr_before_ihdr", "other_boxes", "codestream_to_the_end"):
        c[f"jpeg2000_jp2_{kind}"] = lambda kind=kind: _jp2_boxes(kind)
    for k, (name, kw) in enumerate(rand.items()):
        kw = dict(kw)
        w, h = kw.pop("width", 41), kw.pop("height", 27)
        c[f"jpeg2000_random_{name}"] = (
            lambda kw=kw, w=w, h=h, k=k: F.j2k_random(w, h, 170 + k, **kw))
    for prog in range(5):
        c[f"jpeg2000_random_{PROGRESSIONS[prog]}_small_precincts"] = (
            lambda prog=prog: F.j2k_random(45, 38, 190 + prog, ncomp=3,
                                           progression=prog, precincts=True,
                                           tiles=(13, 11)))
    # what OpenJPEG reads after the last tile-part (the refusals hold the
    # rest): two last bytes in place of the EOC, a SOT (of any tile, cut or
    # not) where the first tile has one tile-part, bytes after the EOC, an
    # empty further tile-part of the first tile that TPsot = TNsot announces
    for kind in ("two_zero_bytes", "two_junk_bytes", "sot_then_eoc",
                 "sot_of_another_tile", "sot_cut_short", "eoc_then_junk",
                 "parts_sot_of_another_tile", "parts_empty_last_part"):
        c[f"jpeg2000_trailer_{kind}"] = lambda kind=kind: _j2k_trailer(kind)
    return c


def _sot(isot, psot, tpsot, tnsot) -> bytes:
    import struct

    return b"\xff\x90" + struct.pack(">HHIBB", 10, isot, psot, tpsot, tnsot)


def _j2k_trailer(kind) -> bytes:
    """A codestream whose EOC gives way to the trailer ``kind``: Pillow's
    (one tile-part a tile, 4 tiles), or j2k_random's of 3 tile-parts a
    tile for the kinds starting "parts"."""
    if kind.startswith("parts"):
        body = F.j2k_random(20, 20, 5, ncomp=3)[:-2]
    else:
        body = _pil_j2k(_smooth(40, 48, 148), no_jp2=True,
                        tile_size=(32, 32))[:-2]
    eoc = b"\xff\xd9"
    return body + {
        "two_zero_bytes": b"\0\0", "two_junk_bytes": b"\x12\x34",
        "sot_then_eoc": _sot(0, 0, 0, 0) + eoc,
        "sot_of_another_tile": _sot(3, 14, 0, 1) + b"\xff\x93" + eoc,
        "sot_cut_short": b"\xff\x90\x00\x0a",
        "eoc_then_junk": eoc + b"junk",
        "parts_sot_of_another_tile": _sot(1, 0, 0, 0) + eoc,
        "parts_empty_last_part": _sot(0, 0, 3, 3) + eoc,
        # refused: cv2 reads nothing
        "junk_then_eoc": b"\x12\x34" + eoc, "four_zero_bytes": b"\0" * 4,
        "com_then_eoc": b"\xff\x64\x00\x04ab" + eoc,
        "parts_sot_tpsot_tnsot": _sot(0, 0, 0, 0) + eoc,
        "parts_sot_cut_short": b"\xff\x90\x00\x0a",
    }[kind]


def _avif_cases():
    """cv2's and Pillow's AVIFs (tests/_torch_avif.py's writers;
    tests/test_torch_avif.py holds every variant and the decoded planes)."""
    bgr = np.ascontiguousarray(_smooth(36, 50, 170)[..., ::-1])
    bgr_tall = np.ascontiguousarray(_smooth(150, 270, 171)[..., ::-1])
    alpha = _rng(172).integers(0, 256, (36, 50, 1), dtype=np.uint8)
    return {
        "avif": lambda: AV.cv2_avif(bgr),
        "avif_cv2_10bit": lambda: AV.cv2_avif(bgr.astype(np.uint16) << 2,
                                             depth=10),
        "avif_cv2_grey_12bit": lambda: AV.cv2_avif(
            bgr[..., 1].astype(np.uint16) << 4, depth=12),
        "avif_pil_422": lambda: AV.pil_avif(bgr[..., ::-1],
                                           subsampling="4:2:2"),
        "avif_pil_rgba": lambda: AV.pil_avif(np.concatenate(
            [bgr[..., ::-1], alpha], -1)),
        "avif_pil_sb128_tiles": lambda: AV.pil_avif(
            bgr_tall[..., ::-1], speed=8, tile_rows=1, tile_cols=1,
            advanced={"sb-size": "128"}),
        # a switchable loop-restored luma plane with none, Wiener and
        # self-guided units (libaom switches only between several units);
        # film grain on an odd-sized frame
        "avif_pil_lr_switchable": lambda: AV.pil_avif(
            _textured_rgb(256, 173), quality=70, speed=2),
        "avif_pil_film_grain": lambda: AV.pil_avif(
            _fixture_rgb()[200:261, 300:363], quality=60, speed=6,
            advanced={"film-grain-test": "1"}),
        # screen content: Y and UV palettes only, and blocks copied within
        # the frame (intra block copy) beside palettes
        "avif_pil_palette": lambda: AV.pil_avif(
            AV.screen_rgb(96, 128, 3), quality=60, speed=8,
            advanced={"tune-content": "screen"}),
        "avif_pil_intrabc": lambda: AV.pil_avif(
            AV.screen_rgb(128, 160, 3), quality=60, speed=6,
            advanced={"tune-content": "screen"}),
        # image sequences (a moov track): cv2 reads their first frame;
        # Pillow's RGBA one has an alpha track
        "avif_pil_sequence": lambda: AV.pil_sequence([bgr[..., ::-1],
                                                      bgr[::-1, :, ::-1]]),
        "avif_pil_sequence_rgba": lambda: AV.pil_sequence([np.concatenate(
            [f[..., ::-1], alpha], -1) for f in (bgr, bgr[::-1])]),
        "avif_cv2_sequence_10bit": lambda: AV.cv2_sequence(
            [f.astype(np.uint16) << 2 for f in (bgr, bgr[::-1])], depth=10),
        # a still item of a layered image's properties: a1lx (its layer
        # sizes, not essential), lsel 0 and a1op 0 (essential)
        "avif_layered_a1lx_lsel_a1op": lambda: _layered(AV.cv2_avif(bgr)),
    }


def _layered(data):
    heif = AV.Heif(data)
    heif.add_prop(heif.primary, b"a1lx", bytes([0]) + struct.pack(
        ">HHH", 0, 0, 0))
    heif.add_prop(heif.primary, b"lsel", b"\0\0", 1)
    heif.add_prop(heif.primary, b"a1op", b"\0", 1)
    return bytes(heif)


def _fixture_rgb():
    """The 1024x1024 q95 fixture JPEG's decode (RGB)."""
    jpeg = os.path.join(os.path.dirname(FIXTURES), "torch_zju",
                        "cv2_q95_420.jpg")
    return np.ascontiguousarray(cv2.imread(jpeg)[..., ::-1])


def _textured_rgb(side, seed):
    """A side x side frame: the left half a crop of the fixture JPEG's
    decode, the right half blurred noise (seeded)."""
    out = _fixture_rgb()[:side, 512 - side // 2:512 + side // 2].copy()
    noise = _rng(seed).integers(0, 256, (side, side // 2, 3), dtype=np.uint8)
    out[:, side // 2:] = cv2.GaussianBlur(noise, (0, 0), 1.5)
    return out


CASES = {**_bmp_cases(), **_pxm_cases(), **_sun_cases(), **_tiff_cases(),
         **_gif_cases(), **_hdr_cases(), **_webp_cases(),
         **_jpeg2000_cases(), **_avif_cases()}


def j2k_seed(seed: int) -> bytes:
    """j2k_random's file of ``seed`` at a drawn size (1 to 47 a side), as a
    file cv2 reads: a grey codestream (one or two components) in a JP2
    with a grey colour space, channel definitions or a palette; three or
    four components raw or in a JP2 of any colour box cv2 reads."""
    rng = _rng(10_000 + seed)
    w, h = int(rng.integers(1, 48)), int(rng.integers(1, 48))
    nc = int(rng.choice([1, 2, 3, 3, 4]))
    if nc == 1:
        wrap = [{"colr": 17},
                {"colr": 16, "pclr": rng.integers(0, 256, (int(
                    rng.integers(1, 257)), 3))},
                {"colr": 18, "pclr": rng.integers(0, 256, (200, 3))}][
            int(rng.integers(3))]
    elif nc == 2:
        wrap = [{"colr": 17}, {"colr": 17, "cdef": [(0, 0, 1), (1, 1, 0)]},
                {"colr": 17, "cdef": [(1, 0, 1), (0, 1, 0)]}][
            int(rng.integers(3))]
    else:
        wrap = [None, {"colr": 16}, {"colr": 18}, {"colr": "icc"},
                {"colr": None}, {"colr": 17}, {"colr": 14}][
            int(rng.integers(7))]
        if nc == 4 and wrap is not None and rng.random() < 0.7:
            wrap = dict(wrap, cdef=[
                [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 1, 0)],
                [(0, 0, 3), (1, 0, 2), (2, 0, 1), (3, 1, 0)],
                [(0, 1, 0), (1, 0, 1), (2, 0, 2), (3, 0, 3)],
                [(0, 0, 1), (1, 0, 2), (2, 0, 3), (3, 2, 0)],
                [(0, 0, 2), (1, 0, 3), (2, 0, 1), (3, 65535, 65535)],
                [(0, 1, 0), (1, 1, 0), (2, 0, 1), (3, 0, 2)]][
                int(rng.integers(6))])
    return F.j2k_random(w, h, seed, ncomp=nc, wrap=wrap)


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


@pytest.mark.parametrize("first", range(0, 120, 10))
def test_jpeg2000_random_codestreams_read_as_cv2_imread(first, tmp_path):
    """Ten seeds of j2k_random a case, 120 in all: every header field and
    code-block payload drawn, every file one cv2 reads, the port's image
    bit for bit cv2's."""
    for seed in range(first, first + 10):
        p = tmp_path / f"seed_{seed}.jp2"
        p.write_bytes(j2k_seed(seed))
        want = cv2_imread(p)
        assert want is not None, f"cv2.imread reads nothing of seed {seed}"
        _same(image_io.imread_rgb(str(p)), want, f"seed {seed}")


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
        # the port refuses these by name; cv2 may read them
        "pam_rgba": (lambda: F.pam(_rng(86).integers(0, 256, (4, 5, 4)),
                                   255, "RGB_ALPHA"),
                     "PAM with 4 channels", False),
        "pam_grey_alpha": (lambda: F.pam(_rng(87).integers(0, 256, (4, 5, 2)),
                                         255, "GRAYSCALE_ALPHA"),
                           "PAM with 2 channels", False),
        "hdr_plus_y_layout": (lambda: _hdr_layout(b"+Y 20 +X 24"),
                              "Radiance HDR layout other than -Y H \\+X W",
                              True),
        "hdr_minus_x_layout": (lambda: _hdr_layout(b"-Y 20 -X 24"),
                               "Radiance HDR layout other than -Y H \\+X W",
                               True),
        "hdr_xyze": (lambda: F.hdr(_float_rgb(4, 9, 90), header=(
            b"#?RADIANCE\nFORMAT=32-bit_rle_xyze\n\n")),
            "Radiance HDR in XYZE", True),
        "gif_frame_outside_screen": (lambda: F.gif(
            [{"idx": idx, "pos": (5, 1)}], screen=(10, 8), palette=_pal(4, 91)),
            "GIF frame outside its logical screen", True),
        "webp_lossless_version_1": (lambda: _vp8l_version(1),
                                    "WebP lossless version 1", True),
        # JPEG 2000: cv2 reads nothing of these either
        "jpeg2000_image_offset": (lambda: _j2k_siz(XOsiz=8),
                                  "image or tile-grid offset", True),
        "jpeg2000_tile_offset": (lambda: _j2k_siz(XOsiz=8, XTOsiz=4),
                                 "image or tile-grid offset", True),
        "jpeg2000_signed": (lambda: _pil_j2k(rgb, signed=True),
                            "signed component 0", True),
        **{f"jpeg2000_cut_{k}": (lambda k=k: _cut(_pil_j2k(
            _smooth(80, 96, 144), tile_size=(32, 32)), k),
            "cut codestream", True) for k in (50, 90, 99)},
        "jpeg2000_cut_in_main_header": (lambda: _pil_j2k(
            rgb, no_jp2=True)[:60], "cut codestream \\(in its main header",
            True),
        "jpeg2000_cut_before_codestream": (lambda: _pil_j2k(rgb)[:70],
                                           "cut JP2 file", True),
        "jpeg2000_no_eoc": (lambda: _pil_j2k(rgb, no_jp2=True)[:-2],
                            "no EOC after its last tile-part", True),
        "jpeg2000_trailer_one_byte": (lambda: _pil_j2k(
            rgb, no_jp2=True)[:-2] + b"\0", "no EOC after its last tile-part",
            True),
        **{f"jpeg2000_trailer_{kind}": (lambda kind=kind: _j2k_trailer(kind),
                                        what, True)
           for kind, what in (
               ("junk_then_eoc", "bytes other than an EOC or a SOT"),
               ("four_zero_bytes", "bytes other than an EOC or a SOT"),
               ("com_then_eoc", "bytes other than an EOC or a SOT"),
               ("parts_sot_tpsot_tnsot",
                "OpenJPEG takes for another tile-part"),
               ("parts_sot_cut_short", "a SOT cut short"))},
        "jpeg2000_grey_codestream": (lambda: _pil_j2k(
            rgb[..., 0].copy(), no_jp2=True),
            "1 components without a JP2 grey colour space", True),
        "jpeg2000_precision_4": (lambda: F.j2k_random(
            20, 20, 200, ncomp=3, prec=4), "precision below 8 bits", True),
        "jpeg2000_five_components": (lambda: F.j2k_random(
            20, 20, 201, ncomp=5, mct=0), "5 components", True),
        "jpeg2000_subsampled": (lambda: F.j2k_random(
            21, 19, 202, ncomp=3, mct=0,
            subsampling=[(1, 1), (2, 2), (2, 2)]),
            "sub-sampled component 1", True),
        "jpeg2000_e_sycc": (lambda: F.j2k_random(
            20, 20, 203, ncomp=3, wrap={"colr": 24}), "e-sYCC", True),
        "jpeg2000_cmyk": (lambda: F.j2k_random(
            20, 20, 204, ncomp=4, wrap={"colr": 12}), "CMYK", True),
        "jpeg2000_sycc_grey": (lambda: F.j2k_random(
            20, 20, 205, ncomp=1, wrap={"colr": 18}),
            "sYCC image of fewer than 3 components", True),
        "jpeg2000_tile_without_data": (lambda: F.j2k_random(
            20, 20, 206, ncomp=3, packed="ppt", sop=False, empty=True),
            "tile 0 of no packet data", True),
        "jpeg2000_jp2_without_ftyp": (lambda: _jp2_boxes("no_ftyp"),
                                      "second box is not ftyp", True),
        "jpeg2000_jp2_without_jp2h": (lambda: _jp2_boxes("no_jp2h"),
                                      "without a header box", True),
        "jpeg2000_jp2_without_ihdr": (lambda: _jp2_boxes("no_ihdr"),
                                      "header box without ihdr", True),
        "jpeg2000_jp2_ihdr_size": (lambda: _jp2_boxes("ihdr_size"),
                                   "ihdr size is not its codestream's",
                                   True),
        # HTJ2K (Part 15): no writer here codes it
        "jpeg2000_htj2k_rsiz": (lambda: _j2k_siz(Rsiz=0x4000),
                                "HTJ2K \\(Part 15\\) codestream \\(Rsiz",
                                False),
        "jpeg2000_htj2k_cap": (lambda: _j2k_cap(), "HTJ2K .* \\(CAP marker",
                               False),
        "jpeg2000_htj2k_code_blocks": (lambda: _j2k_cblksty(0x40),
                                       "HTJ2K \\(Part 15\\) code-blocks",
                                       False),
    }


def _jp2_boxes(kind):
    """A JP2 file of j2k_random's codestream whose boxes are laid out as
    ``kind`` says (what jp2.c checks of their order)."""
    import struct

    cs = F.j2k_random(30, 20, 207, ncomp=3)
    ihdr = F._box(b"ihdr", struct.pack(">IIHBBBB", 20, 30, 3, 7, 7, 0, 0))
    colr = F._box(b"colr", struct.pack(">BBBI", 1, 0, 0, 16))
    head = F._box(b"jP  ", b"\r\n\x87\n")
    ftyp = F._box(b"ftyp", b"jp2 " + bytes(4) + b"jp2 ")
    return head + {
        "colr_before_ihdr": ftyp + F._box(b"jp2h", colr + ihdr)
        + F._box(b"jp2c", cs),
        "other_boxes": ftyp + F._box(b"xml ", b"<a/>")
        + F._box(b"jp2h", ihdr + colr) + F._box(b"uuid", bytes(20))
        + F._box(b"jp2c", cs),
        "codestream_to_the_end": ftyp + F._box(b"jp2h", ihdr + colr)
        + b"\0\0\0\0jp2c" + cs,
        "no_ftyp": F._box(b"jp2h", ihdr + colr) + F._box(b"jp2c", cs),
        "no_jp2h": ftyp + F._box(b"jp2c", cs),
        "no_ihdr": ftyp + F._box(b"jp2h", colr) + F._box(b"jp2c", cs),
        "ihdr_size": ftyp + F._box(b"jp2h", F._box(b"ihdr", struct.pack(
            ">IIHBBBB", 21, 30, 3, 7, 7, 0, 0)) + colr) + F._box(b"jp2c", cs),
    }[kind]


def _cut(data, percent):
    return data[:len(data) * percent // 100]


_SIZ_FIELDS = ("Rsiz", "Xsiz", "Ysiz", "XOsiz", "YOsiz", "XTsiz", "YTsiz",
               "XTOsiz", "YTOsiz")


def _j2k_siz(**fields):
    """A Pillow codestream whose SIZ fields are changed: each offset added
    to the image (or tile grid) size too, as a writer lays them out."""
    import struct

    data = bytearray(_pil_j2k(_rgb(24, 32, 145), no_jp2=True))
    vals = list(struct.unpack_from(">HIIIIIIII", data, 6))
    for k, v in fields.items():
        i = _SIZ_FIELDS.index(k)
        vals[i] = v
        if k in ("XOsiz", "YOsiz"):
            vals[i - 2] += v
    struct.pack_into(">HIIIIIIII", data, 6, *vals)
    return bytes(data)


def _j2k_cap():
    """A Pillow codestream with a CAP marker after SIZ."""
    data = _pil_j2k(_rgb(24, 32, 146), no_jp2=True)
    end = 4 + int.from_bytes(data[4:6], "big")
    return data[:end] + b"\xff\x50\x00\x08\x00\x02\x00\x00\x00\x00" + (
        data[end:])


def _j2k_cblksty(sty):
    """A Pillow codestream whose COD names code-block style sty."""
    data = bytearray(_pil_j2k(_rgb(24, 32, 147), no_jp2=True))
    cod = data.index(b"\xff\x52")
    data[cod + 12] = sty  # Lcod, Scod, SGcod (4), NL, xcb, ycb, style
    return bytes(data)


def _hdr_layout(line):
    """A Radiance HDR whose size line is ``line`` (20 rows of 24)."""
    return _cv2_write(".hdr", _rgb(20, 24, 92)).replace(b"-Y 20 +X 24",
                                                        line)


def _vp8l_version(v):
    """A lossless WebP whose header names version v."""
    data = bytearray(_cv2_write(".webp", _rgb(6, 7, 93)))
    data[24] = data[24] & 0x1F | v << 5  # VP8L header byte 4
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


@pytest.mark.parametrize("kind", ["disposal_4", "control_of_5_bytes",
                                  "xmp_three_bytes",
                                  "xmp_three_bytes_after_first_frame"])
def test_gif_extensions_cv2_reads_nothing_of_are_errors(kind, tmp_path):
    """A graphic control extension before the first frame of other than 4
    bytes or of a disposal method above 3, an application extension other
    than NETSCAPE2.0's with a 3-byte data sub-block: cv2.imread returns
    nothing, the port raises ValueError naming the path."""
    p = tmp_path / f"{kind}.gif"
    p.write_bytes(_gif_extension(kind))
    assert cv2.imread(str(p)) is None, kind
    with pytest.raises(ValueError, match=f"{kind}.gif"):
        image_io.imread_rgb(str(p))


@pytest.mark.parametrize("append", [0, 255])
def test_gif_lzw_data_past_the_end_code_is_an_error(append, tmp_path):
    """LZW data that goes on past the code after the frame's last pixel
    (here the end code): cv2.imread returns nothing, the port raises
    ValueError naming the path."""
    p = tmp_path / f"after_end_{append}.gif"
    p.write_bytes(_gif_lzw_tail("gif_offset_background", append=append))
    assert cv2.imread(str(p)) is None
    with pytest.raises(ValueError, match=f"after_end_{append}.gif"):
        image_io.imread_rgb(str(p))


def test_malformed_files_are_errors_not_images(tmp_path):
    """A file cut short raises (ValueError naming the path), as cv2.imread
    returns nothing for it."""
    cut = {name: CASES[name]()
           for name in ("bmp24_cv2", "p6_16bit", "sun8_grey", "tiff_cv2_c5",
                        "bmp_rle8", "gif_cv2", "hdr_cv2_rle",
                        "webp_cv2_lossless", "webp_cv2_lossy_q90",
                        "webp_lossy_alpha")}
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
    "gif89a_interlaced.gif": "gif89a_interlaced",
    "gif_transparent.gif": "gif_transparent",
    "hdr_cv2_rle.hdr": "hdr_cv2_rle",
    "hdr_cv2_flat.hdr": "hdr_cv2_flat",
    "webp_cv2_lossless.webp": "webp_cv2_lossless",
    "webp_cv2_lossy_q90.webp": "webp_cv2_lossy_q90",
    "webp_lossy_alpha.webp": "webp_lossy_alpha",
    "webp_animated_frame_offset.webp": "webp_animated_frame_offset",
    "jpeg2000_jp2_97.jp2": "jpeg2000_jp2_97",
    "jpeg2000_grey16.jp2": "jpeg2000_grey16",
    "jpeg2000_tiles_32.jp2": "jpeg2000_tiles_32",
    "jpeg2000_random_every_style_bit_97.j2k":
        "jpeg2000_random_every_style_bit_97",
    "jpeg2000_random_ppm.j2k": "jpeg2000_random_ppm",
    "jpeg2000_random_sycc.jp2": "jpeg2000_random_sycc",
    # TIFF's other codings (tests/test_torch_tiff.py's cases)
    "tiff_jpeg_ycbcr_420_tiles.tif": "jpeg_ycbcr_420_tiles",
    "tiff_jpeg_pil_rgb.tif": "jpeg_pil_rgb",
    "tiff_ycbcr_44_tiles_right_edge.tif": "ycbcr_44_tiles_right_edge",
    "tiff_ycbcr_42_lzw.tif": "ycbcr_42_lzw",
    "tiff_cmyk_planar.tif": "cmyk_planar",
    "tiff_lab_white_point_d65.tif": "lab_white_point_d65",
    "tiff_lab16_big_endian.tif": "lab16_big_endian",
    "tiff_ccitt_g3_2d_fill_bits_fill2.tif": "ccitt_g3_2d_fill_bits_fill2",
    "tiff_ccitt_g4_wide.tif": "ccitt_g4_wide",
    "tiff_ccitt_rle_fill1.tif": "ccitt_rle_fill1",
    "bigtiff_lzw_tiles_big_endian.tif": "bigtiff_lzw_tiles_big_endian",
    "tiff_tiles_orientation_6_ycbcr_44.tif": "tiles_orientation_6_ycbcr_44",
    "avif_cv2_10bit.avif": "avif_cv2_10bit",
    "avif_cv2_grey_12bit.avif": "avif_cv2_grey_12bit",
    "avif_pil_422.avif": "avif_pil_422",
    "avif_pil_rgba.avif": "avif_pil_rgba",
    "avif_pil_sb128_tiles.avif": "avif_pil_sb128_tiles",
    "avif_pil_lr_switchable.avif": "avif_pil_lr_switchable",
    "avif_pil_film_grain.avif": "avif_pil_film_grain",
    "avif_pil_palette.avif": "avif_pil_palette",
    "avif_pil_intrabc.avif": "avif_pil_intrabc",
    "avif_pil_sequence_rgba.avif": "avif_pil_sequence_rgba",
    "avif_cv2_sequence_10bit.avif": "avif_cv2_sequence_10bit",
    "avif_layered_a1lx_lsel_a1op.avif": "avif_layered_a1lx_lsel_a1op",
}


def _case(name) -> bytes:
    """The bytes of a variant of this file's CASES or of
    tests/test_torch_tiff.py's."""
    return CASES[name]() if name in CASES else _tiff_test().CASES[name]()


def _large_tiff(k, size=64):
    from tests.test_torch_zju_codec import smooth_image

    img = smooth_image(size, size, seed=k)
    return _cv2_write(".tif", np.ascontiguousarray(img[..., ::-1]),
                      (cv2.IMWRITE_TIFF_COMPRESSION, k))


def _lossy_1024():
    """The 1024x1024 q95 fixture JPEG's decode as cv2's q90 lossy WebP."""
    jpeg = os.path.join(os.path.dirname(FIXTURES), "torch_zju",
                        "cv2_q95_420.jpg")
    return _cv2_write(".webp", cv2.imread(jpeg),
                      (cv2.IMWRITE_WEBP_QUALITY, 90))


def _jpeg_tiff_1024():
    """The 1024x1024 q95 fixture JPEG's decode as a JPEG-compressed TIFF
    of the same coding: YCbCr 4:2:0 in strips of 16 rows (libtiff's
    default height for such a strip), each cv2's q95 JPEG after one
    JPEGTables stream (Pillow writes JPEG-TIFFs only at 4:4:4)."""
    jpeg = os.path.join(os.path.dirname(FIXTURES), "torch_zju",
                        "cv2_q95_420.jpg")
    return _tiff_test()._jpeg_tiff(cv2_imread(jpeg), rows_per_strip=16,
                                   quality=95)


def _jp2_1024(x1000):
    """The 1024x1024 q95 fixture JPEG's decode as cv2's JP2: lossless (5/3)
    at a compression of 1000, lossy (9/7) below."""
    jpeg = os.path.join(os.path.dirname(FIXTURES), "torch_zju",
                        "cv2_q95_420.jpg")
    return _cv2_write(".jp2", cv2.imread(jpeg),
                      (cv2.IMWRITE_JPEG2000_COMPRESSION_X1000, x1000))


# what phase e times: the LZW and Deflate TIFFs in cv2's layout (strips of
# 8 KiB of raw rows), and 1024x1024 lossy WebP, lossless and lossy JP2 and
# YCbCr 4:2:0 JPEG-TIFF frames (which no numpy writer makes on the card
# machine)
def _avif_1024(**kw):
    """The 1024x1024 q95 fixture JPEG's decode as cv2's AVIF (default
    quality, q95, or 10 bits)."""
    jpeg = os.path.join(os.path.dirname(FIXTURES), "torch_zju",
                        "cv2_q95_420.jpg")
    img = cv2.imread(jpeg)
    if kw.get("depth") == 10:
        img = img.astype(np.uint16) << 2
    return AV.cv2_avif(img, **kw)


def _avif_sequence_1024():
    """The 1024x1024 q95 fixture JPEG's decode (the source of
    cv2_default_1024.avif) as cv2's two-frame AVIF sequence, the second
    frame shifted 4 pixels to the right (an inter frame)."""
    jpeg = os.path.join(os.path.dirname(FIXTURES), "torch_zju",
                        "cv2_q95_420.jpg")
    img = cv2.imread(jpeg)
    return AV.cv2_sequence([img, np.ascontiguousarray(np.roll(img, 4, 1))])


def _avif_crop(h, w, y, x, depth=8):
    """cv2's AVIF of an h x w crop of the fixture JPEG's decode at (y, x)."""
    img = np.ascontiguousarray(_fixture_rgb()[y:y + h, x:x + w, ::-1])
    if depth > 8:
        return AV.cv2_avif(img.astype(np.uint16) << (depth - 8), depth=depth)
    return AV.cv2_avif(img)


def _avif_grid(side):
    """A 2x2 grid AVIF of cv2's side x side tiles of the fixture JPEG's
    decode (the top left 2 side x 2 side of it)."""
    tiles = [_avif_crop(side, side, r, c) for r in (0, side)
             for c in (0, side)]
    return AV.as_grid(tiles[0], 2, 2, tiles=tiles)


def _avif_ispe(data, w, h):
    """data with its primary item's ispe set to w x h (libavif scales the
    frame to it)."""
    heif = AV.Heif(data)
    heif.set_prop(heif.primary, b"ispe", b"\0" * 4 + struct.pack(">II", w, h))
    return bytes(heif)


LARGE = {"cv2_jpeg_420_1024.tif": lambda: _jpeg_tiff_1024(),
         "cv2_default_1024.avif": lambda: _avif_1024(),
         "cv2_q95_1024.avif": lambda: _avif_1024(quality=95),
         "cv2_10bit_1024.avif": lambda: _avif_1024(depth=10),
         # Pillow's, with loop restoration (a switchable chroma plane) and
         # with film grain (test vector 1)
         "pil_lr_1024.avif": lambda: AV.pil_avif(_fixture_rgb(), quality=90,
                                                 speed=4),
         "pil_grain_1024.avif": lambda: AV.pil_avif(
             _fixture_rgb(), quality=75, speed=6,
             advanced={"film-grain-test": "1"}),
         # a screen capture of text, screen-tuned: palettes and intra
         # block copy
         "pil_screen_1024.avif": lambda: AV.pil_avif(
             AV.screen_rgb(1024, 1024, 25, rects=6), quality=60, speed=6,
             advanced={"tune-content": "screen"}),
         # a grid of four 512x512 tiles; a small grid, an ispe scaling
         # 100x80 by 3/4, chroma-derived NCL of BT.470M primaries, and
         # matrix coefficients 15 at 10 bits
         "cv2_grid_1024.avif": lambda: _avif_grid(512),
         # a two-frame sequence of cv2_default_1024.avif's source
         "cv2_sequence_1024.avif": _avif_sequence_1024,
         "avif_grid_2x2.avif": lambda: _avif_grid(64),
         "avif_ispe_75x60.avif": lambda: _avif_ispe(
             _avif_crop(80, 100, 300, 400), 75, 60),
         "avif_mc12_cp4.avif": lambda: AV.set_nclx(
             _avif_crop(48, 64, 500, 200), cp=4, mc=12),
         "avif_mc15_10bit.avif": lambda: AV.set_nclx(
             _avif_crop(48, 64, 600, 600, depth=10), cp=9, mc=15, full=0),
         "cv2_lzw_64.tif": lambda: _large_tiff(5),
         "cv2_deflate_64.tif": lambda: _large_tiff(8),
         "cv2_q90_1024.webp": _lossy_1024,
         "cv2_lossless_1024.jp2": lambda: _jp2_1024(1000),
         "cv2_lossy_1024.jp2": lambda: _jp2_1024(50)}


# GIF files of tests/_torch_gif_mutations.py, (seed, index) of its stream,
# that the port read otherwise than cv2.imread before its LZW decoder
# followed cv2 past end codes and after the frame's last pixel (fault F2);
# each is kept with cv2's reading in gif_lzw_mutations.json
GIF_LZW_MUTATIONS = os.path.join(FIXTURES, "gif_lzw_mutations.json")
GIF_LZW_RESIDUALS = ((17, 662), (17, 824), (17, 1587), (17, 2696), (99, 0),
                     (99, 248), (99, 608), (99, 2752), (2024, 2678))


def make_gif_lzw_fixtures(out=FIXTURES) -> dict:
    """Write the GIF_LZW_RESIDUALS files and gif_lzw_mutations.json (cv2's
    reading of each: the digest of its array, or None)."""
    from tests._torch_gif_mutations import mutations

    readings = {}
    for seed, index in GIF_LZW_RESIDUALS:
        case, data = list(mutations(index + 1, seed))[index]
        name = f"gif_lzw_mutation_{seed}_{index}.gif"  # the test's names
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2_imread(path)
        readings[name] = {"case": case, "seed": seed, "index": index,
                          "cv2": None if img is None else {
                              "sha256": hashlib.sha256(
                                  img.tobytes()).hexdigest(),
                              "shape": list(img.shape)}}
    with open(os.path.join(out, "gif_lzw_mutations.json"), "w") as f:
        json.dump(readings, f, indent=1, sort_keys=True)
    return readings


def _gif_lzw_mutations() -> dict:
    with open(GIF_LZW_MUTATIONS) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [f"gif_lzw_mutation_{seed}_{index}.gif"
                                  for seed, index in GIF_LZW_RESIDUALS])
def test_gif_lzw_mutations_read_as_cv2_imread(name):
    """The committed GIF mutations of fault F2 (an end code with codes
    after it, in its byte or the next; codes after the frame's last pixel)
    read as cv2.imread reads them: the same array, or nothing (the port
    raising, naming the path)."""
    want = _gif_lzw_mutations()[name]["cv2"]
    path = os.path.join(FIXTURES, name)
    if want is None:
        assert cv2_imread(path) is None, name
        with pytest.raises((ValueError, FileNotFoundError), match=name):
            image_io.imread_rgb(path)
        return
    got = image_io.imread_rgb(path)
    assert list(got.shape) == want["shape"], name
    assert hashlib.sha256(got.tobytes()).hexdigest() == want["sha256"], name
    _same(got, cv2_imread(path), name)


def make_fixtures(out=FIXTURES) -> dict:
    """Write the fixtures and digests.json (cv2.imread's arrays), and the
    GIF LZW mutations with gif_lzw_mutations.json."""
    make_gif_lzw_fixtures(out)
    os.makedirs(out, exist_ok=True)
    files = {name: _case(case) for name, case in FIXTURE_CASES.items()}
    files.update({name: make() for name, make in LARGE.items()})
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


def _traced(fn):
    """fn() and the count of Python trace events while it ran."""
    import sys

    events = [0]

    def trace(frame, event, arg):
        events[0] += 1
        return trace

    sys.settrace(trace)
    try:
        out = fn()
    finally:
        sys.settrace(None)
    return out, events[0]


# a 1024x1024 frame of each new decoder: GIF, Radiance HDR, WebP
BIG_FRAMES = {
    "gif": lambda img: _cv2_write(".gif", img),
    "hdr_rle": lambda img: _cv2_write(".hdr", img),
    "webp_lossless": lambda img: _cv2_write(".webp", img),
    "webp_lossy_q90": lambda img: _cv2_write(
        ".webp", img, (cv2.IMWRITE_WEBP_QUALITY, 90)),
    # TIFF's other codings: JPEG (4:2:0 in strips of 64 rows), CCITT
    # Group 4, LZW-coded 2x2 YCbCr tiles, CMYK, CIELab, BigTIFF
    "tiff_jpeg_420": lambda img: _tiff_test()._jpeg_tiff(
        img, rows_per_strip=64),
    "tiff_ccitt_g4": lambda img: _tiff_test()._pil(
        img[..., 0] > 128, "1", compression="group4"),
    "tiff_ycbcr_22_lzw_tiles": lambda img: _tiff_test()._ycbcr_tiff(
        img, (2, 2), compression=5, tile=(256, 256)),
    "tiff_cmyk_lzw": lambda img: _tiff_test()._pil(
        img, "CMYK", compression="tiff_lzw"),
    "tiff_cielab": lambda img: _tiff_test()._pil(img, "LAB"),
    "bigtiff_deflate": lambda img: _tiff_test()._pil(
        img, "RGB", big_tiff=True, compression="tiff_adobe_deflate"),
}


def _tiff_test():
    from tests import test_torch_tiff

    return test_torch_tiff


@pytest.mark.parametrize("k", [5, 8, 32773, *sorted(BIG_FRAMES)])
def test_no_frame_decode_loops_over_bytes_in_python(k, tmp_path):
    """The byte-serial codings run in the C++ codec (zlib for Deflate): a
    1024x1024 TIFF of cv2's layout (512 strips) and a 1024x1024 RLE8 BMP
    decode with Python line events a few per strip, far fewer than bytes;
    a 1024x1024 GIF, HDR or WebP frame (LZW, run-length scanlines, every
    stage of both WebP decoders) or TIFF of another coding (JPEG, CCITT,
    subsampled YCbCr, CMYK, CIELab, BigTIFF) with a few hundred at most."""
    if k in BIG_FRAMES:
        from tests.test_torch_zju_codec import smooth_image

        p = tmp_path / k
        p.write_bytes(BIG_FRAMES[k](smooth_image(1024, 1024, seed=6)))
        img, events = _traced(lambda: image_io.imread_rgb(str(p)))
        _same(img, cv2_imread(p), k)
        # against 3 MiB of samples; a TIFF a hundred more a strip or tile
        chunks = 0
        if "tif" in k:
            t = image_formats._ifd(p.read_bytes(), k)
            chunks = len(t.get(273, t.get(324, ())))
        assert events < 2000 + 100 * chunks, (events, chunks)
        return
    p = tmp_path / "big.tif"
    p.write_bytes(_large_tiff(k, 1024))
    idx = _idx(1024, 1024, 7, 90)
    rle = F.bmp(idx, 8, palette=_pal(256, 90), compression=1)
    (tif, bmp), events = _traced(lambda: (image_io.imread_rgb(str(p)),
                                          image_formats.decode_bmp(rle)))
    _same(tif, cv2_imread(p))
    _same(bmp, cv2.cvtColor(cv2.imdecode(np.frombuffer(rle, np.uint8),
                                         cv2.IMREAD_COLOR),
                            cv2.COLOR_BGR2RGB))
    assert events < 100 * 512, events  # against 3 MiB of samples


# ------------------------------------------ a ZJU tree of mixed formats
def _encode_frame(img, kind):
    if kind == "tiff_jpeg_420":
        return _tiff_test()._jpeg_tiff(img, rows_per_strip=16)
    if kind == "webp_lossy":
        return _cv2_write(".webp", img[..., ::-1],
                          (cv2.IMWRITE_WEBP_QUALITY, 90))
    if kind.startswith("avif_"):
        bgr = np.ascontiguousarray(img[..., ::-1])
        if kind == "avif_cv2_10bit":
            return AV.cv2_avif(bgr.astype(np.uint16) << 2, depth=10)
        if kind == "avif_pil_444_screen":
            return AV.pil_avif(img, subsampling="4:4:4", speed=8,
                               advanced={"tune-content": "screen"})
        # sequences: the frame, then it upside down (an inter frame)
        flip = np.ascontiguousarray(bgr[::-1])
        if kind == "avif_cv2_sequence":
            return AV.cv2_sequence([bgr, flip])
        if kind == "avif_cv2_sequence_10bit":
            return AV.cv2_sequence([bgr.astype(np.uint16) << 2,
                                    flip.astype(np.uint16) << 2], depth=10)
        if kind == "avif_pil_sequence_rgba":
            a = _rng(180).integers(0, 256, img.shape[:2] + (1,), np.uint8)
            rgba = np.concatenate([img, a], -1)
            return AV.pil_sequence([rgba, np.ascontiguousarray(rgba[::-1])])
        return AV.cv2_avif(bgr)
    if kind.startswith("jp2_"):
        return _cv2_write(".jp2", img[..., ::-1], (
            cv2.IMWRITE_JPEG2000_COMPRESSION_X1000,
            1000 if kind == "jp2_lossless" else 100))
    return F.encode_frame(img, kind)


# cameras of the mixed-format tree: one a coding of a frame
FORMAT_CAMS = len(F.FRAME_FORMATS[0][1])


@pytest.fixture(scope="module")
def zju_formats_root(tmp_path_factory):
    """tests/test_torch_zju.py's fake human (jitter-free JPEG frames) on
    FORMAT_CAMS cameras, each frame then re-coded (F.FRAME_FORMATS), named
    by the frame's extension: frame 0 as BMPs (24-bit, RLE8, 5-6-5), a
    lossy JP2, a GIF and cv2's AVIF, 1 as TIFFs (JPEG 4:2:0 in strips,
    CMYK in Deflate tiles, a 16-bit LZW BigTIFF), a lossless JP2, a
    lossless WebP and cv2's 10-bit AVIF, 2 as a PPM, a Radiance HDR, Sun
    rasters (24-bit, 8-bit colour map), a lossy WebP and Pillow's 4:4:4
    screen-tuned AVIF (its blocks palettes); the last camera's frames are
    AVIF image sequences: cv2's 8-bit and 10-bit ones, and Pillow's RGBA
    one with its alpha track."""
    from tests.test_torch_zju import HUMAN, NF, write_fake_zju

    root = str(tmp_path_factory.mktemp("zju_formats"))
    write_fake_zju(root, n_cams=FORMAT_CAMS, seed=3)
    annots_path = os.path.join(root, HUMAN, "annots.npy")
    annots = np.load(annots_path, allow_pickle=True).item()
    for f in range(NF):
        ext, kinds = F.FRAME_FORMATS[f]
        names = []
        for c in range(FORMAT_CAMS):
            old = os.path.join(root, HUMAN, f"Camera_B{c + 1}", f"{f:06d}.jpg")
            img = cv2_imread(old)
            os.remove(old)
            with open(old[:-4] + ext, "wb") as fh:
                fh.write(_encode_frame(img, kinds[c]))
            names.append(f"Camera_B{c + 1}/{f:06d}{ext}")
        annots["ims"][f]["ims"] = names
    np.save(annots_path, annots)
    return root


def test_mixed_format_frames_are_on_disk_and_read_as_cv2(zju_formats_root):
    from tests.test_torch_zju import HUMAN, NF

    seen = set()
    for f in range(NF):
        ext, _ = F.FRAME_FORMATS[f]
        for c in range(FORMAT_CAMS):
            p = os.path.join(zju_formats_root, HUMAN, f"Camera_B{c + 1}",
                             f"{f:06d}{ext}")
            with open(p, "rb") as fh:
                seen.add(image_formats.sniff(fh.read(16)))
            _same(image_io.imread_rgb(p), cv2_imread(p), p)
    assert seen == {"bmp", "tiff", "pxm", "sun", "gif", "hdr", "webp",
                    "jpeg2000", "avif"}


def test_mixed_format_items_equal_the_jax_dataset(zju_formats_root):
    """Every train sample (jitter off) and eval item of the tree through
    the port's loader and the JAX package's (cv2.imread): images within
    1e-6, everything else exact."""
    from tests.test_torch_zju import (
        IMG_TOL,
        NF,
        _pair,
        _same_eval_item,
        _same_frame,
        _same_rays,
    )

    j, t = _pair(zju_formats_root, "train", ["jitter", "False"])
    assert len(t) == len(j) == NF * FORMAT_CAMS
    for index in range(NF * FORMAT_CAMS):
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


@pytest.mark.parametrize("ext", [".webp", ".jpeg", ".tiff"])
def test_a_four_letter_extension_fails_both_loaders_alike(tmp_path, ext):
    """Both loaders read a frame's index from its file name less 4
    characters (transhuman_tpu/data/zju.py:193): a frame named with a
    4-letter extension fails both, with the same error, however its
    content decodes."""
    from tests import test_torch_zju as tz

    root = str(tmp_path)
    tz.write_fake_zju(root, seed=4)
    annots_path = os.path.join(root, tz.HUMAN, "annots.npy")
    annots = np.load(annots_path, allow_pickle=True).item()
    names = annots["ims"][0]["ims"]
    for c, name in enumerate(names):
        os.rename(os.path.join(root, tz.HUMAN, name),
                  os.path.join(root, tz.HUMAN, name[:-4] + ext))
        names[c] = name[:-4] + ext
    np.save(annots_path, annots)
    opts = tz._opts(root)
    errors = []
    for make in (lambda: tz.JZJU(tz.JConfig().merge_opts(opts), "train",
                                 smpl=tz.JSMPL.synthetic(n_verts=tz.NV),
                                 human_info=tz.INFO),
                 lambda: tz.ZJUDataset(tz.Config().merge_opts(opts), "train",
                                       smpl=tz.SMPLModel.synthetic(
                                           n_verts=tz.NV),
                                       human_info=tz.INFO)):
        with pytest.raises(ValueError) as e:
            make()
        errors.append(str(e.value))
    assert errors[0] == errors[1], errors


if __name__ == "__main__":
    print(json.dumps(make_fixtures(), indent=1))
