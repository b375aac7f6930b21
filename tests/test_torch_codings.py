"""The port's codec (native/imgcodec.cc through data/image_io.py) on the
codings beyond baseline JPEG, each bit for bit against the JAX package's
readers: ``cv2.imread`` + BGR -> RGB for frames (progressive JPEGs, files
cut after a scan or inside one, CMYK and YCCK, EXIF orientations, PNG
frames of every colour type and depth) and ``imageio.v2.imread`` for masks
(Adam7 PNGs).
What the codec still refuses is held in test_torch_zju_codec.py's
``test_refusals_are_named``.

The fixtures in tests/fixtures/torch_zju_codings/ are made by
``make_fixtures`` below (``python -m tests.test_torch_codings`` from the
repository root remakes them); ``digests.json`` holds the sha256 of cv2's or
imageio's decode of each, which chip_smoke.py phase e holds the card
machine's decode against.
"""

import io
import json
import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from tests._torch_codings import (
    PNG_CHANNELS,
    PNG_TYPES,
    SAMPLINGS,
    cmyk_jpeg,
    cut_after_scans,
    cv2_progressive,
    encode_png,
    exif_tiff,
    pil_jpeg,
    png_chunk,
    random_png,
    scan_ends,
    with_app1,
    with_exif,
)
from tests.test_torch_zju_codec import (
    _mask_disc,
    _png_cases,
    cv2_decode,
    sha256,
    smooth_image,
)
from transhuman_tpu_torch.data import image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_zju_codings")
SIZES = [(37, 53), (1, 1), (8, 8), (17, 9), (24, 40), (64, 48), (96, 71)]


def _same(got, want, what=""):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    # bit for bit: the count of differing values is 0
    assert int((got != want).sum()) == 0, what


# ----------------------------------------------------- progressive JPEG
@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 90, 95])
def test_pil_progressive_jpegs_decode_as_cv2(quality, subsampling, optimize):
    for hw in SIZES:
        img = smooth_image(*hw, seed=hw[0] * 7 + hw[1], noise=10.0)
        data = pil_jpeg(img, quality, subsampling, progressive=True,
                        optimize=optimize)
        assert data[data.index(b"\xff\xc2"):][:2] == b"\xff\xc2"
        _same(image_io.decode_jpeg(data), cv2_decode(data), hw)


@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
def test_cv2_progressive_jpegs_decode_as_cv2(sampling, restart):
    for hw in SIZES:
        img = smooth_image(*hw, seed=hw[0] * 5 + hw[1], noise=10.0)
        for quality in (40, 95):
            data = cv2_progressive(img, quality, sampling, restart)
            _same(image_io.decode_jpeg(data), cv2_decode(data),
                  (hw, quality))


def test_grey_progressive_jpegs_decode_as_cv2():
    for hw in SIZES:
        g = smooth_image(*hw, seed=3, noise=10.0)[..., 1]
        for kw in ({}, {"optimize": True}):
            data = pil_jpeg(g, 90, 0, mode="L", progressive=True, **kw)
            got = image_io.decode_jpeg(data)
            _same(got, cv2_decode(data), hw)
            assert (got[..., 0] == got[..., 2]).all()


# the same file cut after each k of its scans: libjpeg-turbo smooths the
# blocks whose first AC coefficients are still imprecise
TRUNCATED = ["pil_444", "pil_422", "pil_420", "cv2_440", "cv2_411_rst",
             "grey", "cmyk"]


def _truncation_source(name, img):
    if name.startswith("pil_"):
        sub = {"444": 0, "422": 1, "420": 2}[name[4:]]
        return pil_jpeg(img, 90, sub, progressive=True)
    if name == "grey":
        return pil_jpeg(img[..., 0], 75, 0, mode="L", progressive=True)
    if name == "cmyk":
        return cmyk_jpeg(np.concatenate([img, img[..., :1]], -1),
                         progressive=True)
    return cv2_progressive(img, 90, name[4:7], 3 if "rst" in name else 0)


@pytest.mark.parametrize("name", TRUNCATED)
def test_truncated_progressive_jpegs_decode_as_cv2(name):
    for hw in [(37, 53), (17, 9), (24, 40), (9, 17), (16, 16), (61, 33)]:
        img = smooth_image(*hw, seed=hw[0] + hw[1], noise=10.0)
        data = _truncation_source(name, img)
        n = len(scan_ends(data))
        assert n >= 6
        for k in range(1, n):
            cut = cut_after_scans(data, k)
            _same(image_io.decode_jpeg(cut), cv2_decode(cut), (hw, k, n))


# a file cut inside a scan's coded data (a download cut short), closed by
# an EOI or not: libjpeg decodes the MCU where the data runs out on zero
# bits and skips the segment's later MCUs; cv2.imread reads such a file
# (cv2.imdecode refuses it without the EOI), so the reference reads a file
CUT_SOURCES = ["pil_seq", "cv2_restart", "cv2_prog_420", "pil_prog_opt",
               "grey_prog", "ycck_prog"]


def _cut_source(name, img, rng):
    if name == "pil_seq":
        return pil_jpeg(img, 90, int(rng.integers(0, 3)))
    if name == "cv2_restart":
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]),
                               [cv2.IMWRITE_JPEG_RST_INTERVAL, 2])
        return buf.tobytes()
    if name == "cv2_prog_420":
        return cv2_progressive(img, 90, "420")
    if name == "pil_prog_opt":
        return pil_jpeg(img, 85, 2, progressive=True, optimize=True)
    if name == "grey_prog":
        return pil_jpeg(img[..., 0].copy(), 85, 0, mode="L",
                        progressive=True)
    return cmyk_jpeg(np.concatenate([img, img[..., :1]], -1), "ycck", 85,
                     progressive=True)


@pytest.mark.parametrize("eoi", [False, True])
@pytest.mark.parametrize("name", CUT_SOURCES)
def test_jpegs_cut_inside_a_scan_read_as_cv2(name, eoi, tmp_path):
    rng = np.random.default_rng(len(name) * 7 + eoi)
    path = str(tmp_path / "cut.jpg")
    for t in range(8):
        hw = tuple(int(x) for x in rng.integers(8, 90, 2))
        data = _cut_source(name, smooth_image(*hw, seed=t, noise=10.0), rng)
        ends = scan_ends(data)
        k = int(rng.integers(0, len(ends)))
        sos = data.rfind(b"\xff\xda", 0, ends[k])
        start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
        cut = int(rng.integers(start + 1, ends[k]))
        with open(path, "wb") as f:
            f.write(data[:cut] + (b"\xff\xd9" if eoi else b""))
        want = cv2.imread(path)
        assert want is not None
        _same(image_io.imread_rgb(path),
              cv2.cvtColor(want, cv2.COLOR_BGR2RGB), (hw, k, cut))


# ----------------------------------------------------------- CMYK, YCCK
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("variant", ["adobe", "plain", "ycck"])
def test_four_component_jpegs_decode_as_cv2(variant, progressive):
    """Adobe transform 0 (CMYK), no Adobe marker (CMYK), transform 2
    (YCCK); OpenCV's own CMYK -> BGR after libjpeg's output."""
    for hw in [(37, 53), (8, 8), (1, 1), (40, 17)]:
        rng = np.random.default_rng(hw[0])
        cmyk = np.concatenate([smooth_image(*hw, seed=hw[1], noise=8.0),
                               rng.integers(0, 256, (*hw, 1), np.uint8)], -1)
        for quality in (60, 95):
            data = cmyk_jpeg(cmyk, variant, quality, progressive)
            _same(image_io.decode_jpeg(data), cv2_decode(data), hw)


# ------------------------------------------------------ EXIF orientation
@pytest.mark.parametrize("orientation", range(10))
def test_exif_orientation_as_cv2(orientation, tmp_path):
    """Flips for 2 and 4, 180 degrees for 3, transposes (H and W swap) for
    5-8; 0 and 9 leave the image as it is; through a file as JAX's
    _imread_rgb reads one."""
    img = smooth_image(24, 40, seed=orientation, noise=10.0)
    for data in (pil_jpeg(img, 90, 2),
                 cv2_progressive(img, 90, "422")):
        rotated = with_exif(data, orientation,
                            little_endian=orientation % 2 == 0)
        p = str(tmp_path / "r.jpg")
        with open(p, "wb") as f:
            f.write(rotated)
        want = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        assert want.shape[:2] == ((40, 24) if 5 <= orientation <= 8
                                  else (24, 40))
        _same(image_io.imread_rgb(p), want, orientation)


def test_exif_segments_are_read_as_cv2_reads_them():
    """The first segment whose IFD0 holds the tag sets the orientation,
    whatever its value; no valid TIFF header, another tag, a short IFD, a
    32-bit value in big-endian order, or an APP1 after the tables: as
    OpenCV takes each."""
    data = pil_jpeg(smooth_image(16, 24, seed=2, noise=10.0), 90, 0)
    ifd2 = (b"II*\0\x08\0\0\0\x02\0" + b"\x0f\x01\x03\0\x01\0\0\0\x01\0\0\0"
            + b"\x12\x01\x03\0\x01\0\0\0\x08\0\0\0")
    sof = data.index(b"\xff\xc0")
    late = with_app1(b"\xff\xd8", b"Exif\0\0" + exif_tiff(6))[2:]
    cases = {
        "first_wins": with_exif(with_exif(data, 6), 3),
        "untagged_first": with_app1(with_exif(data, 6),
                                    b"Exif\0\0" + exif_tiff(6)[:8]
                                    + b"\0\0\0\0"),
        "bad_magic_first": with_app1(with_exif(data, 6), b"Exif\0\0II+\0"
                                     + exif_tiff(3)[4:]),
        "zero_first": with_exif(with_exif(data, 6), 0),
        "xmp_first": with_app1(with_exif(data, 8),
                               b"http://ns.adobe.com/xap/1.0/\0<x/>"),
        "second_entry": with_app1(data, b"Exif\0\0" + ifd2),
        "short_ifd": with_app1(data, b"Exif\0\0II*\0\x08\0\0\0\x05\0"
                               + b"\x12\x01\x03\0\x01\0\0\0\x05\0"),
        "long_big_endian": with_app1(data, b"Exif\0\0MM\0*\0\0\0\x08\0\x01"
                                     + b"\x01\x12\0\x04\0\0\0\x01\0\0\0\x06"
                                     + b"\0\0\0\0"),
        "broken_ifd": with_app1(data, b"Exif\0\0II*\0\xff\xff\0\0"),
        "not_exif": with_app1(data, b"Exif\0\xff" + exif_tiff(6)),
        "after_tables": data[:sof] + late + data[sof:],
    }
    for name, case in cases.items():
        _same(image_io.decode_jpeg(case), cv2_decode(case), name)
    assert image_io.decode_jpeg(cases["second_entry"]).shape[:2] == (24, 16)


# ------------------------------------------------------------ PNG frames
@pytest.mark.parametrize("ctype_depth", PNG_TYPES)
def test_png_frames_read_as_cv2(ctype_depth, tmp_path):
    """Three uint8 channels: grey replicated, a palette applied (tRNS
    ignored), alpha dropped, low-depth grey scaled, 16 bits cut to the
    high byte; read from a file whose name says .jpg, by signature."""
    ctype, depth = ctype_depth
    rng = np.random.default_rng(ctype * 17 + depth)
    for hw in [(23, 37), (1, 1), (5, 9)]:
        data = random_png(rng, *hw, ctype, depth)
        p = str(tmp_path / "frame.jpg")
        with open(p, "wb") as f:
            f.write(data)
        want = cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
        _same(image_io.imread_rgb(p), want, hw)


def test_png_cases_read_as_cv2(tmp_path):
    """The mask tests' Pillow- and cv2-written PNGs as frames."""
    for name, path in _png_cases(tmp_path).items():
        want = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        _same(image_io.imread_rgb(path), want, name)


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_png_exif_orientation_as_cv2(orientation):
    """cv2 applies an eXIf chunk's orientation, before or after IDAT;
    imageio does not."""
    img = np.random.default_rng(orientation).integers(0, 256, (6, 9, 3))
    tiff = png_chunk(b"eXIf", exif_tiff(orientation))
    for where in ("chunks", "chunks_after"):
        data = encode_png(img, 8, 2, **{where: tiff})
        _same(image_io.decode_png_rgb(data), cv2_decode(data), where)
        _same(image_io.decode_png(data),
              np.asarray(imageio.imread(io.BytesIO(data))), where)


def test_png_exif_chunks_are_chosen_as_libpng_chooses():
    """The first eXIf chunk that starts as TIFF does counts, tagged or
    not; an "Exif" prefix makes a chunk invalid."""
    img = np.random.default_rng(5).integers(0, 256, (6, 9, 3))
    six = png_chunk(b"eXIf", exif_tiff(6))
    for chunks in (png_chunk(b"eXIf", b"Exif\0\0" + exif_tiff(6)) + six,
                   six + png_chunk(b"eXIf", exif_tiff(3)),
                   png_chunk(b"eXIf", exif_tiff(6)[:8] + b"\0\0\0\0") + six):
        data = encode_png(img, 8, 2, chunks=chunks)
        _same(image_io.decode_png_rgb(data), cv2_decode(data))


def test_other_signatures_name_their_path(tmp_path):
    # an AVIF stays refused (BMP, PxM, Sun raster, TIFF, GIF, Radiance
    # HDR, WebP and JPEG 2000 frames read as cv2 reads them:
    # tests/test_torch_formats.py)
    p = tmp_path / "frame.avif"
    ok, avif = cv2.imencode(".avif", np.zeros((64, 64, 3), np.uint8))
    p.write_bytes(avif.tobytes())
    with pytest.raises(FileNotFoundError, match="frame.avif.*AVIF"):
        image_io.imread_rgb(str(p))
    ok, jp2 = cv2.imencode(".jp2", np.zeros((64, 64, 3), np.uint8))
    (tmp_path / "frame.jp2").write_bytes(jp2.tobytes())
    _same(image_io.imread_rgb(str(tmp_path / "frame.jp2")),
          cv2_decode(jp2.tobytes()))
    jpg = pil_jpeg(smooth_image(8, 8, seed=1), 90, 0)
    (tmp_path / "frame.png").write_bytes(jpg)  # a JPEG named .png
    _same(image_io.imread_rgb(str(tmp_path / "frame.png")), cv2_decode(jpg))


# ------------------------------------------------------------- Adam7 PNG
ADAM7_SIZES = [(h, w) for h in range(1, 10) for w in (1, 2, 3, 5, 8, 9)]
ADAM7_SIZES += [(37, 23)]


@pytest.mark.parametrize("ctype_depth", PNG_TYPES)
def test_adam7_pngs_read_as_imageio_and_cv2(ctype_depth):
    """Every colour type and depth at 1-9 px a side (passes left empty)
    and 37 x 23: as imageio reads a mask, as cv2 reads a frame, and the
    same pixels as the file written without interlace."""
    ctype, depth = ctype_depth
    rng = np.random.default_rng(ctype * 31 + depth)
    for h, w in ADAM7_SIZES:
        samples = rng.integers(0, 1 << depth, (h, w, PNG_CHANNELS[ctype]))
        pal = rng.integers(0, 256, (1 << depth, 3)) if ctype == 3 else None
        data = encode_png(samples, depth, ctype, True, pal)
        plain = encode_png(samples, depth, ctype, False, pal)
        want = np.asarray(imageio.imread(io.BytesIO(data)))
        got = image_io.decode_png(data)
        _same(got, want, (h, w))
        _same(got, image_io.decode_png(plain), (h, w))
        _same(image_io.decode_png_rgb(data), cv2_decode(data), (h, w))


def test_adam7_mask_reads_as_the_jax_loader(tmp_path):
    """_load_mask's semantics (!= 0, channel 0) on Adam7 masks, grey and
    palette."""
    disc = _mask_disc(37, 23, 3)
    grey = encode_png((disc * 255)[..., None], 8, 0, True)
    pal = encode_png((disc * 2)[..., None], 2, 3, True,
                     [[0, 0, 0], [0, 90, 0], [180, 0, 0]])
    for name, data in (("grey.png", grey), ("palette.png", pal)):
        p = str(tmp_path / name)
        with open(p, "wb") as f:
            f.write(data)
        m = (np.asarray(imageio.imread(p)) != 0).astype(np.uint8)
        m = m[..., 0] if m.ndim == 3 else m
        _same(image_io.read_mask_png(p), m, name)


# -------------------------------------------------------------- fixtures
def make_fixtures(out=FIXTURES) -> dict:
    """Write the fixtures and digests.json; returns the digests."""
    os.makedirs(out, exist_ok=True)
    small = smooth_image(256, 256, 12, noise=6.0)
    rng = np.random.default_rng(13)
    cmyk = np.concatenate([smooth_image(192, 160, 14, noise=6.0),
                           smooth_image(192, 160, 15)[..., :1]], -1)
    prog = pil_jpeg(small, 90, 2, progressive=True, optimize=True)
    files = {
        "cv2_prog_q95_420.jpg": cv2_progressive(
            smooth_image(1024, 1024, 11), 95, "420"),
        "pil_prog_opt.jpg": prog,
        "pil_prog_cut3.jpg": cut_after_scans(prog, 3),
        "pil_cmyk.jpg": cmyk_jpeg(cmyk, "adobe", 90),
        "pil_ycck.jpg": cmyk_jpeg(cmyk, "ycck", 90),
        "pil_exif6.jpg": with_exif(pil_jpeg(smooth_image(120, 200, 16), 90,
                                            1), 6),
        "rgba16.png": encode_png(rng.integers(0, 65536, (48, 64, 4)), 16, 6),
        "mask_adam7.png": encode_png(
            (_mask_disc(256, 256, 17) * 255)[..., None], 8, 0, True),
    }
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    digests = {}
    for name in sorted(files):
        path = os.path.join(out, name)
        if name.startswith("mask"):
            ref, by = np.asarray(imageio.imread(path)), "imageio.v2.imread"
        else:
            ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
            by = "cv2.imread + cvtColor BGR2RGB"
        digests[name] = {"sha256": sha256(ref), "shape": list(ref.shape),
                         "dtype": str(ref.dtype), "by": by}
    with open(os.path.join(out, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
    return digests


def read_fixture(path: str) -> np.ndarray:
    """What the port's loader reads: masks as _load_mask's imageio, frames
    as _imread_rgb's cv2."""
    if os.path.basename(path).startswith("mask"):
        return image_io.read_png(path)
    return image_io.imread_rgb(path)


def test_committed_digests_are_cv2_and_imageio_decodes():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    assert len(digests) == 8
    total = 0
    for name, d in digests.items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        if name.startswith("mask"):
            ref = np.asarray(imageio.imread(path))
        else:
            ref = cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)
        assert sha256(ref) == d["sha256"], name
        got = read_fixture(path)
        assert got.dtype == ref.dtype and list(got.shape) == d["shape"], name
        assert sha256(got) == d["sha256"], name
    assert total <= 400 * 1024


if __name__ == "__main__":
    print(json.dumps(make_fixtures(), indent=1))
