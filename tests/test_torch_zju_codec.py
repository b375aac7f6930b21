"""The port's image codec (transhuman_tpu_torch/native/imgcodec.cc through
data/image_io.py) against OpenCV and imageio: JPEG decodes bit for bit
against ``cv2.imread`` + ``cvtColor`` BGR -> RGB (libjpeg-turbo's default
decode, what the JAX package's ``_imread_rgb`` returns), each refusal by
name, and PNG masks against ``imageio.v2.imread`` as the JAX package's
``_load_mask`` reads them.

The committed fixtures in tests/fixtures/torch_zju/ are made by
``make_fixtures`` below (``python -m tests.test_torch_zju_codec`` from the
repository root remakes them); ``digests.json`` holds the sha256 of cv2's or
imageio's decode of each, which chip_smoke.py phase e holds the card
machine's decode against.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from transhuman_tpu_torch.data import image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_zju")


def smooth_image(h, w, seed, noise=2.0):
    """A seeded smooth RGB image with a little noise (uint8)."""
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w] / max(h, w)
    ph = r.random(4) * 6
    img = np.stack([np.sin(6 * x + ph[0]) * np.cos(4 * y + ph[3]),
                    np.cos(5 * x * y + ph[1]), np.sin(9 * y + 3 * x + ph[2])],
                   -1)
    img = (img + 1) * 125 + r.normal(0, noise, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _cv2_jpeg(rgb, quality, sampling=None, restart=0) -> bytes:
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(rgb[..., ::-1]),
                           params)
    assert ok
    return buf.tobytes()


def _pil_jpeg(rgb, quality, subsampling, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(rgb).save(b, "JPEG", quality=quality,
                              subsampling=subsampling, **kw)
    return b.getvalue()


def cv2_decode(data: bytes) -> np.ndarray:
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def sha256(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _mask_disc(h, w, seed):
    r = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    cy, cx = r.uniform(0.3, 0.7, 2) * (h, w)
    return ((y - cy) ** 2 / (0.3 * h) ** 2 + (x - cx) ** 2 / (0.2 * w) ** 2
            < 1)


def make_fixtures(out=FIXTURES) -> dict:
    """Write the fixtures and digests.json; returns the digests."""
    os.makedirs(out, exist_ok=True)
    files = {
        "cv2_q95_420.jpg": _cv2_jpeg(smooth_image(1024, 1024, 1), 95,
                                     cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420),
        "pil_q90_444.jpg": _pil_jpeg(smooth_image(1024, 1024, 2), 90, 0),
        "cv2_q90_restart.jpg": _cv2_jpeg(
            smooth_image(1024, 1024, 3), 90,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, restart=7),
    }
    for name, data in files.items():
        with open(os.path.join(out, name), "wb") as f:
            f.write(data)
    disc = _mask_disc(1024, 1024, 4)
    # palette: 0 black, 1 a red-0 green (background to channel 0), 2 red
    idx = np.where(disc, 2, 0).astype(np.uint8)
    idx[:, :300] = np.where(disc[:, :300], 1, 0)
    pal = Image.fromarray(idx, mode="P")
    pal.putpalette([0, 0, 0, 0, 128, 0, 192, 0, 0] + [0] * 759)
    pal.save(os.path.join(out, "mask_palette.png"))
    cv2.imwrite(os.path.join(out, "mask_grey.png"),
                _mask_disc(1024, 1024, 5).astype(np.uint8) * 255)
    digests = {}
    for name in sorted(os.listdir(out)):
        path = os.path.join(out, name)
        if name.endswith(".jpg"):
            ref = cv2_decode(open(path, "rb").read())
        elif name.endswith(".png"):
            ref = np.asarray(imageio.imread(path))
        else:
            continue
        digests[name] = {"sha256": sha256(ref), "shape": list(ref.shape),
                         "dtype": str(ref.dtype), "by": (
                             "cv2.imread + cvtColor BGR2RGB"
                             if name.endswith(".jpg")
                             else "imageio.v2.imread")}
    with open(os.path.join(out, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
    return digests


# ------------------------------------------------------------------ JPEG
def test_committed_digests_are_cv2_and_imageio_decodes():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    assert len(digests) == 5
    total = 0
    for name, d in digests.items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        if name.endswith(".jpg"):
            ref = cv2_decode(open(path, "rb").read())
            got = image_io.imread_rgb(path)
        else:
            ref = np.asarray(imageio.imread(path))
            got = image_io.read_png(path)
        assert sha256(ref) == d["sha256"], name
        # the port's decode is the same bytes
        assert got.dtype == ref.dtype and got.shape == ref.shape, name
        assert sha256(got) == d["sha256"], name
    assert total <= 1024 * 1024


SIZES = [(37, 53), (1, 1), (8, 8), (17, 9), (64, 48), (101, 130)]
SAMPLINGS = {"420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
             "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
             "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
             "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


@pytest.mark.parametrize("sampling", sorted(SAMPLINGS))
@pytest.mark.parametrize("hw", SIZES)
def test_cv2_jpegs_decode_as_cv2(hw, sampling):
    img = smooth_image(*hw, seed=hw[0] * 131 + hw[1], noise=10.0)
    for quality in (40, 95):
        for restart in (0, 3):
            data = _cv2_jpeg(img, quality, SAMPLINGS[sampling], restart)
            got, want = image_io.decode_jpeg(data), cv2_decode(data)
            # bit for bit: the count of differing pixels is 0
            assert int((got != want).any(-1).sum()) == 0, (quality, restart)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("hw", [(37, 53), (64, 64), (99, 17)])
def test_pil_jpegs_decode_as_cv2(hw, subsampling):
    img = smooth_image(*hw, seed=7, noise=10.0)
    for kw in ({}, {"optimize": True}):
        data = _pil_jpeg(img, 90, subsampling, **kw)
        np.testing.assert_array_equal(image_io.decode_jpeg(data),
                                      cv2_decode(data))


@pytest.mark.parametrize("hw", [(37, 53), (16, 16)])
def test_grey_jpegs_decode_to_three_equal_channels(hw):
    g = smooth_image(*hw, seed=3, noise=10.0)[..., 0]
    for data in (cv2.imencode(".jpg", g)[1].tobytes(),
                 _pil_grey(g)):
        got = image_io.decode_jpeg(data)
        np.testing.assert_array_equal(got, cv2_decode(data))
        assert (got[..., 0] == got[..., 2]).all()


def _pil_grey(g) -> bytes:
    b = io.BytesIO()
    Image.fromarray(g, mode="L").save(b, "JPEG", quality=85)
    return b.getvalue()


def _exif_with_orientation(v: int) -> bytes:
    ifd = struct.pack("<HHHIHH", 1, 0x0112, 3, 1, v, 0) + b"\0\0\0\0"
    tiff = b"II*\0" + struct.pack("<I", 8) + ifd
    return b"Exif\0\0" + tiff


def test_refusals_are_named():
    img = smooth_image(24, 24, seed=1)
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", progressive=True)
    with pytest.raises(ValueError, match=r"progressive JPEG \(SOF2"):
        image_io.decode_jpeg(b.getvalue(), "p.jpg")
    b = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(b, "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        image_io.decode_jpeg(b.getvalue())
    data = _pil_jpeg(img, 90, 0)
    for v, ok in ((1, True), (6, False), (3, False)):
        exif = _exif_with_orientation(v)
        seg = b"\xff\xe1" + struct.pack(">H", len(exif) + 2) + exif
        rotated = data[:2] + seg + data[2:]
        if ok:
            np.testing.assert_array_equal(image_io.decode_jpeg(rotated),
                                          cv2_decode(rotated))
        else:
            with pytest.raises(ValueError, match=rf"EXIF orientation {v}"):
                image_io.decode_jpeg(rotated, "r.jpg")
    # 12-bit and arithmetic frames, by their SOF marker
    sof = data.index(b"\xff\xc0")
    twelve = data[:sof + 4] + b"\x0c" + data[sof + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        image_io.decode_jpeg(twelve)
    arith = data[:sof] + b"\xff\xc9" + data[sof + 2:]
    with pytest.raises(ValueError, match=r"arithmetic-coded JPEG \(SOF9"):
        image_io.decode_jpeg(arith)


def test_a_missing_or_unreadable_file_names_its_path(tmp_path):
    with pytest.raises(FileNotFoundError, match="nope.jpg"):
        image_io.imread_rgb(str(tmp_path / "nope.jpg"))
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    with pytest.raises(FileNotFoundError, match="bad.jpg"):
        image_io.imread_rgb(str(bad))


# ------------------------------------------------------------------- PNG
def _png_cases(tmp_path):
    rng = np.random.default_rng(0)
    h, w = 23, 37
    disc = _mask_disc(h, w, 1)
    cases = {}

    def save(name, arr, mode=None, **kw):
        p = str(tmp_path / name)
        Image.fromarray(arr, mode=mode).save(p, **kw) if mode else \
            Image.fromarray(arr).save(p, **kw)
        cases[name] = p

    save("grey8.png", (disc * 255).astype(np.uint8))
    save("grey8_values.png", (rng.random((h, w)) * 3).astype(np.uint8))
    save("grey1.png", disc, mode="1")
    p = str(tmp_path / "grey16.png")
    cv2.imwrite(p, (disc * rng.integers(1, 3, (h, w))).astype(np.uint16))
    cases["grey16.png"] = p
    la = np.stack([(disc * 200).astype(np.uint8),
                   np.full((h, w), 255, np.uint8)], -1)
    save("grey_alpha.png", la, mode="LA")
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[..., 1] = disc * 255  # red 0 everywhere: channel 0 reads 0
    rgb[:5, :5, 0] = 9
    save("rgb.png", rgb)
    rgba = np.concatenate([rgb, np.full((h, w, 1), 128, np.uint8)], -1)
    save("rgba.png", rgba)
    idx = np.where(disc, 2, 0).astype(np.uint8)
    idx[::2] = np.where(disc[::2], 1, 0)
    for name, extra in (("palette.png", {}),
                        ("palette_trns.png", {"transparency": 0})):
        im = Image.fromarray(idx, mode="P")
        im.putpalette([0, 0, 0, 0, 90, 0, 180, 0, 0] + [0] * 759)
        im.save(str(tmp_path / name), **extra)
        cases[name] = str(tmp_path / name)
    im = Image.fromarray(idx, mode="P")
    im.putpalette([0, 0, 0, 0, 90, 0, 180, 0, 0] + [0] * 759)
    im.save(str(tmp_path / "palette_1bit.png"), bits=1)
    cases["palette_1bit.png"] = str(tmp_path / "palette_1bit.png")
    save("filters.png", smooth_image(h, w, 5), optimize=True)
    return cases


def test_png_reader_equals_imageio(tmp_path):
    for name, path in _png_cases(tmp_path).items():
        want = np.asarray(imageio.imread(path))
        got = image_io.read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        # _load_mask's semantics: != 0, then channel 0
        m = (want != 0).astype(np.uint8)
        m = m[..., 0] if m.ndim == 3 else m
        np.testing.assert_array_equal(image_io.read_mask_png(path), m,
                                      err_msg=name)
    pal = image_io.read_mask_png(str(tmp_path / "palette.png"))
    idx = np.asarray(Image.open(str(tmp_path / "palette.png")))
    assert pal[idx == 1].max(initial=0) == 0  # the red-0 entry: background


def test_interlaced_png_is_refused_by_name(tmp_path):
    raw = b"".join(b"\x00" + bytes(8) for _ in range(8))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    png = (image_io.PNG_SIGNATURE
           + chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 0, 0, 0, 1))
           + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))
    p = tmp_path / "adam7.png"
    p.write_bytes(png)
    with pytest.raises(ValueError, match="Adam7"):
        image_io.read_png(str(p))


if __name__ == "__main__":
    print(json.dumps(make_fixtures(), indent=1))
