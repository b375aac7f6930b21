"""AVIF frames coded with AV1's screen-content tools (palettes and intra
block copy) through the port's reader against ``cv2.imread`` (OpenCV 5,
libavif 1.4 with libaom 3.14) and, before the colour conversion, the
decoded planes against libaom's; each file holds the tool it is there for
by the decoder's meta (allow_screen_content_tools, allow_intrabc, and the
counts of Y palette, UV palette and IntraBC blocks). Every expected array
is cv2's or libaom's reading of the file."""

import os

import numpy as np
import pytest

from tests import _torch_avif as A
from tests.test_torch_avif import _pil, _same, bgr, cv2_imread
from transhuman_tpu_torch.data import image_formats, image_io

SCREEN = {"tune-content": "screen"}
_IMAGES = {}


def screen(h, w, seed=1):
    if (h, w, seed) not in _IMAGES:
        _IMAGES[h, w, seed] = A.screen_rgb(h, w, seed)
    return _IMAGES[h, w, seed]


def _crop(img, y, x, h, w):
    return np.ascontiguousarray(img[y:y + h, x:x + w])


# name -> (file, (IntraBC blocks, Y palette blocks, UV palette blocks)):
# True where the file holds some, False where none, None either way
CASES = {}
for _sub in ("4:4:4", "4:2:2", "4:2:0"):
    _s = _sub.replace(":", "")
    # libaom copies blocks at speeds 4 and 6; at 0 and 8 it codes
    # palettes only
    for _speed in (4, 6):
        CASES[f"text_s{_speed}_{_s}"] = (
            lambda sp=_speed, sub=_sub: _pil(screen(192, 192), quality=60,
                                             speed=sp, subsampling=sub,
                                             advanced=SCREEN),
            (True, True, True))
    CASES[f"text_s0_{_s}"] = (
        lambda sub=_sub: _pil(screen(64, 64), quality=60, speed=0,
                              subsampling=sub, advanced=SCREEN),
        (False, True, True))
    CASES[f"text_s8_{_s}"] = (
        lambda sub=_sub: _pil(screen(192, 192), quality=60, speed=8,
                              subsampling=sub, advanced=SCREEN),
        (False, True, True))
CASES.update({
    # the screen tune on a photograph: the tools allowed, seldom taken
    **{f"photo_q{q}": (lambda q=q: _pil(bgr(64, 64, 40), quality=q, speed=4,
                                        advanced=SCREEN), (None, None, None))
       for q in (40, 60, 90)},
    # libaom picks screen content by itself, under film grain
    "photo_grain": (lambda: _pil(bgr(61, 63, 72), quality=60, speed=6,
                                 advanced={"film-grain-test": "12"}),
                    (False, None, None)),
    # blocks copied across two tile columns; palettes in 2x2 tiles
    "text_tile_cols": (lambda: _pil(screen(256, 256), quality=60, speed=6,
                                    tile_cols=1, advanced=SCREEN),
                       (True, True, True)),
    "text_tiles_2x2": (lambda: _pil(screen(256, 256), quality=60, speed=6,
                                    tile_rows=1, tile_cols=1,
                                    advanced=SCREEN), (False, True, True)),
    # neither side a multiple of 8: the index maps' on-screen part, the
    # copies at the frame's edge
    "text_odd_size": (lambda: _pil(_crop(screen(256, 256), 3, 5, 187, 201),
                                   quality=60, speed=6, advanced=SCREEN),
                      (True, True, True)),
    "text_sb128": (lambda: _pil(screen(256, 256), quality=60, speed=6,
                                advanced={**SCREEN, "sb-size": "128"}),
                   (True, True, True)),
})


def seeded_file(seed: int) -> bytes:
    """A screen-tuned Pillow file of a seeded crop of a 384x384 screen
    capture, at a seeded size, speed (4-8), quality (30-90) and
    subsampling."""
    rng = np.random.default_rng(3000 + seed)
    h, w = (int(v) for v in rng.integers(80, 209, 2))
    y, x = int(rng.integers(0, 384 - h)), int(rng.integers(0, 384 - w))
    speed, q = int(rng.integers(4, 9)), int(rng.integers(30, 91))
    sub = ("4:2:0", "4:2:2", "4:4:4")[int(rng.integers(3))]
    return _pil(_crop(screen(384, 384, 7), y, x, h, w), quality=q,
                speed=speed, subsampling=sub, advanced=SCREEN)


SEEDS = 24
CASES.update({f"seed_{s:02d}": (lambda s=s: seeded_file(s), (None, None, None))
              for s in range(SEEDS)})
_FILES = {}


def screen_file(name) -> bytes:
    if name not in _FILES:
        _FILES[name] = CASES[name][0]()
    return _FILES[name]


def tools(obus):
    """(allow_screen_content_tools, allow_intrabc, Y palette blocks, UV
    palette blocks, IntraBC blocks, film grain) by the decoder's meta."""
    _, meta = image_formats._av1_planes(obus)
    return tuple(int(v) for v in meta[20:25]) + (int(meta[19]),)


@pytest.mark.parametrize("name", sorted(CASES))
def test_screen_files_read_as_cv2_imread(name, tmp_path):
    p = tmp_path / f"{name}.avif"
    p.write_bytes(screen_file(name))
    want = cv2_imread(p)
    assert want is not None, name
    _same(image_io.imread_rgb(str(p)), want, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_screen_files_decode_as_libaom_and_carry_their_tools(name):
    obus = A.primary_obus(screen_file(name))
    got, _ = image_formats._av1_planes(obus)
    want = A.libaom_planes(obus)
    assert len(got) == len(want), name
    for p, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and (g == w).all(), (
            name, p, int((g != w).sum()))
    sct, intrabc, pal_y, pal_uv, copies, grain = tools(obus)
    assert sct == 1, name
    assert intrabc or not copies, name
    for count, want in zip((copies, pal_y, pal_uv), CASES[name][1]):
        if want is not None:
            assert (count > 0) == want, (name, copies, pal_y, pal_uv)
    assert grain == name.endswith("grain"), name


def test_a_quarter_of_the_seeded_files_copy_blocks():
    copies = [tools(A.primary_obus(screen_file(f"seed_{s:02d}")))[4]
              for s in range(SEEDS)]
    assert sum(c > 0 for c in copies) * 4 >= SEEDS, copies


# the committed screen-content fixtures of tests/fixtures/torch_zju_formats
# (tests/test_torch_formats.py makes them): (Y palette blocks, UV palette
# blocks, IntraBC blocks)
FORMAT_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "fixtures", "torch_zju_formats")
COMMITTED = {"avif_pil_palette.avif": (125, 8, 0),
             "avif_pil_intrabc.avif": (200, 34, 12),
             "pil_screen_1024.avif": (2438, 48, 6163)}


@pytest.mark.parametrize("name", sorted(COMMITTED))
def test_committed_screen_fixtures_carry_their_tools(name):
    path = os.path.join(FORMAT_FIXTURES, name)
    with open(path, "rb") as f:
        obus = A.primary_obus(f.read())
    sct, intrabc, *counts, grain = tools(obus)
    assert (sct, intrabc, tuple(counts), grain) == (
        1, int(COMMITTED[name][2] > 0), COMMITTED[name], 0), (sct, counts)
    for p, (g, w) in enumerate(zip(image_formats._av1_planes(obus)[0],
                                   A.libaom_planes(obus))):
        assert g.shape == w.shape and (g == w).all(), (name, p)
    _same(image_io.imread_rgb(path), cv2_imread(path), name)
