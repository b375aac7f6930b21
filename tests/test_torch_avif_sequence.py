"""AVIF image sequences (a moov track: the first frame, as libavif reads
tracks) and layered-image properties (a1lx, lsel, a1op) through the port's
reader (data/image_formats.py, native/av1.cc) against ``cv2.imread``
(OpenCV 5, libavif 1.4 with libaom 3.14) bit for bit. Every expected array
is cv2's, never a writer's input; a file cv2 reads as nothing makes the
port raise FileNotFoundError naming the path.

    python -m pytest tests/test_torch_avif_sequence.py -q

Each file is built once per module from cv2's and Pillow's sequence
writers (tests/_torch_avif.py's cv2_sequence and pil_sequence) and from
their boxes edited (Sequence, Track, Heif)."""

import functools
import struct

import numpy as np
import pytest

from tests import _torch_avif as A
from tests.test_torch_avif import _alpha, _grey, _read_both, _same, bgr, deep
from tests.test_torch_avif import _edit as _edit_heif
from transhuman_tpu_torch.data import image_formats, image_io

IMG = bgr(64, 64, 40)
FLIP = np.ascontiguousarray(IMG[::-1])


def _rgb(img):
    return np.ascontiguousarray(img[..., ::-1])


def _rgba(img, seed):
    return np.ascontiguousarray(_alpha(img, seed)[..., [2, 1, 0, 3]])


# the writers' sequences: two frames (a key frame, then an inter frame)
WRITERS = {
    "pil_rgb": lambda: A.pil_sequence([_rgb(IMG), _rgb(FLIP)]),
    "pil_rgba": lambda: A.pil_sequence([_rgba(IMG, 1), _rgba(FLIP, 2)]),
    "cv2_8bit": lambda: A.cv2_sequence([IMG, FLIP]),
    "cv2_10bit": lambda: A.cv2_sequence([deep(IMG, 10), deep(FLIP, 10)],
                                        depth=10),
    "cv2_grey": lambda: A.cv2_sequence([_grey(IMG), _grey(FLIP)]),
}


@functools.lru_cache(maxsize=None)
def writer(name) -> bytes:
    return WRITERS[name]()


@functools.lru_cache(maxsize=None)
def other_still() -> bytes:
    """cv2's still AVIF of another 64x64 image: a meta box whose primary
    item is not the sequence's first frame."""
    return A.cv2_avif(bgr(64, 64, 77))


@functools.lru_cache(maxsize=None)
def three_frames() -> bytes:
    return A.pil_sequence([_rgb(IMG), _rgb(FLIP),
                           _rgb(np.ascontiguousarray(IMG[:, ::-1]))])


def _edit(data, fn):
    s = A.Sequence(data)
    fn(s)
    return bytes(s)


def _track(fn, base="cv2_8bit"):
    return lambda: _edit(writer(base), lambda s: fn(s.tracks[0]))


def _alpha_track(fn):
    return lambda: _edit(writer("pil_rgba"), lambda s: fn(s.tracks[1]))


def _brand(major, compat=None, meta="still"):
    """cv2's 8-bit sequence under another major brand (and compatible
    brands), its meta box the other still's (``meta`` "still"), its own
    (whose primary item is sample 0's data) or none."""
    def edit(s):
        if meta == "still":
            s.heif = A.Heif(other_still())
        elif meta is None:
            s.heif = None
        s.major = major
        if compat is not None:
            s.ftyp = s.ftyp[:8] + b"".join(compat)
    return lambda: _edit(writer("cv2_8bit"), edit)


def _item_is_sample(n, major):
    """cv2's 8-bit sequence whose primary item's data is sample n's."""
    def edit(s):
        s.heif.items[s.heif.primary][1] = s.tracks[0].samples[n]
        s.major = major
    return lambda: _edit(writer("cv2_8bit"), edit)


def _samples(fn):
    return lambda: _edit(three_frames(), lambda s: fn(s.tracks[0]))


def _set(obj, **kw):
    for k, v in kw.items():
        setattr(obj, k, v)


def _drop(t, kind):
    t.entry = [(k, b) for k, b in t.entry if k != kind]


def _exif_tiff(orientation):
    return (b"MM\0*" + struct.pack(">IH", 8, 1)
            + struct.pack(">HHII", 0x0112, 3, 1, orientation << 16)
            + b"\0" * 4)


def _track_meta(t, orientation=6):
    """A meta box in the track holding an Exif item (in idat)."""
    exif = struct.pack(">I", 0) + _exif_tiff(orientation)
    hdlr = A.full_box(b"hdlr", 0, 0, b"\0" * 4 + b"pict" + b"\0" * 13)
    iinf = A.full_box(b"iinf", 0, 0, struct.pack(">H", 1) + A.full_box(
        b"infe", 2, 0, struct.pack(">HH4s", 1, 0, b"Exif") + b"\0"))
    iloc = A.full_box(b"iloc", 1, 0, bytes([0x44, 0]) + struct.pack(
        ">HHHHHII", 1, 1, 1, 0, 1, 0, len(exif)))
    t.others.append((b"meta", b"\0" * 4 + hdlr + iinf + iloc
                     + A.box(b"idat", exif)))


def _top_exif(major):
    """cv2's 8-bit sequence with an Exif item of orientation 6 describing
    the meta box's primary item, under major brand ``major``."""
    def edit(s):
        s.heif = A.Heif(A.with_exif(bytes(s.heif), 6))
        s.major = major
    return lambda: _edit(writer("cv2_8bit"), edit)


def _patch(kind, at, value, base="cv2_8bit"):
    """A writer's file with a 32-bit field of its first ``kind`` box (at
    ``at`` bytes into its body) set to value."""
    def make():
        d = bytearray(writer(base))
        struct.pack_into(">I", d, d.find(kind) + 4 + at, value)
        return bytes(d)
    return make


def _lean(nclx, free):
    """cv2's 8-bit sequence cut to its brand avis, a moov box within 500
    bytes (no mvhd, edts, vmhd, dinf, ccst or stss; nclx in its sample
    entry or not), then a free box of ``free`` bytes before mdat, which
    pushes the first sample past byte 500 from 22 bytes on."""
    def make():
        s = A.Sequence(writer("cv2_8bit"))
        s.heif, s.ftyp, s.mvhd = None, b"avis\0\0\0\0avis", b""
        t = s.tracks[0]
        t.others, t.minf, t.stss = [], [], None
        t.entry = [(k, b) for k, b in t.entry
                   if k == b"av1C" or (nclx and k == b"colr")]
        ftyp, pad = A.box(b"ftyp", s.ftyp), A.box(b"free", bytes(free))
        moov, samples = s.moov(len(ftyp) + len(s.moov(0)[0]) + len(pad) + 8)
        return ftyp + moov + pad + A.box(b"mdat", samples)
    return make


def _mdat_first(pad):
    """cv2's 8-bit sequence laid out ftyp, meta, mdat (``pad`` bytes
    after the samples), moov: the moov box past byte 500 from a pad of
    about 20 bytes on."""
    def make():
        s = A.Sequence(writer("cv2_8bit"))
        s.heif.ftyp = s.ftyp
        head = s.heif.layout()
        at = head.rfind(b"mdat") - 4
        items = head[at + 8:]
        moov, samples = s.moov(at + 8 + len(items))
        return head[:at] + A.box(b"mdat", items + samples + bytes(pad)) + \
            moov
    return make


# a colr nclx box of BT.709 primaries and matrix, full range
_BT709 = b"nclx" + struct.pack(">HHHB", 1, 13, 1, 0x80)


def _cv2():
    return writer("cv2_8bit")


def _rgba_file():
    return writer("pil_rgba")


# name -> (file, what cv2 reads: "reads" an image, the image it reads of
# the file a function returns (the file edited, or the other still),
# "turned" cv2's 8-bit sequence's first frame turned by orientation 6,
# "other" an image other than that frame (a scaled one, another track's),
# None nothing, or "refused: " and what the port's refusal names where it
# does not read what cv2 reads)
SEQUENCES = {
    **{f"writer_{k}": (functools.partial(writer, k), "reads")
       for k in WRITERS},
    # which source libavif reads: the major brand avis the track, avif the
    # item, another the track where its brands need the moov box (where
    # they need only meta, libavif stops before the moov box)
    "brand_avis": (_brand(b"avis"), _cv2),
    "brand_avif": (_brand(b"avif"), other_still),
    "brand_mif1": (_brand(b"mif1"), _cv2),
    "brand_mif1_avif_only": (_brand(b"mif1", [b"avif", b"mif1", b"miaf"]),
                             other_still),
    "brand_mif1_avis_only": (_brand(b"mif1", [b"avis", b"msf1"]), _cv2),
    "brand_avis_no_meta": (_brand(b"avis", [b"avis", b"msf1"], None),
                           _cv2),
    "brand_avis_avif_no_meta": (_brand(b"avis", meta=None), None),
    "brand_avif_no_moov": (lambda: bytes(A.Heif(other_still())), other_still),
    "brand_avis_no_moov": (lambda: b"avis".join(
        bytes(A.Heif(other_still())).split(b"avif", 1)), None),
    "item_is_sample_1_avis": (_item_is_sample(1, b"avis"), _cv2),
    "item_is_sample_1_avif": (_item_is_sample(1, b"avif"), None),
    # the sample table as libavif reads it
    "co64": (_samples(lambda t: _set(t, co64=True)), three_frames),
    "chunks_1_1_1": (_samples(lambda t: _set(t, chunks=[1, 1, 1])),
                     three_frames),
    "chunks_1_2": (_samples(lambda t: _set(t, chunks=[1, 2])), three_frames),
    "chunks_2_1": (_samples(lambda t: _set(t, chunks=[2, 1])), three_frames),
    "constant_size": (_samples(lambda t: _set(
        t, samples=[t.samples[0]] * 3, constant_size=True)), three_frames),
    "constant_size_of_sample_0": (_samples(lambda t: _set(
        t, constant_size=True)), three_frames),
    "no_stss": (_samples(lambda t: _set(t, stss=None)), three_frames),
    "stss_of_sample_2": (_samples(lambda t: _set(t, stss=[2])), three_frames),
    "no_edts": (_samples(lambda t: _set(t, others=[])), three_frames),
    "stsd_version_1": (_patch(b"stsd", 0, 1 << 24), _cv2),
    "stsc_fewer_samples": (_patch(b"stsc", 12, 1), _cv2),
    "sample_0_an_inter_frame": (_samples(lambda t: t.samples.reverse()),
                                None),
    "stsz_too_few_sizes": (_patch(b"stsz", 8, 1), None),
    "stsc_past_the_sizes": (_patch(b"stsc", 12, 3), None),
    "stsc_first_chunk_2": (_patch(b"stsc", 8, 2), None),
    "stsc_chunk_of_no_samples": (_patch(b"stsc", 12, 0), None),
    "stco_version_1": (_patch(b"stco", 0, 1 << 24), None),
    "stsd_version_2": (_patch(b"stsd", 0, 2 << 24), None),
    "stts_version_1": (_patch(b"stts", 0, 1 << 24), None),
    "sample_past_the_end": (_patch(b"stco", 8, 2000), None),
    "last_sample_past_the_end": (lambda: writer("cv2_8bit")[:-5], None),
    "cut_moov": (lambda: writer("cv2_8bit")[:600], None),
    "elst_of_two_entries": (_patch(b"elst", 4, 2), None),
    "elst_segment_duration_0": (_patch(b"elst", 12, 0), None),
    "tkhd_version_2": (_patch(b"tkhd", 0, 2 << 24), None),
    "no_av1C": (_track(lambda t: _drop(t, b"av1C")), None),
    "entry_cut_short": (_track(lambda t: _set(t, visual=t.visual[:70],
                                              entry=[])), None),
    "entry_of_another_format": (_track(lambda t: _set(t, format=b"av02")),
                                None),
    "track_id_0": (_track(lambda t: _set(t, id=0)), None),
    "two_nclx": (_track(lambda t: t.entry.append((b"colr", _BT709))), None),
    "a1op_past_31_in_entry": (_track(lambda t: t.entry.append(
        (b"a1op", b"\x20"))), None),
    # the colour and alpha tracks
    "second_track_first": (lambda: _edit(writer("cv2_8bit"), lambda s: (
        s.tracks.insert(0, A.Sequence(A.pil_sequence([_rgb(bgr(
            64, 64, 78))] * 2)).tracks[0]), _set(s.tracks[1], id=2))),
        "other"),
    "handler_vide": (_track(lambda t: _set(t, handler=b"vide")), _cv2),
    "alpha_cut": (_alpha_track(lambda t: t.samples.__setitem__(
        0, t.samples[0][:len(t.samples[0]) // 2])), None),
    "alpha_not_av1": (_alpha_track(lambda t: t.samples.__setitem__(
        0, b"\x12\x00" + bytes(40))), None),
    "alpha_second_sample_broken": (_alpha_track(
        lambda t: t.samples.__setitem__(1, b"\x12\x00" + bytes(40))),
        _rgba_file),
    "alpha_of_another_size": (_alpha_track(lambda t: _set(t, size=(32, 32))),
                              None),
    "alpha_of_another_depth": (_alpha_track(lambda t: _set(
        t, samples=A.Sequence(writer("cv2_10bit")).tracks[0].samples,
        entry=[(b"av1C", A.Sequence(writer("cv2_10bit")).tracks[0]
                .entry_box(b"av1C"))])), None),
    "alpha_not_auxiliary_to_the_colour": (_alpha_track(lambda t: _set(
        t, refs=[(b"auxl", [5])], samples=[b"\x12\x00" + bytes(40)] * 2)),
        _rgba_file),
    "premultiplied_alpha": (lambda: _edit(writer("pil_rgba"), lambda s: (
        s.tracks[0].refs.append((b"prem", [2])))),
        "refused: premultiplied alpha"),
    # sizes and transforms: libavif scales the frame to its tkhd size;
    # irot, imir and clap are not applied; the file's meta box's Exif item
    # is not read in a track, the track's own meta box's is
    "tkhd_32x32": (_track(lambda t: _set(t, size=(32, 32))), "other"),
    "tkhd_80x60": (_track(lambda t: _set(t, size=(80, 60))), "other"),
    "tkhd_0x64": (_track(lambda t: _set(t, size=(0, 64))), None),
    "tkhd_40000x64": (_track(lambda t: _set(t, size=(40000, 64))), None),
    "entry_irot_imir_clap": (_track(lambda t: t.entry.extend([
        (b"irot", b"\x01"), (b"imir", b"\x01"),
        (b"clap", bytes(range(32)))])), _cv2),
    "entry_lsel_a1lx_a1op": (_track(lambda t: t.entry.extend([
        (b"lsel", b"\0\1"), (b"a1lx", bytes(7)), (b"a1op", b"\x05")])),
        _cv2),
    "meta_exif_avis": (_top_exif(b"avis"), _cv2),
    "meta_exif_avif": (_top_exif(b"avif"), "turned"),
    "track_meta_exif": (_track(_track_meta), "turned"),
    "no_nclx": (_track(lambda t: _drop(t, b"colr")), _cv2),
    "nclx_bt709": (_track(lambda t: t.entry.__setitem__(
        1, (b"colr", _BT709))), "other"),
    # cv2's signature check: libavif's parse of the first 500 bytes
    **{f"lean_{'nclx' if nclx else 'no_nclx'}_{free}": (
        _lean(nclx, free), _cv2 if nclx or free < 22 else None)
       for nclx in (True, False) for free in (20, 22)},
    "mdat_before_moov_within_500": (_mdat_first(0), _cv2),
    "mdat_before_moov_past_500": (_mdat_first(200), None),
}


@functools.lru_cache(maxsize=None)
def _file(name) -> bytes:
    return SEQUENCES[name][0]()


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_sequences_read_as_cv2_imread(name, tmp_path):
    """Each sequence reads as cv2 reads it: the colour track's first
    frame, or the primary item where the brands say so; what cv2 reads as
    nothing raises FileNotFoundError naming the path."""
    _, expect = SEQUENCES[name]
    want, p = _read_both(tmp_path, name, _file(name))
    if expect is None or str(expect).startswith("refused: "):
        assert (want is None) == (expect is None), name
        match = f"{name}.avif" + ("" if expect is None else f".*{expect[9:]}")
        with pytest.raises(FileNotFoundError, match=match):
            image_io.imread_rgb(str(p))
        return
    assert want is not None, name
    _same(image_io.imread_rgb(str(p)), want, name)
    if expect == "reads":
        return
    ref, _ = _read_both(tmp_path, "ref", (
        _cv2 if expect in ("turned", "other") else expect)())
    if expect == "turned":
        ref = np.rot90(ref, -1)
    if expect == "other":
        assert ref.shape != want.shape or (ref != want).any(), name
    else:
        _same(want, ref, name)


@pytest.mark.parametrize("name", sorted(WRITERS))
def test_first_sample_decodes_to_libaom_planes(name):
    """The colour track's first sample through native/av1.cc gives
    libaom's planes (the oracle before the colour conversion)."""
    heif = image_formats._Heif(writer(name))
    assert heif.from_tracks, name
    start, n = heif.tracks[0].samples(len(heif.data))[0]
    obus = heif.data[start:start + n]
    got, _ = image_formats._av1_planes(obus)
    want = A.libaom_planes(obus)
    assert len(got) == len(want), name
    for g, w in zip(got, want):
        assert (g == w).all(), name


# ------------------------------------------------- layered properties
@functools.lru_cache(maxsize=None)
def _still() -> bytes:
    return A.cv2_avif(bgr(64, 64, 41))


@functools.lru_cache(maxsize=None)
def _still_alpha() -> bytes:
    return A.cv2_avif(_alpha(bgr(64, 64, 42), 42))


def _a1lx(*sizes, large=False):
    return bytes([int(large)]) + struct.pack(">III" if large else ">HHH",
                                             *sizes)


def _lsel(layer):
    return struct.pack(">H", layer)


# name -> ([(property, body, essential)], what cv2 reads: True the file
# without them, False nothing); ``n`` below stands for the item's size
LAYERED = {
    "lsel_0": ([(b"lsel", _lsel(0), 1)], True),
    "lsel_every_layer": ([(b"lsel", _lsel(0xFFFF), 1)], True),
    "lsel_0_not_essential": ([(b"lsel", _lsel(0), 0)], False),
    "lsel_1_one_layer": ([(b"lsel", _lsel(1), 1)], False),
    "lsel_3_one_layer": ([(b"lsel", _lsel(3), 1)], False),
    "lsel_4": ([(b"lsel", _lsel(4), 1)], False),
    "a1op_1": ([(b"a1op", b"\x01", 1)], True),
    "a1op_5": ([(b"a1op", b"\x05", 1)], True),
    "a1op_31": ([(b"a1op", b"\x1f", 1)], True),
    "a1op_32": ([(b"a1op", b"\x20", 1)], False),
    "a1lx_10_0_0": ([(b"a1lx", _a1lx(10, 0, 0), 0)], True),
    "a1lx_large_size": ([(b"a1lx", _a1lx(10, 0, 0, large=True), 0)], True),
    "a1lx_0_0_0": ([(b"a1lx", _a1lx(0, 0, 0), 0)], True),
    "a1lx_1_1_1": ([(b"a1lx", _a1lx(1, 1, 1), 0)], True),
    "a1lx_n_less_1": ([(b"a1lx", "n-1", 0)], True),
    "a1lx_n": ([(b"a1lx", "n", 0)], False),
    "a1lx_1_1_n_less_2": ([(b"a1lx", "1,1,n-2", 0)], False),
    "a1lx_essential": ([(b"a1lx", _a1lx(0, 0, 0), 1)], False),
    "a1lx_reserved_bits": ([(b"a1lx", b"\x02" + bytes(6), 0)], False),
    "a1lx_cut_short": ([(b"a1lx", b"\0\0", 0)], False),
    "a1lx_10_lsel_0": ([(b"a1lx", _a1lx(10, 0, 0), 0),
                        (b"lsel", _lsel(0), 1)], False),
    "a1lx_0_0_0_lsel_0": ([(b"a1lx", _a1lx(0, 0, 0), 0),
                           (b"lsel", _lsel(0), 1)], True),
    "a1lx_10_lsel_1": ([(b"a1lx", _a1lx(10, 0, 0), 0),
                        (b"lsel", _lsel(1), 1)], False),
    "a1lx_10_lsel_2": ([(b"a1lx", _a1lx(10, 0, 0), 0),
                        (b"lsel", _lsel(2), 1)], False),
    "a1lx_lsel_every_layer_a1op": ([(b"a1lx", _a1lx(10, 0, 0), 0),
                                    (b"lsel", _lsel(0xFFFF), 1),
                                    (b"a1op", b"\x03", 1)], True),
}


def _body(body, n):
    if body == "n":
        return _a1lx(n, 0, 0)
    if body == "n-1":
        return _a1lx(n - 1, 0, 0)
    if body == "1,1,n-2":
        return _a1lx(1, 1, n - 2)
    return body


def _layered(where, props):
    """``where``: "still" (the primary item), "alpha" (the alpha item),
    "tile" (a grid's second tile), "grid" (the grid item), "unused" (an
    association of an item the file lacks: libavif's ipma parse checks it
    all the same)."""
    base = {"still": _still, "alpha": _still_alpha, "unused": _still,
            "tile": lambda: A.as_grid(_still(), 1, 2),
            "grid": lambda: A.as_grid(_still(), 1, 2)}[where]()
    h = A.Heif(base)
    iid = {"still": h.primary, "unused": 99, "tile": 3, "grid": 1,
           "alpha": next((s for r, s, d in h.refs if r == b"auxl"), None)
           }[where]
    n = len(h.items[iid if iid in h.items else h.primary][1])
    for kind, body, essential in props:
        h.add_prop(iid, kind, _body(body, n), essential)
    return base, bytes(h)


LAYERED_CASES = [(w, k) for w in ("still", "tile") for k in sorted(LAYERED)]
LAYERED_CASES += [("alpha", k) for k in (
    "a1lx_10_0_0", "a1lx_n", "lsel_0", "lsel_1_one_layer",
    "lsel_0_not_essential", "a1lx_10_lsel_0", "a1op_5")]
LAYERED_CASES += [("grid", k) for k in (
    "a1lx_10_0_0", "lsel_1_one_layer", "a1op_5", "lsel_0_not_essential",
    "a1lx_essential")]
LAYERED_CASES += [("unused", k) for k in ("a1lx_essential", "a1op_32",
                                           "lsel_4", "lsel_0_not_essential")]
# a grid item's own a1lx and lsel are not read (its tiles' are)
GRID_ITEM_READS = {"a1lx_10_0_0", "lsel_1_one_layer", "a1op_5"}


@pytest.mark.parametrize("where,name", LAYERED_CASES)
def test_layered_properties_read_as_cv2_imread(where, name, tmp_path):
    """A still item, an alpha item, a grid's tile or the grid item with
    a1lx, lsel and a1op: read as the file without them where cv2 reads it
    so, nothing where cv2 reads nothing."""
    props, reads = LAYERED[name]
    if where == "grid":
        reads = name in GRID_ITEM_READS
    elif where == "unused":
        reads = False
    base, data = _layered(where, props)
    label = f"{where}_{name}"
    want, p = _read_both(tmp_path, label, data)
    if not reads:
        assert want is None, label
        with pytest.raises(FileNotFoundError, match=f"{label}.avif"):
            image_io.imread_rgb(str(p))
        return
    plain, _ = _read_both(tmp_path, "plain", base)
    assert want is not None and (want == plain).all(), label
    _same(image_io.imread_rgb(str(p)), want, label)


def test_an_alpha_item_of_another_depth_reads_as_nothing(tmp_path):
    """libavif fails a colour and alpha of other sizes or bit depths: an
    8-bit image's alpha item swapped for a 10-bit one of its size."""
    h = A.Heif(_still_alpha())
    deep_grey = A.Heif(A.cv2_avif(deep(_grey(bgr(64, 64, 42)), 10), depth=10))
    aid = next(s for r, s, d in h.refs if r == b"auxl")
    h.items[aid][1] = deep_grey.items[deep_grey.primary][1]
    h.drop_prop(aid, b"av1C")
    h.add_prop(aid, b"av1C", deep_grey.prop(deep_grey.primary, b"av1C"))
    want, p = _read_both(tmp_path, "alpha_depth", bytes(h))
    assert want is None
    with pytest.raises(FileNotFoundError, match="alpha_depth.avif"):
        image_io.imread_rgb(str(p))


def test_every_layered_property_together_in_a_grid(tmp_path):
    """A 2x1 grid whose tiles carry a1lx, lsel 0 (without a1lx sizes) and
    a1op, one each, reads as the grid without them."""
    base = A.as_grid(_still(), 2, 1)
    h = A.Heif(base)
    h.add_prop(2, b"a1lx", _a1lx(20, 0, 0), 0)
    h.add_prop(2, b"a1op", b"\x02", 1)
    h.add_prop(3, b"lsel", _lsel(0), 1)
    want, p = _read_both(tmp_path, "grid_layers", bytes(h))
    plain, _ = _read_both(tmp_path, "plain", base)
    assert want is not None and (want == plain).all()
    _same(image_io.imread_rgb(str(p)), want)


# a Pillow sequence, and a1lx, lsel and a1op added to cv2's still file
# and to a grid's tile: single-layer files that cv2 reads
def _plain_layered():
    img = bgr(64, 64, 40)

    def still(kind, body, essential):
        return lambda: _edit_heif(A.cv2_avif(img), lambda h: h.add_prop(
            h.primary, kind, body, essential))
    return {
        "grid_of_layered_tiles": lambda: _edit_heif(A.as_grid(
            A.cv2_avif(img)), lambda h: h.add_prop(3, b"a1lx", bytes(7))),
        "image_sequence": lambda: A.pil_sequence([_rgb(img),
                                                  _rgb(img[::-1])]),
        "layered_a1lx": still(b"a1lx", bytes(7), 0),
        "layered_lsel": still(b"lsel", bytes(2), 1),
        "layered_a1op": still(b"a1op", b"\0", 1),
    }


PLAIN_LAYERED = _plain_layered()


@pytest.mark.parametrize("name", sorted(PLAIN_LAYERED))
def test_sequence_and_single_layer_files_read_as_cv2_imread(name, tmp_path):
    want, p = _read_both(tmp_path, name, PLAIN_LAYERED[name]())
    assert want is not None, name
    _same(image_io.imread_rgb(str(p)), want, name)
