"""The port's host C++ libraries and its video path against the JAX
package's on the CPU: the native marching tetrahedra against JAX's native
and the port's numpy route; the native CRC32C against the Python table and
JAX's; the native rasterizer against JAX's bit for bit and against the
port's numpy route; the JPEG encoder against OpenCV's quality-95 stream;
the MJPG/AVI container against JAX's ``MJPGWriter``; ``frames_to_video``'s
order; a failing compiler.  The visualize entry point's AVI is checked in
tests/test_torch_eval.py, the mesh video of a reconstructed PLY in
tests/test_torch_mesh.py."""

import os

import cv2
import numpy as np
import pytest

from tests.test_avi_writer import parse_avi
from tests.test_mesh_ops import sphere_field
from transhuman_tpu.mesh_ops import marching as jmarching
from transhuman_tpu.utils import tb_writer as jtb
from transhuman_tpu.viz import avi as javi
from transhuman_tpu.viz import mesh_render as jrender
from transhuman_tpu_torch.data.image_io import decode_jpeg
from transhuman_tpu_torch.mesh_ops import marching
from transhuman_tpu_torch.native import build
from transhuman_tpu_torch.utils import png, tb_writer
from transhuman_tpu_torch.viz import avi, mesh_render, video

# grid units: the interpolated vertices of the two C++ builds (the port's
# without -march, the JAX package's with -march=native) may differ in the
# last bits where a compiler contracts a multiply-add
MARCH_ATOL = 1e-6
# dB: the port's quality-95 JPEG against OpenCV's, each decoded and held
# against its source frame
PSNR_ATOL = 0.1


def _fields():
    rng = np.random.default_rng(3)
    return {
        "sphere": (sphere_field(20, 6.0), 0.0),
        "random": (rng.normal(0, 1, (9, 11, 7)).astype(np.float32), 0.3),
        "empty": (np.zeros((4, 4, 4), np.float32), 1.0),
    }


def _sorted_rows(v):
    return v[np.lexsort(v.T[::-1])]


@pytest.mark.parametrize("name", sorted(_fields()))
def test_native_marching_equals_jax_native_and_the_numpy_route(name):
    field, th = _fields()[name]
    got_v, got_t = marching.marching_tetrahedra(field, th)
    jax_v, jax_t = jmarching._march_native(jmarching._load_native(), field,
                                           th)
    np_v, np_t = marching.marching_tetrahedra(field, th, use_native=False)
    assert got_v.dtype == np.float32 and got_t.dtype == np.int64
    # the same walk: the same vertex order and triangles as JAX's C++ route
    np.testing.assert_array_equal(got_t, jax_t)
    np.testing.assert_allclose(got_v, jax_v, rtol=0, atol=MARCH_ATOL)
    print(f"{name}: port native bit-equal to JAX native: "
          f"{np.array_equal(got_v, jax_v)}")
    # the numpy route's surface: the same vertex set, triangle count and
    # triangles once its vertices are renumbered
    assert len(got_v) == len(np_v) and len(got_t) == len(np_t)
    np.testing.assert_allclose(_sorted_rows(got_v), _sorted_rows(np_v),
                               rtol=0, atol=MARCH_ATOL)
    if name == "empty":
        assert got_v.shape == (0, 3) and got_t.shape == (0, 3)
    else:
        assert len(got_t) > 20
        tri = lambda v, t: np.sort(_sorted_rows(  # noqa: E731
            np.sort(v[t].reshape(-1, 9).round(5), axis=1)), axis=0)
        np.testing.assert_allclose(tri(got_v, got_t), tri(np_v, np_t),
                                   atol=1e-4)


def test_a_failing_compiler_raises_and_numpy_stays_reachable(tmp_path,
                                                             monkeypatch):
    """A build the compiler refuses raises with its output (no fallback);
    use_native=False reaches the numpy route without the library."""
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "CXX", "false")
    with pytest.raises(RuntimeError, match="building libmarching.so failed"):
        marching.marching_tetrahedra(sphere_field(8, 3.0), 0.0)
    monkeypatch.setattr(build, "CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="building libcrc32c.so failed"):
        tb_writer.crc32c(b"abc")
    v, t = marching.marching_tetrahedra(sphere_field(8, 3.0), 0.0,
                                        use_native=False)
    assert len(t) > 0 and build._libs == {}
    assert not os.path.exists(build.lib_path("marching"))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 1000, 65537, 1 << 20])
def test_crc32c_equals_the_table_and_the_jax_package(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    got = tb_writer.crc32c(data)
    assert got == jtb.crc32c(data)
    if n <= 65537:  # the Python table takes ~0.1 s a MB
        assert got == tb_writer.crc32c_table(data)
    assert tb_writer.masked_crc32c(data) == jtb.masked_crc32c(data)
    # known answers (RFC 3720 B.4 and the CRC catalogue's check value)
    assert tb_writer.crc32c(b"123456789") == 0xE3069283
    assert tb_writer.crc32c(bytes(32)) == 0x8A9136AA
    assert tb_writer.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert tb_writer.crc32c(bytes(range(32))) == 0x46DD794E


def sphere_mesh():
    v, t = jmarching._marching_tetrahedra_np(sphere_field(20, 6.0), 0.0)
    return ((v - 9.5) / 6.0).astype(np.float32), t


def cameras(n=3, seed=1):
    """The JAX test's camera, then n seeded rotations about the sphere."""
    rng = np.random.default_rng(seed)
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    T = np.array([0, 0, 3.0], np.float32)
    rots = [np.eye(3, dtype=np.float32)] + [
        np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        for _ in range(n)]
    return [dict(K=K, R=R, T=T, hw=(64, 64)) for R in rots]


def check_rasterizer(v, t, cams):
    """The port's native rasterizer against the JAX package's native one bit
    for bit, and its numpy route against its native route (the JAX test's
    bounds: edge-pixel coverage and z-fights)."""
    for cam in cams:
        rgb, dep = mesh_render.render_mesh(v, t, **cam)
        jrgb, jdep = jrender.render_mesh(v, t, **cam)
        np.testing.assert_array_equal(rgb, jrgb)
        np.testing.assert_array_equal(dep, jdep)
        nrgb, ndep = mesh_render._render_np(
            v, t.astype(np.int64), cam["K"], cam["R"], cam["T"], cam["hw"])
        filled, nfilled = dep > 0, ndep > 0
        assert filled.sum() > 100
        assert (filled ^ nfilled).mean() < 0.01
        both = filled & nfilled
        assert (np.abs(dep[both] - ndep[both]) > 1e-2).mean() < 0.01


def test_rasterizer_equals_the_jax_native_on_a_sphere():
    v, t = sphere_mesh()
    check_rasterizer(v, t, cameras())


def test_mesh_sequence_writes_the_rasterized_pngs(tmp_path):
    from transhuman_tpu_torch.data.image_io import read_png
    from transhuman_tpu_torch.mesh_ops.ply import save_ply

    v, t = sphere_mesh()
    plys = []
    for i in range(2):
        plys.append(str(tmp_path / f"m{i}.ply"))
        save_ply(plys[-1], v + np.float32(0.1 * i), t)
    cams = cameras(1)
    w2c = [np.concatenate([np.concatenate([c["R"], c["T"][:, None]], 1),
                           [[0, 0, 0, 1]]]).astype(np.float32) for c in cams]
    paths = mesh_render.render_mesh_sequence(plys, cams[0]["K"], w2c,
                                             (64, 64), str(tmp_path / "out"))
    assert [os.path.basename(p) for p in paths] == ["mesh0000.png",
                                                    "mesh0001.png"]
    rgb, _ = mesh_render.render_mesh(v + np.float32(0.1), t, cams[0]["K"],
                                     w2c[1][:3, :3], w2c[1][:3, 3], (64, 64))
    # the JAX package's cv2.imwrite(clip(rgb[..., ::-1] * 255)) in RGB
    want = np.clip(rgb * 255, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(read_png(paths[1]), want)


def _frames(n=5, h=24, w=32):
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    return [np.stack([x / w, y / h, np.full_like(x, i / n)], -1)
            for i in range(n)]


def test_avi_is_byte_equal_to_the_jax_writer(tmp_path, monkeypatch):
    """Fed the same JPEG payloads (the JAX writer's encoder swapped for the
    port's), both files are the same bytes; odd-sized payloads pad."""
    monkeypatch.setattr(javi, "encode_jpeg", avi.encode_jpeg)
    frames = _frames(5) + [np.zeros((24, 32), np.uint16),
                           np.full((24, 32, 3), 255, np.uint8)]
    paths = {}
    for tag, mod in (("port", avi), ("jax", javi)):
        paths[tag] = str(tmp_path / f"{tag}.avi")
        with mod.MJPGWriter(paths[tag], 32, 24, fps=10) as w:
            for f in frames:
                w.append(f)
    port = open(paths["port"], "rb").read()
    assert port == open(paths["jax"], "rb").read()
    p = parse_avi(paths["port"])
    assert len(p["frames"]) == len(p["idx"]) == len(frames)
    with pytest.raises(ValueError, match="stream was opened as 24x32"):
        with avi.MJPGWriter(str(tmp_path / "bad.avi"), 32, 24) as w:
            w.append(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError, match="unsupported frame dtype"):
        avi.encode_jpeg(np.zeros((8, 8, 3), np.int32))


def _images():
    rng = np.random.default_rng(0)
    out = {}
    for h, w in ((16, 16), (17, 23), (64, 64), (33, 65), (1, 1), (8, 9),
                 (100, 37)):
        y, x = np.mgrid[0:h, 0:w].astype(np.float32)
        smooth = np.stack([x / w, y / h, 0.5 + 0.5 * np.sin(x / 3 + y / 5)],
                          -1)
        out[f"smooth{h}x{w}"] = (smooth * 255).astype(np.uint8)
        out[f"noise{h}x{w}"] = rng.integers(0, 256, (h, w, 3), np.uint8)
    out["float"] = np.clip(_frames(1, 40, 56)[0] * 1.2 - 0.1, -1, 2)
    out["grey16"] = (rng.integers(0, 65536, (20, 30))).astype(np.uint16)
    return out


@pytest.mark.parametrize("name", sorted(_images()))
def test_jpeg_decodes_alike_and_matches_opencv_quality(name):
    """Each stream decodes to the same pixels through the port's decoder and
    OpenCV's, and its PSNR against the source is within PSNR_ATOL of
    cv2.imencode's quality-95 stream's; the bytes that differ from OpenCV's
    stream are reported."""
    src = avi.to_rgb8(_images()[name])
    jpg = avi.encode_jpeg(_images()[name])
    assert jpg[:2] == b"\xff\xd8" and jpg[-2:] == b"\xff\xd9"
    assert jpg[6:11] == b"JFIF\x00"
    ours = decode_jpeg(jpg)
    theirs = cv2.imdecode(np.frombuffer(jpg, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(ours, theirs[..., ::-1])
    ok, ref = cv2.imencode(".jpg", src[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    ref = ref.tobytes()
    ref_img = decode_jpeg(ref)

    def psnr(img):
        mse = np.mean((img.astype(np.float64) - src) ** 2)
        return 99.0 if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)

    assert abs(psnr(ours) - psnr(ref_img)) <= PSNR_ATOL
    n = min(len(jpg), len(ref))
    differ = int(np.sum(np.frombuffer(jpg[:n], np.uint8)
                        != np.frombuffer(ref[:n], np.uint8))
                 + abs(len(jpg) - len(ref)))
    print(f"{name}: {len(jpg)} bytes, {differ} differ from cv2.imencode's")


def test_frames_to_video_sorts_numerically(tmp_path, capsys):
    """frame10000 comes after frame9999; one AVI frame per PNG, in order;
    the .avi path is returned and said on stderr."""
    d = tmp_path / "frames"
    d.mkdir()
    names = ["frame9999.png", "frame10000.png", "frame0002.png",
             "frame0010.png"]
    values = [40, 200, 10, 100]  # the order frame_to_video must keep
    for name, val in zip(names, values):
        png.write_png(str(d / name), np.full((16, 24, 3), val, np.uint8))
    (d / "notes.txt").write_text("not a frame")
    out = video.frames_to_video(str(d), str(tmp_path / "h.mp4"), fps=5)
    assert out == str(tmp_path / "h.avi")
    assert "writing MJPG/AVI" in capsys.readouterr().err
    p = parse_avi(out)
    assert p["avih"][0] == 200000 and len(p["frames"]) == 4
    got = [int(decode_jpeg(p["buf"][s:s + n]).mean()) for s, n in p["frames"]]
    assert all(abs(g - v) <= 1 for g, v in zip(got, [10, 100, 40, 200]))
    assert video.main([str(d), str(tmp_path / "v.avi")]) is None
    assert os.path.exists(tmp_path / "v.avi")
    with pytest.raises(ValueError, match="no frames"):
        video.frames_to_video(str(tmp_path), str(tmp_path / "x.mp4"))
