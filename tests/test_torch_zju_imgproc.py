"""The port's numpy replacements for the OpenCV calls of the ZJU-MoCap input
path (transhuman_tpu_torch/data/imgproc.py) against the calls they replace,
on seeded inputs; and the geometry and jitter built on them against the JAX
package's.

What OpenCV 5.x does, as the tests below confirm: remap interpolates with
the map's float fraction through fused multiply-adds (no 1/32 table), for
float32 and uint8 alike; fillPoly fills each scanline from the ceiling of
the left edge to the floor of the right, in 16.16 fixed point without a
half-pixel offset, and draws the outline; the float HSV conversions use
fused multiply-adds in their vector path.
"""

import cv2
import numpy as np
import pytest

from transhuman_tpu.data.jitter import color_jitter as jax_color_jitter
from transhuman_tpu.geometry import rays as jrays
from transhuman_tpu_torch.data import imgproc
from transhuman_tpu_torch.data.jitter import color_jitter
from transhuman_tpu_torch.geometry import rays

BOX = np.ones((5, 5), np.uint8)


# ------------------------------------------------------------- morphology
@pytest.mark.parametrize("seed", range(3))
def test_erode_and_dilate_equal_cv2(seed):
    rng = np.random.default_rng(seed)
    h, w = rng.integers(5, 70, 2)
    cases = [(rng.random((h, w)) > 0.5).astype(np.uint8),
             np.ones((h, w), np.uint8),  # the border must not erode
             np.zeros((h, w), np.uint8)]
    m = np.zeros((h, w), np.uint8)
    m[h // 4:3 * h // 4, :] = 1  # touching the left and right edges
    cases.append(m)
    cases.append((rng.random((h, w)) * 3).astype(np.uint8) * 50)
    for img in cases:
        np.testing.assert_array_equal(imgproc.erode(img, 5),
                                      cv2.erode(img.copy(), BOX))
        np.testing.assert_array_equal(imgproc.dilate(img, 5),
                                      cv2.dilate(img.copy(), BOX))


# -------------------------------------------------------------- fillPoly
def _cv2_fill(h, w, pts):
    m = np.zeros((h, w), np.uint8)
    cv2.fillPoly(m, [np.asarray(pts, np.int32)], 1)
    return m


def _port_fill(h, w, pts):
    return imgproc.fill_poly(np.zeros((h, w), np.uint8), pts, 1)


def test_fill_poly_equals_cv2_inside_the_image():
    rng = np.random.default_rng(0)
    for t in range(1500):
        h, w = rng.integers(8, 64, 2)
        pts = rng.integers(0, min(h, w), (rng.integers(3, 6), 2))
        if t % 5 == 0:
            pts[2:] = pts[1]  # degenerate: a segment
        if t % 7 == 0:
            pts[:, 0] = pts[0, 0]  # degenerate: a vertical line
        np.testing.assert_array_equal(_port_fill(h, w, pts),
                                      _cv2_fill(h, w, pts), err_msg=str(pts))


@pytest.mark.parametrize("reach", [1, 10])
def test_fill_poly_across_the_border_equals_cv2(reach):
    """Polygons that cross the image border, bit for bit: with vertices up
    to 40 px outside (reach 1), and up to 10x the image size outside (reach
    10).  OpenCV 5 clips each edge to the image and keeps the clipped ends'
    x, and their y where the clipped edge is not flat, so an edge clipped to
    one border pixel fills that border column over its whole y span."""
    rng = np.random.default_rng(5 if reach == 1 else 6)
    differ = 0
    for _ in range(1000):
        h, w = rng.integers(10, 70, 2)
        n = rng.integers(3, 6)
        if reach == 1:
            pts = rng.integers(-40, 100, (n, 2))
        else:
            pts = np.stack([rng.integers(-reach * w, (reach + 1) * w, n),
                            rng.integers(-reach * h, (reach + 1) * h, n)], 1)
        got, want = _port_fill(h, w, pts), _cv2_fill(h, w, pts)
        differ += not np.array_equal(got, want)
    assert differ == 0


def _box_cases(rng, n):
    """(bounds, K, pose, H, W): seeded boxes seen from seeded cameras,
    edge-on views among them."""
    for i in range(n):
        mn = rng.uniform(-0.5, 0.3, 3)
        bounds = np.stack([mn, mn + rng.uniform(0.05, 0.8, 3)])
        if i % 4 == 0:
            bounds[1, 2] = bounds[0, 2]  # flat box: degenerate faces
        th = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(th), 0, -np.sin(th)], [0, 1, 0],
                      [np.sin(th), 0, np.cos(th)]])
        if i % 6 == 0:
            R = np.eye(3)  # a face seen edge-on
        pos = np.array([-3 * np.sin(th), 0.1, -3 * np.cos(th)])
        T = -R @ pos
        H, W = 64, 48
        K = np.array([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
        yield bounds, K, np.concatenate([R, T[:, None]], 1), H, W


def test_bound_2d_mask_equals_the_jax_package_on_boxes():
    """Boxes projected inside the image, bit for bit (their six faces, the
    second closing on corner 5)."""
    compared = 0
    for bounds, K, pose, H, W in _box_cases(np.random.default_rng(1), 60):
        corners = jrays.project(jrays.get_bound_corners(bounds), K, pose)
        if not ((corners >= 0).all() and (corners[:, 0] < W - 1).all()
                and (corners[:, 1] < H - 1).all()):
            continue
        np.testing.assert_array_equal(
            rays.get_bound_2d_mask(bounds, K, pose, H, W),
            jrays.get_bound_2d_mask(bounds, K, pose, H, W))
        compared += 1
    assert compared >= 20
    assert rays._FACES[1] == [4, 5, 7, 6, 5]


def test_hull_near_far_and_eval_rays_equal_the_jax_package():
    for bounds, K, pose, H, W in _box_cases(np.random.default_rng(2), 30):
        R, T = pose[:, :3], pose[:, 3:]
        ro, rd = rays.get_rays(H, W, K, R, T)
        jro, jrd = jrays.get_rays(H, W, K, R, T)
        np.testing.assert_array_equal(ro, jro)
        got = rays.get_near_far_hull(bounds, ro.reshape(-1, 3),
                                     rd.reshape(-1, 3), K, R, T, H, W)
        want = jrays.get_near_far_hull(bounds, jro.reshape(-1, 3),
                                       jrd.reshape(-1, 3), K, R, T, H, W)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # a corner behind the camera: the dense test
    bounds = np.array([[-1.0, -1, -4], [1, 1, 1]])
    K = np.array([[50.0, 0, 24], [0, 50.0, 32], [0, 0, 1]])
    R, T = np.eye(3), np.array([[0.0], [0], [3.5]])
    ro, rd = rays.get_rays(64, 48, K, R, T)
    got = rays.get_near_far_hull(bounds, ro.reshape(-1, 3),
                                 rd.reshape(-1, 3), K, R, T, 64, 48)
    want = jrays.get_near_far_hull(bounds, ro.reshape(-1, 3),
                                   rd.reshape(-1, 3), K, R, T, 64, 48)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------ undistort / remap
def _camera(rng, h, w):
    K = np.array([[rng.uniform(0.8, 1.2) * w, 0, w / 2 + rng.normal(0, 3)],
                  [0, rng.uniform(0.8, 1.2) * w, h / 2 + rng.normal(0, 3)],
                  [0, 0, 1]], np.float32)
    D = np.array([rng.uniform(-0.35, 0.1), rng.uniform(-0.1, 0.3),
                  rng.normal(0, 2e-3), rng.normal(0, 2e-3),
                  rng.uniform(-0.05, 0.05)], np.float32)
    return K, D


@pytest.mark.parametrize("seed", range(3))
def test_undistort_maps_equal_cv2(seed):
    rng = np.random.default_rng(seed)
    h, w = (1024, 1024) if seed == 0 else tuple(rng.integers(20, 90, 2))
    K, D = _camera(rng, h, w)
    mx, my = imgproc.undistort_maps(K, D, (h, w))
    cx, cy = cv2.initUndistortRectifyMap(K, D, None, K, (int(w), int(h)),
                                         cv2.CV_32FC1)
    assert np.abs(mx - cx).max() <= 1e-4 and np.abs(my - cy).max() <= 1e-4
    # a map value that crossed a float32 rounding step: none measured
    assert int((mx != cx).sum() + (my != cy).sum()) == 0
    assert imgproc.undistort_maps(K, np.zeros(5), (h, w)) == (None, None)
    with pytest.raises(ValueError, match="8 terms"):
        imgproc.undistort_maps(K, np.ones(8), (h, w))


@pytest.mark.parametrize("seed", range(3))
def test_remap_equals_cv2(seed):
    rng = np.random.default_rng(10 + seed)
    h, w = tuple(rng.integers(20, 90, 2))
    K, D = _camera(rng, h, w)
    mx, my = imgproc.undistort_maps(K, D, (h, w))
    # and arbitrary maps reaching past every border
    ax = (rng.random((h, w)) * (w + 6) - 3).astype(np.float32)
    ay = (rng.random((h, w)) * (h + 6) - 3).astype(np.float32)
    img = rng.random((h, w, 3)).astype(np.float32)
    msk = np.zeros((h, w), np.uint8)
    msk[h // 4:3 * h // 4, w // 4:3 * w // 4] = 1
    msk[h // 4:h // 4 + 3] = 100  # the border label: {0, 1, 100} blends
    for maps in ((mx, my), (ax, ay)):
        plan = imgproc.remap_plan(*maps, (h, w))
        for src in (img, msk, (img * 255).astype(np.uint8)):
            want = cv2.remap(src, *maps, cv2.INTER_LINEAR)
            got = imgproc.remap_linear(src, plan)
            assert got.dtype == want.dtype and got.shape == want.shape
            # bit for bit: no pixel flips
            assert int((got != want).sum()) == 0


# ----------------------------------------------------------------- resize
@pytest.mark.parametrize("src,dst", [((1024, 1024), (512, 512)),
                                     ((64, 50), (32, 25)),
                                     ((64, 50), (16, 10)),
                                     ((37, 53), (18, 26)),
                                     ((64, 50), (25, 19)),
                                     ((60, 60), (13, 13))])
def test_resizes_equal_cv2(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.random((*src, 3)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = imgproc.resize_area(img, dst[::-1])
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6
    if src == (1024, 1024):
        np.testing.assert_array_equal(got, want)  # the fast path: bits
    m = (rng.random(src) * 3).astype(np.uint8) * 50
    np.testing.assert_array_equal(
        imgproc.resize_nearest(m, dst[::-1]),
        cv2.resize(m, dst[::-1], interpolation=cv2.INTER_NEAREST))


# -------------------------------------------------------------------- HSV
@pytest.mark.parametrize("hw", [(64, 64), (37, 53), (512, 512)])
def test_hsv_equals_cv2(hw):
    rng = np.random.default_rng(hw[0])
    img = rng.random((*hw, 3)).astype(np.float32)
    img[0, :6] = [0.5, 0.5, 0.5]  # grey: s = 0
    img[1, :6] = [0.2, 0.7, 0.7]  # ties between the maxima
    img[2, :6] = 0.0
    hsv = imgproc.rgb_to_hsv(img)
    want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    assert np.abs(hsv - want).max() <= 1e-5
    back = imgproc.hsv_to_rgb(want)
    assert np.abs(back - cv2.cvtColor(want, cv2.COLOR_HSV2RGB)).max() <= 1e-5


@pytest.mark.parametrize("seed", [0, 7, 11, 2024])
def test_color_jitter_equals_the_jax_package(seed):
    img = np.random.default_rng(seed).random((48, 40, 3)).astype(np.float32)
    got, want = color_jitter(img, seed), jax_color_jitter(img, seed)
    assert np.abs(got - want).max() <= 2e-5
