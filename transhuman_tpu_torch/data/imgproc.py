"""numpy replacements for the OpenCV calls of the ZJU-MoCap input path (the
card's machine has no OpenCV).  Each is held against the call it replaces
in ``tests/test_torch_zju_imgproc.py``:

* ``erode`` / ``dilate``: ``cv2.erode`` / ``cv2.dilate`` with a k x k box
  and the default border, which neither erodes nor dilates;
* ``undistort_maps``: ``cv2.initUndistortRectifyMap(K, D, None, K, (w, h),
  CV_32FC1)`` for the 5-term k1, k2, p1, p2, k3 model, in float64, stored
  float32;
* ``remap_linear``: ``cv2.remap(img, mx, my, INTER_LINEAR)`` with
  BORDER_CONSTANT 0.  OpenCV's current remap interpolates with the map's
  float fraction (no 1/32 table): a fused multiply-add lerp along x on both
  rows, then along y; uint8 rounds that to nearest, ties to even;
* ``resize_area``: ``cv2.resize(..., INTER_AREA)`` down-scaling: at an
  integer factor OpenCV's fast path (the k x k samples summed row by row,
  times 1/k^2 in float32), else separable area-overlap matrices in float64;
* ``resize_nearest``: INTER_NEAREST, source index ``floor(x * src / dst)``;
* ``fill_poly``: ``cv2.fillPoly(mask, [pts], value)`` (LINE_8, shift 0):
  the outline drawn by Bresenham lines clipped to the image, then the
  scanline fill of OpenCV's edge table in 16.16 fixed point;
* ``rgb_to_hsv`` / ``hsv_to_rgb``: ``COLOR_RGB2HSV`` / ``COLOR_HSV2RGB`` on
  float32, H in [0, 360), with the FLT_EPSILON terms and the fused
  multiply-adds of OpenCV's vector path.

A fused multiply-add is formed in float64, where the product of two
float32 values is exact, and rounded once to float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

_F32 = np.float32
_EPS = np.float32(np.finfo(np.float32).eps)
XY_SHIFT = 16  # OpenCV's fixed point for polygon edges


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once."""
    out = np.multiply(a, b, dtype=np.float64)
    out += c
    return out.astype(_F32)


# ------------------------------------------------------------- morphology
def _morph(img: np.ndarray, k: int, op, pad) -> np.ndarray:
    r = k // 2
    h, w = img.shape[:2]
    p = np.pad(img, ((r, k - 1 - r), (r, k - 1 - r)), constant_values=pad)
    rows = p[:, 0:w].copy()
    for i in range(1, k):
        op(rows, p[:, i:i + w], out=rows)
    out = rows[0:h].copy()
    for i in range(1, k):
        op(out, rows[i:i + h], out=out)
    return out


def erode(img: np.ndarray, k: int = 5) -> np.ndarray:
    """Minimum over the k x k box; outside the image counts as the dtype's
    maximum (cv2.erode's default border)."""
    return _morph(img, k, np.minimum, np.iinfo(img.dtype).max)


def dilate(img: np.ndarray, k: int = 5) -> np.ndarray:
    """Maximum over the k x k box; outside the image counts as 0."""
    return _morph(img, k, np.maximum, 0)


# ------------------------------------------------------------- undistort
def undistort_maps(K, D, hw) -> tuple:
    """(map_x, map_y), each (h, w) float32: the source pixel of every
    undistorted pixel, for intrinsics K (3, 3) and distortion D (k1, k2, p1,
    p2[, k3]), the new camera K and no rectification.  (None, None) when D
    is all zero: the remap would be the identity."""
    D = np.asarray(D, np.float64).ravel()
    if D.size > 5:
        raise ValueError(f"distortion with {D.size} terms: only the 5-term "
                         "k1, k2, p1, p2, k3 model is supported")
    if not np.any(D):
        return None, None
    k1, k2, p1, p2, k3 = np.pad(D, (0, 5 - D.size))
    A = np.asarray(K, np.float64)
    h, w = hw
    iR = np.linalg.inv(A)
    fx, fy, u0, v0 = A[0, 0], A[1, 1], A[0, 2], A[1, 2]
    j = np.arange(w, dtype=np.float64)[None, :]
    i = np.arange(h, dtype=np.float64)[:, None]
    _x = i * iR[0, 1] + iR[0, 2] + j * iR[0, 0]
    _y = i * iR[1, 1] + iR[1, 2] + j * iR[1, 0]
    _w = i * iR[2, 1] + iR[2, 2] + j * iR[2, 0]
    x, y = _x / _w, _y / _w
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    return u.astype(_F32), v.astype(_F32)


class RemapPlan(NamedTuple):
    """The taps and fractions of one (map_x, map_y) pair (``remap_plan``),
    formed once per camera; a tuple of arrays, so a ByteLRU counts its
    bytes.  The image is read as overlapping pairs of horizontally adjacent
    pixels (one gather fetches both taps of a row) from a copy with one zero
    pixel before it and a zero row after it: ``top`` and ``bottom`` index
    the pairs of the two rows, ``valid`` (4, n) says whether each tap lies
    inside the source, ``ax``/``ay`` (n, 1) are the fractions."""

    ax: np.ndarray
    ay: np.ndarray
    top: np.ndarray
    bottom: np.ndarray
    valid: np.ndarray
    shape: tuple  # the output's (h, w)
    src_hw: tuple  # the source's (h, w)


def remap_plan(mx: np.ndarray, my: np.ndarray, src_hw) -> RemapPlan:
    sh, sw = src_hw
    x0 = np.floor(mx)
    y0 = np.floor(my)
    ax = (mx - x0).astype(_F32).reshape(-1, 1)
    ay = (my - y0).astype(_F32).reshape(-1, 1)
    x0 = x0.astype(np.int64).ravel()
    y0 = y0.astype(np.int64).ravel()
    last = sh * sw + sw
    b = y0 * sw + x0 + 1
    valid = np.stack([(yy >= 0) & (yy < sh) & (xx >= 0) & (xx < sw)
                      for yy in (y0, y0 + 1) for xx in (x0, x0 + 1)])
    return RemapPlan(ax, ay, np.clip(b, 0, last).astype(np.intp),
                     np.clip(b + sw, 0, last).astype(np.intp), valid,
                     tuple(mx.shape), (sh, sw))


def _taps(img: np.ndarray, plan: RemapPlan) -> list:
    """[p00, p01, p10, p11] of img, each (n, c) float32, 0 where the tap
    lies outside the source."""
    sh, sw = plan.src_hw
    c = img.shape[2] if img.ndim == 3 else 1
    flat = np.zeros((sh * sw + sw + 2) * c, img.dtype)
    flat[c:c + sh * sw * c] = img.reshape(-1)
    item = c * img.itemsize
    pairs = np.ndarray((sh * sw + sw + 1,), np.dtype((np.void, 2 * item)),
                       buffer=flat, strides=(item,))
    out = []
    for row, idx in enumerate((plan.top, plan.bottom)):
        both = pairs[idx].view(img.dtype).reshape(-1, 2, c)
        for k in range(2):
            t = both[:, k].astype(_F32)
            t[~plan.valid[2 * row + k]] = 0
            out.append(t)
    return out


def remap_linear(img: np.ndarray, plan: RemapPlan) -> np.ndarray:
    """cv2.remap(img, map_x, map_y, INTER_LINEAR), BORDER_CONSTANT 0, for
    an (h, w) or (h, w, c) float32 or uint8 image; plan is
    ``remap_plan(map_x, map_y, img.shape[:2])``."""
    if img.dtype not in (np.uint8, _F32):
        raise TypeError(f"remap_linear: {img.dtype} images are not supported")
    if img.shape[:2] != plan.src_hw:
        raise ValueError(f"image {img.shape[:2]} does not match the plan's "
                         f"source {plan.src_hw}")
    p00, p01, p10, p11 = _taps(img, plan)
    r0 = _fma(plan.ax, p01 - p00, p00)
    r1 = _fma(plan.ax, p11 - p10, p10)
    out = _fma(plan.ay, r1 - r0, r0)
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape(plan.shape + img.shape[2:])


# ----------------------------------------------------------------- resize
def _area_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of OpenCV's computeResizeAreaTab."""
    scale = src / dst
    A = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1 = int(np.ceil(fsx1))
        sx2 = int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            A[dx, sx1 - 1] = (sx1 - fsx1) / cell
        for sx in range(sx1, sx2):
            A[dx, sx] = 1.0 / cell
        if fsx2 - sx2 > 1e-3:
            A[dx, sx2] = min(min(fsx2 - sx2, 1.0), cell) / cell
    return A


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=INTER_AREA) of a float32
    (h, w[, c]) image, down-scaling only."""
    W, H = size
    h, w = img.shape[:2]
    if H > h or W > w:
        raise ValueError("resize_area down-scales only")
    img = np.asarray(img, _F32)
    kx, ky = w / W, h / H
    if kx == int(kx) and ky == int(ky):
        kx, ky = int(kx), int(ky)
        out = None
        for dy in range(ky):
            for dx in range(kx):
                s = img[dy:ky * H:ky, dx:kx * W:kx]
                out = s.copy() if out is None else np.add(out, s, out=out)
        return out * _F32(1.0 / (kx * ky))
    Ay, Ax = _area_matrix(h, H), _area_matrix(w, W)
    out = np.tensordot(Ay, img.astype(np.float64), axes=(1, 0))
    out = np.tensordot(Ax, out, axes=(1, 1)).swapaxes(0, 1)
    return out.astype(_F32)


def resize_nearest(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=INTER_NEAREST)."""
    W, H = size
    h, w = img.shape[:2]
    sy = np.minimum(np.floor(np.arange(H) * (h / H)).astype(np.int64), h - 1)
    sx = np.minimum(np.floor(np.arange(W) * (w / W)).astype(np.int64), w - 1)
    return img[sy[:, None], sx[None, :]]


# -------------------------------------------------------------- fillPoly
def _clip_line(w: int, h: int, p1, p2):
    """OpenCV's clipLine: (whether the segment meets [0, w) x [0, h), p1,
    p2 moved onto the border).  A segment that misses the image still comes
    back with the moves made before that showed, as OpenCV leaves its
    arguments."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _line8(mask: np.ndarray, p1, p2, value):
    """cv2.line(mask, p1, p2, value, LINE_8) of thickness 1 (its
    LineIterator: clipped to the image, drawn left to right)."""
    h, w = mask.shape
    if not (0 <= p1[0] < w and 0 <= p2[0] < w and 0 <= p1[1] < h
            and 0 <= p2[1] < h):
        inside, p1, p2 = _clip_line(w, h, p1, p2)
        if not inside:
            return
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    k = np.arange(major + 1, dtype=np.int64)
    c = (2 * minor * k + major - 1) // (2 * major) if major else k * 0
    if vert:
        xs, ys = x1 + c, y1 + sy * k
    else:
        xs, ys = x1 + k, y1 + sy * c
    mask[ys, xs] = value


def fill_poly(mask: np.ndarray, pts, value=1) -> np.ndarray:
    """cv2.fillPoly(mask, [pts], value) with LINE_8 and shift 0, in place on
    a 2-D mask; pts (n, 2) integer (x, y) vertices.  Returns mask."""
    h, w = mask.shape
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    one = 1 << XY_SHIFT
    edges = []  # (y0, y1, x, dx) in 16.16 fixed point
    p0 = pts[-1]
    for p1 in pts:
        _line8(mask, p0, p1, value)
        x0c, y0c = p0[0] << XY_SHIFT, p0[1]
        x1c, y1c = p1[0] << XY_SHIFT, p1[1]
        if not (0 <= p0[0] < w and 0 <= p1[0] < w and 0 <= p0[1] < h
                and 0 <= p1[1] < h):
            # OpenCV 5 takes the clipped ends' x always, and their y only
            # where the clipped segment is not flat (its clipLine result is
            # not read): a segment clipped to one border pixel becomes a
            # vertical edge at that column over the whole original y span
            _, t0, t1 = _clip_line(w, h, p0, p1)
            x0c, x1c = t0[0] << XY_SHIFT, t1[0] << XY_SHIFT
            if t0[1] != t1[1]:
                y0c, y1c = t0[1], t1[1]
        if p0[1] != p1[1]:
            num, den = x1c - x0c, y1c - y0c
            q = abs(num) // abs(den)
            edx = q if (num >= 0) == (den >= 0) else -q  # C's truncation
            if p0[1] < p1[1]:
                edges.append((p0[1], p1[1], x0c + (p0[1] - y0c) * edx, edx))
            else:
                edges.append((p1[1], p0[1], x1c + (p1[1] - y1c) * edx, edx))
        p0 = p1
    if len(edges) < 2:
        return mask
    e = np.array(edges, np.int64)
    ends = e[:, 2] + (e[:, 1] - e[:, 0]) * e[:, 3]
    y_min, y_max = int(e[:, 0].min()), int(e[:, 1].max())
    x_min = min(int(e[:, 2].min()), int(ends.min()))
    x_max = max(int(e[:, 2].max()), int(ends.max()))
    if y_max < 0 or y_min >= h or x_max < 0 or x_min >= (w << XY_SHIFT):
        return mask
    y_lo, y_hi = max(y_min, 0), min(y_max, h)
    if y_lo >= y_hi:
        return mask
    ys = np.arange(y_lo, y_hi, dtype=np.int64)[:, None]
    active = (e[None, :, 0] <= ys) & (ys < e[None, :, 1])
    xs = e[None, :, 2] + (ys - e[None, :, 0]) * e[None, :, 3]
    big = np.iinfo(np.int64).max
    xs = np.sort(np.where(active, xs, big), axis=1)
    n = active.sum(1)
    for p in range(0, xs.shape[1] - 1, 2):
        rows = np.nonzero(n >= p + 2)[0]
        if rows.size == 0:
            break
        x1 = (xs[rows, p] + one - 1) >> XY_SHIFT
        x2 = xs[rows, p + 1] >> XY_SHIFT
        ok = (x1 < w) & (x2 >= 0)
        rows, x1, x2 = rows[ok], np.maximum(x1[ok], 0), np.minimum(x2[ok],
                                                                    w - 1)
        if rows.size == 0:
            continue
        cols = np.arange(w)[None, :]
        span = (cols >= x1[:, None]) & (cols <= x2[:, None])
        sub = mask[y_lo + rows]
        sub[span] = value
        mask[y_lo + rows] = sub
    return mask


# -------------------------------------------------------------------- HSV
def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, COLOR_RGB2HSV) of float32 RGB: H in [0, 360)."""
    img = np.asarray(img, _F32)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _EPS)
    d = _F32(60.0) / (diff + _EPS)
    gb = g - b
    h_r = gb * d
    h_r = np.where(h_r < 0, _fma(gb, d, 360.0), h_r)
    h = np.where(v == r, h_r,
                 np.where(v == g, _fma(b - r, d, 120.0),
                          _fma(r - g, d, 240.0)))
    return np.stack([h, s, v], -1).astype(_F32)


# sector -> indices into (v, p, q, t) of (b, g, r), OpenCV's sector_data
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                     [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(hsv, COLOR_HSV2RGB) of float32 HSV, H in [0, 360)."""
    hsv = np.asarray(hsv, _F32)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h6 = np.fmod(h * _F32(6.0 / 360.0), _F32(6.0))
    h6 = np.where(h6 < 0, h6 + _F32(6.0), h6)
    sector = np.floor(h6).astype(np.int64)
    frac = h6 - sector.astype(_F32)
    bad = (sector < 0) | (sector >= 6)
    sector = np.where(bad, 0, sector)
    frac = np.where(bad, _F32(0), frac)
    one = _F32(1.0)
    tab = np.stack([v, v * (one - s), v * _fma(-s, frac, 1.0),
                    v * _fma(-s, one - frac, 1.0)], -1)
    pick = _SECTORS[sector]  # (..., 3): b, g, r
    bgr = np.take_along_axis(tab, pick, -1)
    rgb = bgr[..., ::-1]
    return np.where((s == 0)[..., None], v[..., None], rgb).astype(_F32)
