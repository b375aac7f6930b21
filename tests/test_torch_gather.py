"""The forward feature gather: the plain twin of kernel K4 against the JAX
package's sample_feature_map forward, against numpy transcriptions of the
TPU gather kernels it replaces (tools/profile_gather_ab.py,
probe_block_gather*.py, probe_dma_gather*.py), and inside the port's
sampling Function; and the numpy oracle of the TPU scatter probe
(tools/probe_stream_scatter.py) against K3's plain twin with taps +0..+3.
The CUDA kernels are held against these twins on a card in
tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transhuman_tpu.ops.sampling import project_points as jax_project
from transhuman_tpu.ops.sampling import sample_feature_map as jax_sfm
from transhuman_tpu_torch import kernels
from transhuman_tpu_torch.kernels import gather, scatter
from transhuman_tpu_torch.ops.sampling import (
    _bilinear_w4,
    _sample_taps,
    sample_feature_map,
)

V, HF, WF, C, N = 3, 16, 20, 8, 257
IMAGE = (32, 40)  # the maps at half the image size on both axes


def _uv(rng, wf=WF):
    """uv (V, N, 2) in image pixels: inside the image, past every border,
    exactly on the borders, and projections of points on a camera's
    principal plane (|z| clamped, uv far outside)."""
    uv = rng.uniform(-6, 46, (V, N, 2)).astype(np.float32)
    uv[:, :16, 0] = 0.0
    uv[:, 16:32, 0] = IMAGE[1] * (wf - 1) / wf  # fx == Wf - 1 exactly
    uv[:, 32:48, 1] = IMAGE[0] * (HF - 1) / HF
    K = np.tile(np.float32([[30, 0, 20], [0, 30, 16], [0, 0, 1]]), (V, 1, 1))
    R = np.tile(np.eye(3, dtype=np.float32), (V, 1, 1))
    T = np.tile(np.float32([0, 0, 2.5]), (V, 1))
    xyz = rng.uniform(-1, 1, (9, 3)).astype(np.float32)
    xyz[:, 2] = -2.5 + rng.uniform(-1e-7, 1e-7, 9)  # z_cam ~ 0
    z_uv, _ = jax_project(*map(jnp.asarray, (xyz, K, R, T)))
    uv[:, 48:57] = np.asarray(z_uv)
    return uv


@pytest.mark.parametrize("wf", [WF, 1])
def test_plain_k4_equals_the_jax_sampler(wf):
    """The bilinear fetch through K4's plain twin equals the JAX package's
    sample_feature_map forward (its 2x2 patch gather and lerp).  A map one
    texel wide (taps +0 and +Wf only), which the JAX sampler's 2x2 slice
    cannot take, against the JAX sampler on the map with its one column
    repeated: every x then interpolates between equal values."""
    rng = np.random.default_rng(0)
    feat = rng.uniform(-1, 1, (V, HF, wf, C)).astype(np.float32)
    uv = _uv(rng, wf)
    ref = feat if wf > 1 else np.repeat(feat, 2, axis=2)
    want = np.asarray(jax_sfm(jnp.asarray(ref), jnp.asarray(uv), IMAGE))
    kernels.reset_launch_counts()
    got = sample_feature_map(torch.from_numpy(feat), torch.from_numpy(uv),
                             IMAGE)
    assert kernels.launch_counts()["feature_gather"] == 0  # CPU: plain twin
    assert got.shape == (V, N, C) and got.dtype == torch.float32
    # the same weights, summed as four products against two lerps
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    assert np.isfinite(got.numpy()).all()


def _k4_inputs(rng, hw=64 * 48, c=C, n=N, taps=4):
    src = rng.standard_normal((V, hw, c)).astype(np.float32)
    ids = rng.integers(0, hw - 48 - 1, (V, n)).astype(np.int32)
    ids[:, ::6] = -1
    w = rng.random((V, n, taps)).astype(np.float32)
    return src, ids, w


def test_plain_k4_equals_the_quad_gather():
    """tools/profile_gather_ab.py's pallas_gather (T1) and _sp_call (T2):
    the 2x2 rows of a (V*H*W, 4C) quad table lerped with w4, ids -1 giving
    zero rows, transcribed in numpy."""
    rng = np.random.default_rng(1)
    h, w = 48, 64
    pm = rng.standard_normal((V, h, w, C)).astype(np.float32)
    # build_quad: [f(y,x), f(y,x+1), f(y+1,x), f(y+1,x+1)], edges replicated
    sx = np.concatenate([pm[:, :, 1:], pm[:, :, -1:]], axis=2)
    sy = np.concatenate([pm[:, 1:], pm[:, -1:]], axis=1)
    sxy = np.concatenate([sx[:, 1:], sx[:, -1:]], axis=1)
    quad = np.concatenate([pm, sx, sy, sxy], axis=-1).reshape(-1, 4 * C)
    y0 = rng.integers(0, h - 1, (V, N))
    x0 = rng.integers(0, w - 1, (V, N))
    ids = (y0 * w + x0).astype(np.int32)
    ids[:, ::5] = -1
    w4 = rng.random((V, N, 4)).astype(np.float32)
    glob = ids + (np.arange(V) * h * w)[:, None]
    rows = quad[np.maximum(glob, 0)].reshape(V, N, 4, C)
    want = (rows * w4[..., None]).sum(axis=2, dtype=np.float32)
    want[ids < 0] = 0.0
    got = gather.feature_gather(torch.from_numpy(pm.reshape(V, h * w, C)),
                                torch.from_numpy(ids), torch.from_numpy(w4),
                                (0, 1, w, w + 1))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    assert not got.numpy()[:, ::5].any()


@pytest.mark.parametrize("form", ["weighted", "rows"])
def test_plain_k4_equals_the_row_gathers(form):
    """probe_block_gather.py's block_gather (T3: w * src[ids]),
    probe_block_gather2.py's make_block_gather (T4) and
    probe_dma_gather*.py's gathers (T5, T6: src[ids]) in numpy."""
    rng = np.random.default_rng(2)
    src, ids, w = _k4_inputs(rng, taps=1)
    ids = np.abs(ids)  # the probes gather every id
    if form == "rows":
        w = np.ones_like(w)
    want = np.take_along_axis(src, ids[..., None].astype(np.int64), axis=1)
    want = want * w
    got = gather.feature_gather(torch.from_numpy(src), torch.from_numpy(ids),
                                torch.from_numpy(w), (0,))
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_k4_is_the_sampling_forward_and_keeps_the_backward():
    """sample_feature_map's forward is K4's plain twin on _sample_taps'
    ids and bilinear weights; its backward is unchanged: autograd through a
    differentiable plain composition (four indexing gathers, the lerp) of
    the same forward gives the same d_feat and d_uv."""
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((V, HF, WF, C)).astype(np.float32)
    uv = rng.uniform(1, 38, (V, N, 2)).astype(np.float32)
    g = rng.standard_normal((V, N, C)).astype(np.float32)
    ft = torch.from_numpy(feat).requires_grad_(True)
    ut = torch.from_numpy(uv).requires_grad_(True)
    out = sample_feature_map(ft, ut, IMAGE)
    out.backward(torch.from_numpy(g))

    f2 = torch.from_numpy(feat).requires_grad_(True)
    u2 = torch.from_numpy(uv).requires_grad_(True)
    _, _, base, wx, wy, dx, dy = _sample_taps(f2, u2, IMAGE)
    direct = gather.feature_gather_plain(
        f2.detach().reshape(V, -1, C), base, _bilinear_w4(wx, wy).detach(),
        (0, dx, dy, dy + dx))
    np.testing.assert_array_equal(out.detach().numpy(), direct.numpy())
    flat = f2.reshape(V, -1, C)
    views = torch.arange(V)[:, None]
    p00, p01, p10, p11 = (flat[views, base + o] for o in (0, dx, dy, dy + dx))
    wx_, wy_ = wx[..., None], wy[..., None]
    ref = ((p00 * (1 - wx_) + p01 * wx_) * (1 - wy_)
           + (p10 * (1 - wx_) + p11 * wx_) * wy_)
    ref.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=1e-6, rtol=0)
    # d_feat: four-tap sums in another order; d_uv: an 8-channel dot
    np.testing.assert_allclose(ft.grad.numpy(), f2.grad.numpy(), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ut.grad.numpy(), u2.grad.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("bad", ["past_the_end", "few_offsets"])
def test_plain_k4_refuses_taps_outside_the_map(bad):
    rng = np.random.default_rng(4)
    src, ids, w = _k4_inputs(rng)
    hw = src.shape[1]
    if bad == "past_the_end":
        ids[2, 7] = hw - 48  # its last tap, +48 + 1, is hw + 1
        with pytest.raises(IndexError, match="must lie in"):
            gather.feature_gather(torch.from_numpy(src),
                                  torch.from_numpy(ids), torch.from_numpy(w),
                                  (0, 1, 48, 49))
    else:
        with pytest.raises(ValueError, match="1 or 4 taps"):
            gather.feature_gather(torch.from_numpy(src),
                                  torch.from_numpy(ids), torch.from_numpy(w),
                                  (0, 1))


def test_k4_wrapper_refuses_other_devices():
    x = torch.zeros((1, 8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gather.feature_gather(x, torch.zeros((1, 2), dtype=torch.int32,
                                             device="meta"),
                              torch.zeros((1, 2, 1), device="meta"), (0,))


@pytest.mark.parametrize("taps", [1, 4])
def test_k3_plain_twin_is_the_stream_scatter_probe(taps):
    """tools/probe_stream_scatter.py (T7): window[id + t] += (0.25 + 0.1 t)
    * row for t < taps, in numpy, against K3's plain twin with dx=1, dy=2
    (taps +0, +1, +2, +3) and the weights (0.25, 0.35, 0.45, 0.55), or
    (0.25, 0, 0, 0) for one tap."""
    rng = np.random.default_rng(5)
    n, c, window = 2048, 16, 200
    ids = rng.integers(0, window - 4, n).astype(np.int32)
    rows = rng.standard_normal((n, c)).astype(np.float32)
    want = np.zeros((window, c), np.float64)
    for t in range(taps):
        np.add.at(want, ids + t, (0.25 + 0.1 * t) * rows.astype(np.float64))
    wt = np.float32([0.25 + 0.1 * t if t < taps else 0.0 for t in range(4)])
    got = scatter.dfeat_scatter(torch.from_numpy(ids)[None],
                                torch.from_numpy(rows)[None],
                                torch.from_numpy(np.tile(wt, (1, n, 1))),
                                window, 1, 2)
    # float32 sums of ~10 weighted rows per texel and tap
    np.testing.assert_allclose(got[0].numpy(), want, atol=1e-5, rtol=1e-5)
