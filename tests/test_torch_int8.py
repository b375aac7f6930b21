"""The int8 pixel map (``RenderPipeline(quantize_pixel_feat=True)``) of the
port against the JAX package on the CPU: the per-channel quantiser, the
int8 fetch (K4's int8 form's plain twin), the render, the sigma pass, the
ray shares and the batched prologue, and a train step
(tests/_torch_batch_setup.py's scene).

JAX references run as the JAX package's jits run them; its bf16 programs
(the int8 fetch and everything downstream of it) compile with XLA's excess
precision off (``as_written``), so that every bf16 operation rounds as it
is written, as the port's twin and kernel round it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_batch_setup as S
from transhuman_tpu.ops.sampling import quantize_feature_map as jquantize
from transhuman_tpu.ops.sampling import sample_feature_map as jsample
from transhuman_tpu.render.pipeline import pad_rays
from transhuman_tpu.testing import synthetic_rays as jax_rays
from transhuman_tpu_torch import kernels
from transhuman_tpu_torch.kernels import gather
from transhuman_tpu_torch.ops.sampling import (
    quantize_feature_map,
    sample_feature_map,
)
from transhuman_tpu_torch.parallel.infer import make_sharded_render
from transhuman_tpu_torch.render.pipeline import FrameInputs, to_smpl
from transhuman_tpu_torch.testing import synthetic_rays

RGB_ATOL, ACC_ATOL, DEPTH_ATOL = 2e-3, 2e-3, 1e-2  # tests/test_torch_serve
SIGMA_ATOL = 1e-4  # tests/test_torch_mesh.py
# the JAX package's int8 render against its float32 render
# (tests/test_pipeline.py::test_quantized_pixel_features_close_to_fp)
INT8_RGB_MAX, INT8_RGB_MEAN = 0.05, 0.01
TIE = 1e-6  # m: |distance - cull_distance| within which the culls may differ
# |a decode ReLU's input| within which the two packages' float32 rounding
# may put a unit on either side of 0 (the step test's near-ties)
RELU_TIE = 1e-5
IMAGE = (48, 56)


@pytest.fixture(scope="module")
def scene():
    return S.Scene()


def _map(seed, shape=(3, 12, 14, 40)):
    """A seeded float32 map whose channels span three decades of range, one
    channel all zero (its scale is max(0, 1e-12) / 127)."""
    rng = np.random.default_rng(seed)
    f = rng.standard_normal(shape) * rng.uniform(0.01, 10.0, shape[-1])
    f[..., 5] = 0.0
    return f.astype(np.float32)


def _uv(seed, n=600):
    """uv (3, n, 2) over IMAGE: inside, on the borders, past them, far
    outside."""
    rng = np.random.default_rng(seed)
    h, w = IMAGE
    uv = np.stack([rng.uniform(-4, w + 4, (3, n)),
                   rng.uniform(-4, h + 4, (3, n))], axis=-1)
    uv[:, :8, 0] = 0.0
    uv[:, 8:16, 0] = w
    uv[:, 16:24, 1] = h
    uv[:, 24:32] = 1e12
    return uv.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizer_equals_jax_bit_for_bit(dtype):
    """q and scale equal the JAX package's jitted quantiser's bit for bit,
    from a float32 map and from a bf16 one; q carries no gradient and the
    scale carries feat's through the absmax, as JAX's does."""
    f = _map(0)
    jf = jnp.asarray(f).astype(jnp.bfloat16 if dtype == "bfloat16"
                                else jnp.float32)
    jq, js = jax.jit(jquantize)(jf)
    tf = torch.from_numpy(np.array(jf.astype(jnp.float32))).to(
        S.COMPUTE[dtype]).requires_grad_(True)
    q, scale = quantize_feature_map(tf)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.detach().numpy(), np.asarray(js))
    assert not q.requires_grad and scale.requires_grad
    w = np.random.default_rng(1).standard_normal(f.shape[-1]).astype(
        np.float32)
    jg = jax.jit(jax.grad(lambda x: jnp.sum(jquantize(x)[1] * w)))(jf)
    (scale * torch.from_numpy(w)).sum().backward()
    # XLA multiplies by float32(1 / 127) in the forward but divides by 127
    # in the backward: the gradients agree to one unit in the last place
    np.testing.assert_array_max_ulp(tf.grad.float().numpy(),
                                    np.asarray(jg.astype(jnp.float32)), 1)
    assert not tf.grad[..., 5].any()  # the all-zero channel's clamp
    assert int((tf.grad != 0).sum()) >= f.shape[-1] - 1


def test_int8_fetch_equals_jax_bit_for_bit():
    """The port's int8 fetch (the plain twin of K4's int8 form, through
    sample_feature_map and feature_sample) against the JAX package's
    sample_feature_map of the int8 map times bf16(scale), compiled as
    written: bf16 rows, equal bit for bit, scaled and unscaled; no kernel
    launched on the CPU."""
    q, scale = jax.jit(jquantize)(jnp.asarray(_map(2)))
    uv = _uv(3)

    def fetch(q, uv, scale):
        return jsample(q, uv, IMAGE) * scale.astype(jnp.bfloat16)

    with S.as_written():
        want = jax.jit(fetch)(q, jnp.asarray(uv), scale)
        want_raw = jax.jit(lambda q, uv: jsample(q, uv, IMAGE))(
            q, jnp.asarray(uv))
    tq = torch.from_numpy(np.array(q))
    ts = torch.from_numpy(np.array(scale))
    tuv = torch.from_numpy(uv)
    kernels.reset_launch_counts()
    got = sample_feature_map(tq, tuv, IMAGE, ts)
    raw = gather.feature_sample(tq, tuv, IMAGE)
    assert kernels.launch_counts()["feature_sample_int8"] == 0
    assert got.dtype == raw.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(raw.float().numpy(),
                                  np.asarray(want_raw.astype(jnp.float32)))
    # with the scale's gradient asked for: the unscaled rows times the
    # scale, the same bits
    ts.requires_grad_(True)
    again = sample_feature_map(tq, tuv, IMAGE, ts)
    assert again.requires_grad and torch.equal(again.detach(), got)


def test_int8_sampling_keeps_bilinear_fractions():
    """The JAX package's regression (tests/test_sampling.py): halfway
    between the two texels of a step edge of an int8 map the fetch gives
    the midpoint, which snapping the fractions to the int8 type (to 0)
    cannot."""
    h = w = 8
    feat = torch.zeros((1, h, w, 1))
    feat[:, :, 4:, :] = 1.0
    q, scale = quantize_feature_map(feat)
    assert q.dtype == torch.int8
    uv = torch.tensor([[[3.5, 2.0]]])
    out = sample_feature_map(q, uv, (h, w), scale)
    np.testing.assert_allclose(out.float().numpy().ravel(), [0.5],
                               atol=1.0 / 127)


def test_the_int8_route_refuses_what_it_does_not_take():
    """A scale is for an int8 map only; a map on a device with no kernel
    and no plain twin is refused, not computed."""
    f = torch.zeros((1, 4, 4, 8))
    with pytest.raises(ValueError, match="int8 map"):
        gather.feature_sample(f, torch.zeros((1, 2, 2)), (4, 4),
                              torch.ones(8))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        gather.feature_sample(torch.zeros((1, 4, 4, 8), dtype=torch.int8,
                                          device="meta"),
                              torch.zeros((1, 2, 2), device="meta"), (4, 4),
                              torch.ones(8, device="meta"))


def _port_frame(frame):
    return FrameInputs(**{k: torch.from_numpy(np.asarray(getattr(frame, k)))
                          for k in ("images", "vizmaps", "K", "R", "T",
                                    "verts_world", "tar_verts_smpl",
                                    "blend_rot", "Rh", "Th")})


def _tie_rays(tframe, rays):
    """(R,) bool: a sample of the ray lies within TIE of the cull shell."""
    pts = rays.ray_o[:, None] + rays.ray_d[:, None] * torch.linspace(
        1.2, 3.8, S.NS)[None, :, None]
    d = torch.cdist(to_smpl(tframe, pts.reshape(-1, 3)).double(),
                    tframe.tar_verts_smpl.double()).min(dim=1).values
    return ((d - 0.1).abs() < TIE).reshape(-1, S.NS).any(dim=1).numpy()


def test_int8_render_matches_jax_int8_render(scene):
    """render_frame with the int8 map against the JAX package's int8 render
    at the serve bounds, off cull near-ties; against the port's own float32
    render within the JAX package's int8 bounds; the prologue holds the
    int8 map and its scale (clone toggles the mode, as JAX's test does);
    the ray shares and the batched prologue carry the scale."""
    n = 128
    jr = jax_rays(n, seed=3)
    with S.as_written():
        want = scene.jax_pipe(batch_axis=False, chunk_rays=64,
                              quantize_pixel_feat=True).render_frame_dense(
            scene.params, scene.frame, pad_rays(jr, 64))
    tframe = _port_frame(scene.frame)
    rays = synthetic_rays(n, seed=3)
    f32 = scene.port_pipe(chunk_rays=64)
    pipe = f32.clone(quantize_pixel_feat=True)
    pro = pipe.prologue(tframe)
    assert pro.pixel_map.dtype == torch.int8
    assert pro.pixel_scale is not None and pro.pixel_scale.shape == (384,)
    assert f32.prologue(tframe).pixel_scale is None
    got = pipe.render_frame(tframe, rays)
    ok = ~_tie_rays(tframe, rays)
    assert ok.mean() > 0.95
    assert float(got["acc_map"].max()) > 0.1  # the body is in view
    for key, atol in (("rgb_map", RGB_ATOL), ("acc_map", ACC_ATOL),
                      ("depth_map", DEPTH_ATOL)):
        np.testing.assert_allclose(got[key].numpy()[ok],
                                   np.asarray(want[key])[ok], atol=atol)
    d = (got["rgb_map"] - f32.render_frame(tframe, rays)["rgb_map"]).abs()
    assert 0 < float(d.max()) < INT8_RGB_MAX
    assert float(d.mean()) < INT8_RGB_MEAN
    # two shares of the rays, each replica making its own int8 prologue
    shared = make_sharded_render(pipe, ["cpu", "cpu"])(tframe, rays)
    for key in got:
        assert torch.equal(shared[key], got[key]), key
    # the batched prologue (encode_batch's maps) quantises alike
    batched = pipe._prologue(tframe, pipe.encode_batch([tframe])[0])
    assert torch.equal(batched.pixel_map, pro.pixel_map)
    assert torch.equal(batched.pixel_scale, pro.pixel_scale)


def _pixel_map(scene, images):
    """The JAX encoder's pixel map of the images (numpy)."""
    return np.asarray(scene.jax_pipe(batch_axis=False).model.apply(
        scene.params, jnp.asarray(images), method="encode_views")[1])


def _one_pixel_map(pipe, fixed):
    """The port's encode_views with its pixel map replaced by the array
    fixed in value and kept in gradient: fixed + (p - p.detach())."""
    encode, fixed = pipe.model.encode_views, torch.from_numpy(fixed)

    def one_map(images):
        holder, p = encode(images)
        return holder, fixed + (p - p.detach())

    pipe.model.encode_views = one_map
    return pipe


def test_int8_sigma_pass_matches_jax(scene):
    """render_sigma with the int8 map against the JAX package's
    render_sigma_dense with it, both packages' pixel maps the same array
    (the JAX encoder's; their own maps differ by ~1e-5 relative, which
    quantises to a whole quantum at a few texels and moves sigma ~5e-4
    there): culled points exactly 0 in both, the rest within the sigma
    bound off the cull's near-ties."""
    tframe = _port_frame(scene.frame)
    fixed = _pixel_map(scene, tframe.images.numpy())
    rng = np.random.default_rng(5)
    verts = tframe.tar_verts_smpl.numpy()
    pts = (verts[rng.integers(0, S.NV, 2000)]
           + rng.normal(0, 0.06, (2000, 3))).astype(np.float32)
    got = _one_pixel_map(scene.port_pipe(quantize_pixel_feat=True),
                         fixed).render_sigma(tframe,
                                             torch.from_numpy(pts)).numpy()
    jpipe = scene.jax_pipe(batch_axis=False, chunk_rays=64,
                           quantize_pixel_feat=True)
    jpipe.model = _OnePixelMap(jpipe.model, fixed)
    cp = jpipe.chunk_rays * jpipe.n_samples
    pad = (-len(pts)) % cp
    with S.as_written():
        want, _ = jax.jit(jpipe.render_sigma_dense)(
            scene.params, scene.frame, np.pad(pts, ((0, pad), (0, 0))),
            np.arange(len(pts) + pad) < len(pts))
    want = np.asarray(want)[:len(pts)]
    d = torch.cdist(to_smpl(tframe, torch.from_numpy(pts)).double(),
                    tframe.tar_verts_smpl.double()).min(dim=1).values.numpy()
    ok = np.abs(d - 0.1) > TIE
    assert ok.mean() > 0.99 and 0.2 < (d < 0.1).mean() < 0.8
    np.testing.assert_array_equal((got == 0)[ok], (want == 0)[ok])
    assert np.abs(got - want)[ok].max() <= SIGMA_ATOL


def _relu_tie_rays(pipe, sample):
    """Rays holding a point at which some decode ReLU's input lies within
    RELU_TIE of 0 (the port's unjittered forward): there the two packages'
    float32 roundings may take a unit's gradient on different sides."""
    seen, relu, decode = [], F.relu, pipe.model.decode

    def record(x, *a, **kw):
        seen.append(x.detach())
        return relu(x, *a, **kw)

    def recorded(*a, **kw):
        F.relu = record
        try:
            return decode(*a, **kw)
        finally:
            F.relu = relu

    pipe.model.decode = recorded
    try:
        with torch.no_grad():
            pipe.render_train(sample.frame, sample.rays, None, False)
    finally:
        del pipe.model.decode
    n = seen[0].shape[-2]
    near = torch.zeros(n, dtype=torch.bool)
    for x in seen:
        near |= (x.abs() < RELU_TIE).reshape(-1, n, x.shape[-1]).any(
            0).any(-1)
    return torch.unique(torch.nonzero(near)[:, 0] // S.NS)


class _OnePixelMap:
    """The JAX model with encode_views' pixel map replaced by a fixed array
    in value and kept in gradient: fixed + (p - stop_gradient(p))."""

    def __init__(self, model, fixed):
        self.model, self.fixed = model, jnp.asarray(fixed)

    def apply(self, params, *a, method=None, **kw):
        out = self.model.apply(params, *a, method=method, **kw)
        if method == "encode_views":
            holder, p = out
            return holder, self.fixed + (p - jax.lax.stop_gradient(p))
        return out

    def __getattr__(self, name):
        return getattr(self.model, name)


def test_int8_train_step_matches_jax(scene):
    """JAX trains with the int8 map (it does not raise): the rounded map
    gives the encoder no gradient, the scale's absmax gives it one.  The
    port's step against JAX's (as written), both packages' pixel maps the
    same array in value (each keeps its own encoder's gradient): the
    packages' float32 encoders differ by ~1e-5 relative, and rounding to
    int8 turns that into whole quanta at a few texels, which moves JAX's
    own step past the train bounds (its images scaled by 1 + 1e-6 do).
    Rays with a decode ReLU near-tie are masked in both samples.  The loss
    and every leaf but the encoder's at the float32 train bounds; the
    encoder's leaves, whose gradient comes through the scale, within 2^-6
    of their norm: JAX sums the scale's gradient in bf16, the port in
    float32 rounded once to bf16."""
    jb, ts = scene.samples(1)
    fixed = _pixel_map(scene, ts[0].frame.images.numpy())
    pipe = _one_pixel_map(scene.port_pipe(quantize_pixel_feat=True), fixed)
    ties = _relu_tie_rays(pipe, ts[0])
    assert len(ties) <= ts[0].rays.mask.numel() // 4
    ts[0].rays.mask[ties] = False
    mask = np.array(jb.rays.mask)
    mask[0, ties.numpy()] = False
    jb = jb.replace(rays=jb.rays.replace(mask=mask))
    jpipe = scene.jax_pipe(quantize_pixel_feat=True)
    jpipe.model = _OnePixelMap(jpipe.model, fixed)
    with S.as_written():
        ref = S.jax_step(scene, jpipe, jb)
    port = S.port_step(scene, pipe, ts)
    (tl, tg, _, _), (jl, jg, _, _) = port, ref
    assert np.isfinite(tl) and tl > 0
    np.testing.assert_allclose(tl, jl, rtol=S.LOSS_RTOL)
    assert set(tg) == set(jg)
    enc = [k for k in jg if k.startswith("['encoder']")]
    assert enc and all(np.linalg.norm(jg[k]) > 0 for k in enc)
    for k, want in jg.items():
        rtol = 2.0**-6 if k in enc else S.GRAD_RTOL
        assert (np.linalg.norm(tg[k] - want)
                <= rtol * np.linalg.norm(want) + S.GRAD_ATOL), k
