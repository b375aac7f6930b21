"""The per-vertex radii cull (``cull_radii``) and its measuring tool
(``tools/measure_vertex_radii``) of the port against the JAX package on the
CPU: the radii's validation errors, the radii cull in render_frame,
render_sigma and the culled train step, radii equal to cull_distance
against the shell, and the tool's radii, certificate and report
(tests/_torch_batch_setup.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_batch_setup as S
from transhuman_tpu.render.pipeline import _validate_radii, pad_rays
from transhuman_tpu.testing import synthetic_rays as jax_rays
from transhuman_tpu.tools import measure_vertex_radii as jtool
from transhuman_tpu_torch import kernels, weights
from transhuman_tpu_torch.kernels.cull import radii_cull, shell_cull
from transhuman_tpu_torch.render.pipeline import (
    FrameInputs,
    RayBundle,
    to_smpl,
    validate_radii,
)
from transhuman_tpu_torch.testing import synthetic_rays
from transhuman_tpu_torch.tools import measure_vertex_radii as tool

RGB_ATOL, ACC_ATOL, DEPTH_ATOL = 2e-3, 2e-3, 1e-2  # tests/test_torch_serve
SIGMA_ATOL = 1e-4  # tests/test_torch_mesh.py
TIE = 1e-6  # |min excess| (m^2) within which the two forms may disagree
RADII_ATOL = 1e-5  # m, the tool's radii against the JAX tool's


@pytest.fixture(scope="module")
def scene():
    return S.Scene()


@pytest.fixture(scope="module")
def radii():
    return np.random.default_rng(11).uniform(0.02, 0.1, S.NV).astype(
        np.float32)


def _port_frame(frame):
    return FrameInputs(**{k: torch.from_numpy(np.asarray(getattr(frame, k)))
                          for k in ("images", "vizmaps", "K", "R", "T",
                                    "verts_world", "tar_verts_smpl",
                                    "blend_rot", "Rh", "Th")})


def _excess64(pts_smpl, verts, radii):
    """min_v (|p - v|^2 - r_v^2) in float64."""
    d2 = torch.cdist(pts_smpl.double(), verts.double()) ** 2
    return (d2 - torch.from_numpy(radii).double() ** 2).min(dim=1).values


@pytest.mark.parametrize("bad,msg", [
    (np.full(5, 0.05), "vertex_radii has 5 entries for 128 vertices"),
    (np.zeros(S.NV), "vertex_radii must be positive and finite"),
    (np.full(S.NV, np.nan), "vertex_radii must be positive and finite"),
])
def test_radii_are_validated_as_jax_validates_them(scene, bad, msg):
    with pytest.raises(ValueError) as want:
        _validate_radii(bad, S.NV)
    with pytest.raises(ValueError) as got:
        validate_radii(bad, S.NV)
    assert str(got.value) == str(want.value) == msg
    with pytest.raises(ValueError, match=msg):
        scene.port_pipe(vertex_radii=bad)
    with pytest.raises(ValueError, match=msg):
        scene.port_pipe().clone(vertex_radii=bad)
    with pytest.raises(AttributeError, match="unknown attribute 'radius'"):
        scene.port_pipe().clone(radius=1)


def test_radii_cull_in_render_frame_matches_jax(scene, radii):
    """render_frame with the radii against the JAX dense render with them,
    at the serve bounds, rays with a point within TIE of the threshold
    left out; the radii change the render."""
    jr = jax_rays(128, seed=3)
    jpipe = scene.jax_pipe(batch_axis=False, chunk_rays=64,
                           vertex_radii=radii)
    want = jpipe.render_frame_dense(scene.params, scene.frame,
                                    pad_rays(jr, 64))
    tframe = _port_frame(scene.frame)
    rays = synthetic_rays(128, seed=3)
    pipe = scene.port_pipe(chunk_rays=64, vertex_radii=radii)
    kernels.reset_launch_counts()
    got = pipe.render_frame(tframe, rays)
    assert kernels.launch_counts()["min_excess2"] == 0  # CPU: plain twin
    pts = rays.ray_o[:, None] + rays.ray_d[:, None] * torch.linspace(
        1.2, 3.8, S.NS)[None, :, None]
    ex = _excess64(to_smpl(tframe, pts.reshape(-1, 3)),
                   tframe.tar_verts_smpl, radii).reshape(128, S.NS)
    ok = (ex.abs() > TIE).all(1).numpy()
    assert ok.mean() > 0.95
    for key, atol in (("rgb_map", RGB_ATOL), ("acc_map", ACC_ATOL),
                      ("depth_map", DEPTH_ATOL)):
        np.testing.assert_allclose(got[key].numpy()[ok],
                                   np.asarray(want[key])[ok], atol=atol)
    shell = scene.port_pipe(chunk_rays=64).render_frame(tframe, rays)
    assert np.abs(shell["acc_map"] - got["acc_map"]).numpy().max() > 0.05
    kept = pipe.last_frame_stats["survivors"]
    assert kept == int((ex < 0).sum())


def test_radii_cull_in_render_sigma_matches_jax(scene, radii):
    """render_sigma with the radii against the JAX render_sigma_dense with
    them: culled points exactly 0 on both sides off the near-ties."""
    tframe = _port_frame(scene.frame)
    rng = np.random.default_rng(5)
    verts = tframe.tar_verts_smpl.numpy()
    pts = (verts[rng.integers(0, S.NV, 2000)]
           + rng.normal(0, 0.06, (2000, 3))).astype(np.float32)
    got = scene.port_pipe(vertex_radii=radii).render_sigma(
        tframe, torch.from_numpy(pts)).numpy()
    jpipe = scene.jax_pipe(batch_axis=False, chunk_rays=64,
                           vertex_radii=radii)
    cp = jpipe.chunk_rays * jpipe.n_samples
    pad = (-len(pts)) % cp
    want, _ = jpipe.render_sigma_dense(
        scene.params, scene.frame, np.pad(pts, ((0, pad), (0, 0))),
        np.arange(len(pts) + pad) < len(pts))
    want = np.asarray(want)[:len(pts)]
    ex = _excess64(torch.from_numpy(pts), tframe.tar_verts_smpl,
                   radii).numpy()
    ok = np.abs(ex) > TIE
    assert ok.mean() > 0.99 and 0.2 < (ex < 0).mean() < 0.8
    np.testing.assert_array_equal((got == 0)[ok], (want == 0)[ok])
    np.testing.assert_array_equal((got == 0)[ok], (ex >= 0)[ok])
    assert np.abs(got - want)[ok].max() <= SIGMA_ATOL


def test_radii_cull_in_the_train_step_matches_jax(scene, radii):
    """The culled step at B = 2 with the radii against the JAX step's mask
    oracle with them, at the float32 train bounds."""
    jb, ts = scene.samples(2)
    ref = S.jax_step(scene, scene.jax_pipe(train_cull=True,
                                           train_cull_ratio=1.0,
                                           vertex_radii=radii), jb)
    port = S.port_step(scene, scene.port_pipe(train_cull=True,
                                              vertex_radii=radii), ts)
    S.check_f32(port, ref, S.leaves(scene.params["params"]))
    shell = S.port_step(scene, scene.port_pipe(train_cull=True), ts)
    assert port[2]["cull_survivors"] < shell[2]["cull_survivors"]


def test_radii_at_the_cull_distance_keep_the_shell(scene):
    """Every radius equal to cull_distance: the radii cull (d^2 - c^2 < 0)
    keeps what the shell (sqrt(min d^2) < c) keeps, off the points within
    1e-5 m of the threshold."""
    verts = _port_frame(scene.frame).tar_verts_smpl
    rng = np.random.default_rng(7)
    pts = (verts[rng.integers(0, S.NV, 20000)]
           + torch.from_numpy(rng.normal(0, 0.07, (20000, 3))).float())
    c = 0.1
    r = torch.full((S.NV,), c)
    got, want = radii_cull(pts, verts, r), shell_cull(pts, verts, c)
    d = torch.cdist(pts.double(), verts.double()).min(dim=1).values
    far = (d - c).abs() > 1e-5
    assert far.float().mean() > 0.99 and 0.2 < want.float().mean() < 0.8
    assert torch.equal(got[far], want[far])


# -------------------------------------------------------------------- tool
SETUP = dict(n_views=3, image_hw=(32, 32), n_verts=S.NV, n_clusters=S.NC,
             n_samples=8, chunk_rays=64, embed_dim=S.EMBED,
             vit_depth=S.DEPTH, vit_heads=S.HEADS, knn_k=S.K)
MEASURE = dict(per_vertex=6, seed=0, max_rounds=4)


@pytest.fixture(scope="module")
def measured():
    """Both tools on 2 posed synthetic bodies with the same weights."""
    jpipe, params, jitems = jtool.synthetic_items(2, 64, seed=0, **SETUP)
    pipe, items = tool.synthetic_items(2, 64, seed=0, device="cpu",
                                       **SETUP)
    np.testing.assert_array_equal(pipe.pool.numpy(), np.asarray(jpipe.pool))
    weights.load_reference_state_dict(pipe.model, weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), S.DEPTH))
    # the port's TransHE table, the one its pipeline computes
    jpipe.pe_can = jnp.asarray(pipe.pe_can.numpy())
    for (jf, jr), (f, r) in zip(jitems, items):
        np.testing.assert_array_equal(f.tar_verts_smpl.numpy(),
                                      np.asarray(jf.tar_verts_smpl))
        np.testing.assert_array_equal(r.ray_d.numpy(), np.asarray(jr.ray_d))
    want = jtool.measure(jpipe, params, jitems, **MEASURE)
    kernels.reset_launch_counts()
    got = tool.measure(pipe, items, **MEASURE)
    assert kernels.launch_counts()["min_excess2"] == 0  # CPU
    return got, want, (pipe, items), (jpipe, params, jitems)


def test_measured_radii_match_the_jax_tool(measured):
    """The radii within RADII_ATOL m of the JAX tool's, the same
    certificate and report.  No vertex is left out of the comparison for
    a probe whose alpha lies near alpha_eps: that count is 0 here."""
    (radii, report), (jradii, jreport), _, _ = measured
    assert report.keys() == jreport.keys()
    assert report == jreport
    np.testing.assert_allclose(radii, jradii, rtol=0, atol=RADII_ATOL)
    assert 0.01 <= radii.min() and radii.max() <= 0.1
    assert radii.min() < radii.max()  # per-vertex reach, not the shell


def test_measured_radii_image_deltas_match_the_jax_tool(measured):
    (radii, _), (jradii, _), (pipe, items), (jpipe, params, jitems) = \
        measured
    got = tool.report_deltas(pipe, radii, items)
    jitems = [(f, pad_rays(r, jpipe.chunk_rays)) for f, r in jitems]
    want = jtool.report_deltas(jpipe, params, jradii, jitems)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert abs(g["max_abs_delta"] - w["max_abs_delta"]) <= RGB_ATOL


def test_measure_entry_point_writes_the_npz(tmp_path, capsys):
    """--cfg_file: a checkpoint's radii over its test frames, on the CPU:
    the npz's radii and meta, and the report on stdout."""
    from transhuman_tpu_torch.cli import train as tcli

    small = ["dataset", "synthetic", "H", "64", "W", "64", "num_class",
             "20", "vit_depth", "1", "N_samples", "8", "compute_dtype",
             "float32", "trained_model_dir", str(tmp_path / "tm"),
             "record_dir", str(tmp_path / "rec")]
    ckpt = str(tmp_path / "w.pth")
    tcli.main(["--device", "cpu", "--steps", "1", "--out", ckpt,
               "patch.size", "6", "patch.N_patches", "2", *small])
    capsys.readouterr()
    out = str(tmp_path / "radii.npz")
    radii, report = tool.main([
        "--cfg_file", "configs/train_or_eval.yaml", "--device", "cpu",
        "--weights", ckpt, "--out", out, "--frames", "1", "--per_vertex",
        "1", *small])
    z = np.load(out)
    assert z["radii"].dtype == np.float32 and z["radii"].shape == (6890,)
    np.testing.assert_array_equal(z["radii"], radii)
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed["out"] == out and "image_deltas_vs_shell" in printed
    assert json.loads(str(z["meta"])) == {
        k: v for k, v in report.items()
        if k not in ("image_deltas_vs_shell", "out")}
