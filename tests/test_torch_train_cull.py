"""The train cull (``train.cull``) and rematerialisation (``remat``) of the
port against the JAX package on the CPU, in float32 on a batch of 2: the
culled step against both JAX branches (its mask oracle,
``train_cull_ratio >= 1``, and its compacted decode at a capacity above the
survivor fraction), the survivor fraction, a culled point's raw and
gradient exactly 0, and remat's gradients equal to those without it
(tests/_torch_batch_setup.py)."""

import jax
import numpy as np
import pytest
import torch

import _torch_batch_setup as S
from transhuman_tpu_torch.render import pipeline as tpipeline
from transhuman_tpu_torch.render.pipeline import to_smpl

REMAT_ATOL = 1e-6  # remat recomputes the same decode: its gradients agree


@pytest.fixture(scope="module")
def scene():
    return S.Scene()


@pytest.fixture(scope="module")
def fractions(scene):
    """The JAX package's train_cull_fraction of samples 0 and 1."""
    jb, _ = scene.samples(2)
    pipe = scene.jax_pipe(train_cull=True)
    fn = jax.jit(pipe.train_cull_fraction)
    return [float(fn(jax.tree.map(lambda x: x[i], jb.frame),
                     jax.tree.map(lambda x: x[i], jb.rays)))
            for i in range(2)]


def test_train_cull_fraction_matches_jax(scene, fractions):
    """Within one point of the sample's (a point within rounding of the
    cull distance may fall either way)."""
    _, ts = scene.samples(2)
    pipe = scene.port_pipe(train_cull=True)
    n = ts[0].rays.mask.numel() * S.NS
    for t, want in zip(ts, fractions):
        got = float(pipe.train_cull_fraction(t.frame, t.rays))
        assert abs(got - want) <= 1 / n, (got, want)
    assert 0.05 < min(fractions) and max(fractions) < 0.95  # a real cull


@pytest.mark.parametrize("ratio", ["oracle", "compacted"])
def test_train_cull_step_matches_jax(scene, fractions, ratio):
    """One step at B = 2 with train.cull against the JAX step with the mask
    oracle (every point decoded, culled ones masked) or the compacted
    decode at a capacity above the survivor fraction: loss, gradients and
    update at the float32 train bounds; the stats carry JAX's keys
    (overflow 0 in both) and the decoded fraction is JAX's."""
    cap = 1.0 if ratio == "oracle" else max(fractions) + 0.05
    jb, ts = scene.samples(2)
    ref = S.jax_step(scene, scene.jax_pipe(train_cull=True,
                                           train_cull_ratio=cap), jb)
    port = S.port_step(scene, scene.port_pipe(train_cull=True), ts)
    S.check_f32(port, ref, S.leaves(scene.params["params"]))
    stats = dict(port[2])
    stats.pop("lr")
    np.testing.assert_allclose(stats.pop("cull_survivors"),
                               np.mean(fractions), atol=1 / (2 * 32 * S.NS))
    if ratio == "compacted":
        assert ref[2]["overflow"] == 0.0
    else:
        assert "overflow" not in ref[2]
    assert stats.pop("overflow") == 0.0
    assert stats.keys() == ref[2].keys() - {"overflow"}
    for k in stats:
        np.testing.assert_allclose(stats[k], ref[2][k], rtol=S.LOSS_RTOL)


def _render_with_leaf_points(pipe, sample, monkeypatch):
    """render_train of one sample with the per-point view-direction code
    that the decode reads a leaf that requires grad (the sample positions
    get none: K2's Function passes gradients to the tokens only): (the
    points, that leaf, the raw the composite received)."""
    seen = {}
    train_points = pipe.train_points

    def leaf_points(*args, **kw):
        pts, z, mask, vde = train_points(*args, **kw)
        seen["pts"], seen["vde"] = pts, vde.requires_grad_(True)
        return pts, z, mask, seen["vde"]

    composite = tpipeline.composite

    def spy(raw, *args, **kw):
        seen["raw"] = raw
        return composite(raw, *args, **kw)

    pipe.train_points = leaf_points
    monkeypatch.setattr(tpipeline, "composite", spy)
    out = pipe.render_train(sample.frame, sample.rays)
    out["rgb_map"].sum().backward()
    return seen["pts"], seen["vde"], seen["raw"].detach().reshape(-1, 4)


def test_culled_points_decode_to_zero_with_zero_gradient(scene, monkeypatch):
    """Under train.cull a culled point's raw is exactly 0 and what its
    decode would read gets exactly 0 gradient; without the cull the same
    points get some."""
    _, ts = scene.samples(1)
    s = ts[0]
    pipe = scene.port_pipe(train_cull=True)
    pts, vde, raw = _render_with_leaf_points(pipe, s, monkeypatch)
    keep = pipe._cull(to_smpl(s.frame, pts), s.frame.tar_verts_smpl)
    keep &= s.rays.mask.repeat_interleave(S.NS)
    assert 0 < int(keep.sum()) < keep.numel()
    assert torch.equal(raw[~keep], torch.zeros_like(raw[~keep]))
    assert torch.equal(vde.grad[~keep], torch.zeros_like(vde.grad[~keep]))
    assert (vde.grad[keep].abs().sum(1) > 0).float().mean() > 0.9
    assert pipe.last_frame_stats == {"points": keep.numel(),
                                     "survivors": int(keep.sum())}
    _, dense, _ = _render_with_leaf_points(scene.port_pipe(), s, monkeypatch)
    assert (dense.grad[~keep].abs().sum(1) > 0).any()


def _grads(pipe, samples):
    S.port_step(None, pipe, samples)
    return {n: p.grad.clone() for n, p in pipe.model.named_parameters()
            if p.grad is not None}


@pytest.mark.parametrize("cull", [False, True])
def test_remat_gradients_equal_those_without_it(scene, cull):
    """remat recomputes the decode in the backward (the model's query runs
    twice a sample) and gives the same gradients, with and without the
    train cull."""
    _, ts = scene.samples(2)
    plain = _grads(scene.port_pipe(train_cull=cull), ts)
    pipe = scene.port_pipe(train_cull=cull, remat=True)
    calls = []
    query = pipe.model.query

    def counted(*args, **kw):
        calls.append(1)
        return query(*args, **kw)

    pipe.model.query = counted
    remat = _grads(pipe, ts)
    assert len(calls) == 4  # 2 samples, forward and recompute
    assert remat.keys() == plain.keys()
    for n in plain:
        torch.testing.assert_close(remat[n], plain[n], rtol=0,
                                   atol=REMAT_ATOL, msg=n)
