"""Visibility from depth maps (``depth_map`` with ``depth_vizmap``) in the
port against the JAX package on the CPU: ``depth_visibility`` and
``sample_half_pixel`` on depth maps z-buffered from a fake ZJU human's
vertices and stored as torch tensor files in the three shapes the loader
takes; the ZJU items that carry them; the prologue's swap; and an eval
forward (float32 and bfloat16) and a train step through both packages with
bridged weights, at tests/test_torch_zju.py's and tests/test_torch_bf16.py's
bounds."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_bf16 import _as_written, _compare
from tests.test_torch_zju import (DEPTH, EMBED, HEADS, HUMAN, INFO, NC, NF,
                                  NV, K, _leaves, _opts, _same_frame,
                                  _same_rays, bridged, zju_root)
from transhuman_tpu.cli.run import evaluate_frames as jax_evaluate_frames
from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.zju import ZJUDataset as JZJU
from transhuman_tpu.evals.evaluator import Evaluator as JEvaluator
from transhuman_tpu.geometry.smpl import SMPLModel as JSMPL
from transhuman_tpu.ops import sampling as jsampling
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch import kernels, weights
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.zju import ZJUDataset
from transhuman_tpu_torch.evals.evaluator import Evaluator
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.ops import sampling
from transhuman_tpu_torch.render.pipeline import FrameInputs
from transhuman_tpu_torch.train import step as tstep

assert bridged and zju_root  # module fixtures of tests/test_torch_zju.py
DET = 0.07  # m: the reference's visibility margin (pipeline.py's det)
NEAR_TIE = 1e-5  # m: |z - surf - DET| within it may flip either way
RATIO = 0.5  # tests/test_torch_zju.py's ratio: depth maps at 32 x 32


def zbuffer(verts, K, R, T, hw, splat=1):
    """(H, W) float32 depth of the nearest vertex splatted over a
    (2 splat + 1)^2 square at its projection; 0 where no vertex lands."""
    cam = verts @ R.T + T.reshape(1, 3)
    pix = cam @ K.T
    uv = np.round(pix[:, :2] / pix[:, 2:]).astype(int)
    depth = np.zeros(hw, np.float32)
    order = np.argsort(-cam[:, 2])  # far first: the nearest is written last
    for dy in range(-splat, splat + 1):
        for dx in range(-splat, splat + 1):
            x, y = uv[order, 0] + dx, uv[order, 1] + dy
            ok = (x >= 0) & (x < hw[1]) & (y >= 0) & (y < hw[0])
            depth[y[ok], x[ok]] = cam[order[ok], 2]
    return depth


def _render_camera(cams, c):
    """(K at the render size, R, T in m) of annots camera c, float32, as
    the loader makes them."""
    K = np.array(cams["K"][c], np.float32)
    K[:2] *= RATIO
    return (K, np.array(cams["R"][c], np.float32),
            (np.array(cams["T"][c], np.float32) / 1000.0).reshape(3))


def _stored(d, c):
    """Camera c's map in one of the three stored shapes."""
    return [d, d[None], d[..., None]][c % 3]


@pytest.fixture(scope="module")
def depth_root(zju_root):
    """Depth maps of every camera and frame of the fake human, z-buffered
    from its vertices at the render size, as the reference's .pt files."""
    droot = os.path.join(zju_root, "depth")
    annots = np.load(os.path.join(zju_root, HUMAN, "annots.npy"),
                     allow_pickle=True).item()
    hw = (int(64 * RATIO), int(64 * RATIO))
    for f in range(NF):
        verts = np.load(os.path.join(zju_root, HUMAN, "new_vertices",
                                     f"{f}.npy")).astype(np.float32)
        for c in range(NC):
            d = zbuffer(verts, *_render_camera(annots["cams"], c), hw)
            path = os.path.join(droot, HUMAN, f"Camera_B{c + 1}",
                                f"{f:06d}.pt")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            torch.save(torch.from_numpy(_stored(d, c)), path)
    return droot


def _depth_opts(zju_root, depth_root, extra=()):
    return _opts(zju_root, ["depth_map", "True", "depth_vizmap", "True",
                            "depth_root", depth_root, *extra])


def _pair(zju_root, depth_root, split, extra=()):
    opts = _depth_opts(zju_root, depth_root, extra)
    j = JZJU(JConfig().merge_opts(opts), split,
             smpl=JSMPL.synthetic(n_verts=NV), human_info=INFO)
    t = ZJUDataset(Config().merge_opts(opts), split,
                   smpl=SMPLModel.synthetic(n_verts=NV), human_info=INFO)
    return j, t


@pytest.mark.parametrize("shape", ["HW", "1HW", "HW1"])
def test_depth_visibility_equals_the_jax_function(zju_root, depth_root,
                                                  shape):
    """The cameras stored in one shape: both loaders read the same (H, W)
    map; the port's depth_visibility equals the JAX package's off the near
    ties, and its sampled surface depths are within 1e-6 relative.  Points
    outside the view sample the zero padding."""
    j, t = _pair(zju_root, depth_root, "test")
    cams = [c for c in range(NC) if c % 3 == ["HW", "1HW", "HW1"].index(
        shape)]
    annots = t.cams[HUMAN]
    verts = np.load(os.path.join(zju_root, HUMAN, "new_vertices", "0.npy"))
    verts = np.concatenate([verts, verts[:8] + [[0, 5.0, 0]]]).astype(
        np.float32)  # the last 8 project outside every view
    maps, Ks, Rs, Ts = [], [], [], []
    for c in cams:
        d = t._depthmap(HUMAN, c + 1, "000000")
        np.testing.assert_array_equal(d, j._depthmap(HUMAN, c + 1, "000000"))
        assert d.shape == (32, 32) and d.dtype == np.float32
        maps.append(d)
        for lst, x in zip((Ks, Rs, Ts), _render_camera(annots, c)):
            lst.append(x)
    maps, Ks, Rs, Ts = (np.stack(x) for x in (maps, Ks, Rs, Ts))
    targs = [torch.from_numpy(x) for x in (maps, verts, Ks, Rs, Ts)]
    got = sampling.depth_visibility(*targs).numpy()
    want = np.asarray(jsampling.depth_visibility(*map(jnp.asarray, (
        maps, verts, Ks, Rs, Ts))))
    uv, z = sampling.project_points(*targs[1:])
    surf = sampling.sample_half_pixel(targs[0][..., None], uv,
                                      maps.shape[1:])[..., 0].numpy()
    juv, jz = jsampling.project_points(*map(jnp.asarray, (verts, Ks, Rs,
                                                          Ts)))
    jsurf = np.asarray(jsampling.sample_half_pixel(
        jnp.asarray(maps)[..., None], juv, maps.shape[1:]))[..., 0]
    np.testing.assert_allclose(surf, jsurf, rtol=1e-6, atol=0)
    tie = np.abs(np.asarray(jz, np.float64) - jsurf - DET) <= NEAR_TIE
    np.testing.assert_array_equal(got[~tie], want[~tie])
    assert got.dtype == np.float32 and set(np.unique(got)) <= {0.0, 1.0}
    assert (got[:, -8:] == 0).all() and (jsurf[:, -8:] == 0).all()
    frac = float(got[:, :-8].mean())
    assert 0.2 < frac < 0.95, frac
    print(f"{shape}: visible fraction {frac:.3f}, {int(tie.sum())} "
          f"vertices in the near-tie band")


def test_zju_depth_items_equal_the_jax_dataset(zju_root, depth_root):
    """Train (jitter on and off), eval, perform and mesh items carry the
    same (V, 32, 32) depth maps in both packages, and everything else as
    without them; the input-view cache counts their bytes."""
    for jitter in ("False", "True"):
        j, t = _pair(zju_root, depth_root, "train", ["jitter", jitter])
        js, ts = j.get_train_sample(5), t.get_train_sample(5)
        _same_frame(ts.frame, js.frame, 2e-5)
        _same_rays(ts.rays, js.rays)
        assert ts.frame.depth_maps.shape == (2, 32, 32)
        np.testing.assert_array_equal(ts.frame.depth_maps.numpy(),
                                      np.asarray(js.frame.depth_maps))
    j, t = _pair(zju_root, depth_root, "test")
    for get in ("get_eval_item", "get_perform_item"):
        ji, ti = getattr(j, get)(1), getattr(t, get)(1)
        _same_frame(ti.frame, ji.frame, 1e-6)
        assert ti.frame.depth_maps.dtype == torch.float32
        np.testing.assert_array_equal(ti.frame.depth_maps.numpy(),
                                      np.asarray(ji.frame.depth_maps))
    (jf, _, _), (tf, _, _) = j.get_mesh_item(0), t.get_mesh_item(0)
    np.testing.assert_array_equal(tf.depth_maps.numpy(),
                                  np.asarray(jf.depth_maps))
    # the cache holds images, K, R, T, vizmap and the depth map per view
    plain = ZJUDataset(Config().merge_opts(_opts(zju_root)), "test",
                       smpl=SMPLModel.synthetic(n_verts=NV),
                       human_info=INFO)
    assert plain.get_eval_item(1).frame.depth_maps is None
    n_views = len(t._iv_cache._d)
    assert n_views == len(plain._iv_cache._d) > 0
    assert t._iv_cache._total - plain._iv_cache._total == n_views * 32 * 32 * 4
    # only depth_map with depth_vizmap loads them
    only = ZJUDataset(Config().merge_opts(_opts(zju_root, [
        "depth_map", "True", "depth_root", "/nonexistent"])), "test",
        smpl=SMPLModel.synthetic(n_verts=NV), human_info=INFO)
    assert only.get_eval_item(1).frame.depth_maps is None


def test_prologue_takes_visibility_from_the_depth_maps(zju_root, depth_root,
                                                       bridged):
    """A frame with depth maps paints as the same frame whose vizmaps are
    depth_visibility's; FrameInputs.to keeps the maps, and None stays
    None."""
    _, t = _pair(zju_root, depth_root, "test")
    frame = t.get_eval_item(0).frame
    pipe = bridged[2]()
    vis = sampling.depth_visibility(frame.depth_maps, frame.verts_world,
                                    frame.K, frame.R, frame.T)
    assert (vis != frame.vizmaps).any()  # the mode changes the input
    swapped = FrameInputs(**{**frame.__dict__, "vizmaps": vis,
                             "depth_maps": None})
    moved = frame.to("cpu")
    assert torch.equal(moved.depth_maps, frame.depth_maps)
    assert swapped.to("cpu").depth_maps is None
    torch.testing.assert_close(pipe.prologue(moved).tokens,
                               pipe.prologue(swapped).tokens, rtol=0, atol=0)
    with torch.no_grad():
        differs = pipe.prologue(FrameInputs(**{**frame.__dict__,
                                               "depth_maps": None})).tokens
    assert not torch.equal(differs, pipe.prologue(frame).tokens)


def _eval_runs(zju_root, depth_root, jpipe, params, tpipe, tmp_path,
               as_written=False):
    """{'jax': [(frame, rgb, psnr)], 'port': [...]} of evaluate_frames over
    the test split with depth visibility."""
    j, t = _pair(zju_root, depth_root, "test", ["test.target_view", "2,"])
    frames = {}

    def collect(key, ev):
        def per_frame(item, out):
            assert item.frame.depth_maps is not None
            frames.setdefault(key, []).append(
                (item.frame_index, np.asarray(out["rgb_map"], np.float32),
                 ev.psnr[-1]))
            return {}
        return per_frame

    # frames 0 and 2 of one target camera
    opts = _depth_opts(zju_root, depth_root, ["test.target_view", "2,"])
    jcfg = JConfig().merge_opts(opts + ["pad_bucket", "256"])
    for tag, pipe in (jpipe.items() if isinstance(jpipe, dict)
                      else (("jax", jpipe),)):
        ev = JEvaluator(str(tmp_path / tag))
        if as_written:
            with _as_written():
                jax_evaluate_frames(jcfg, pipe, params, j, ev,
                                    collect(tag, ev))
        else:
            jax_evaluate_frames(jcfg, pipe, params, j, ev, collect(tag, ev))
    kernels.reset_launch_counts()
    tev = Evaluator(str(tmp_path / "port"))
    run_cli.evaluate_frames(Config().merge_opts(opts), tpipe, t, tev,
                            collect("port", tev))
    return frames


def test_zju_depth_eval_forward_matches_the_jax_package(zju_root, depth_root,
                                                        bridged, tmp_path):
    jpipe, params, port_pipe = bridged
    frames = _eval_runs(zju_root, depth_root, jpipe, params, port_pipe(),
                        tmp_path)
    assert len(frames["port"]) == len(frames["jax"]) == 2
    for (fj, rj, pj), (ft, rt, pt) in zip(frames["jax"], frames["port"]):
        assert fj == ft and rt.shape == rj.shape and np.isfinite(rt).all()
        # tests/test_torch_eval.py's bounds
        np.testing.assert_allclose(rt, rj, atol=2e-3)
        assert pt == pytest.approx(pj, abs=0.05)


def test_zju_depth_train_step_matches_the_jax_package(zju_root, depth_root,
                                                      bridged):
    jpipe, params, port_pipe = bridged
    j, t = _pair(zju_root, depth_root, "train", ["jitter", "False"])
    js, ts = j.get_train_sample(2), t.get_train_sample(2)
    assert ts.frame.depth_maps is not None
    jfn = jstep.make_sample_loss(jpipe, None, perturb=False)
    # one jitted program, not an eager dispatch (and compile) per operation
    (jl, _), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        params, js, jax.random.PRNGKey(0))
    pipe = port_pipe()
    tl, _ = tstep.make_sample_loss(pipe, perturb=False)(ts, seed=0)
    tl.backward()
    tg = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in pipe.model.named_parameters()}
    tg = _leaves(weights.jax_params_from_state_dict(tg)["params"])
    jg = _leaves(jg["params"])
    # tests/test_torch_train.py's bounds
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert set(tg) == set(jg)
    for k, want in jg.items():
        assert (np.linalg.norm(tg[k] - want)
                <= 1e-3 * np.linalg.norm(want) + 1e-10), k


def test_zju_depth_bf16_eval_forward_matches_jax_bf16(zju_root, depth_root,
                                                      bridged, tmp_path):
    """compute_dtype bfloat16: the port's bf16 frames against the JAX bf16
    pipeline's (float32 cull, as the port's), at tests/test_torch_bf16.py's
    bounds, each nearer JAX bf16 on average than JAX float32 is."""
    from tests.test_torch_bf16 import PSNR_ATOL, RGB_ATOL
    from transhuman_tpu_torch.models.network import TransHumanNet

    jpipe, params, port_pipe = bridged
    j16 = jpipe.clone(model=jpipe.model.clone(dtype=jnp.bfloat16))
    j16._cull = jpipe._cull  # the port's float32 cull
    net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                        knn_k=K, compute_dtype=torch.bfloat16)
    weights.load_reference_state_dict(net, weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH))
    tpipe = port_pipe().clone(model=net.eval())
    frames = _eval_runs(zju_root, depth_root, {"jp16": j16, "jp32": jpipe},
                        params, tpipe, tmp_path, as_written=True)
    assert len(frames["port"]) == len(frames["jp16"]) == 2
    for (_, rgb, psnr), (_, rgb16, psnr16), (_, rgb32, _) in zip(
            frames["port"], frames["jp16"], frames["jp32"]):
        _compare(torch.from_numpy(rgb), rgb16, rgb32, RGB_ATOL, "eval rgb")
        assert psnr == pytest.approx(psnr16, abs=PSNR_ATOL)
