"""LPIPS in the port against the JAX package on the CPU: the distance and its
input gradient (full VGG16 widths, random weights from
init_lpips_params(PRNGKey(0))), its npz loader, both weight converters, the
patch loss and one train step with LPIPS, and the evaluator's LPIPS
column with its 16-px guard."""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.synthetic import SyntheticDataset as JDataset
from transhuman_tpu.evals.evaluator import Evaluator as JEvaluator
from transhuman_tpu.models import lpips as jlp
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu.tools import convert_lpips as jconv_lpips
from transhuman_tpu.tools import convert_resnet as jconv_resnet
from transhuman_tpu.train import loss as jloss
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.evals.evaluator import Evaluator
from transhuman_tpu_torch.geometry.clusters import (
    ClusterSpec,
    normalize_positions,
)
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.models import lpips as tlp
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.render.pipeline import RenderPipeline
from transhuman_tpu_torch.tools import convert_lpips as tconv_lpips
from transhuman_tpu_torch.tools import convert_resnet as tconv_resnet
from transhuman_tpu_torch.train import loss as tloss
from transhuman_tpu_torch.train import step as tstep


@pytest.fixture(scope="module")
def lp():
    jp = jlp.init_lpips_params(jax.random.PRNGKey(0))
    return jp, tlp.LPIPS({k: np.asarray(v) for k, v in jp.items()})


@pytest.mark.parametrize("shape", [(2, 32, 40, 3), (1, 37, 23, 3)])
def test_lpips_and_its_gradient_match_jax(lp, shape):
    """Even and odd crops: the distance within 1e-5 of itself, the masked
    (zero-padded) JAX form too, and the input gradient within 1e-4 of its
    norm."""
    jp, net = lp
    rng = np.random.default_rng(shape[1])
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = rng.uniform(-1, 1, shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = net(xt, torch.from_numpy(y))
    got.sum().backward()
    got = got.detach().numpy()
    want = np.asarray(jlp.lpips_distance(jp, x, y))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    h, w = shape[1:3]
    pad = ((0, 0), (0, 64 - h), (0, 48 - w), (0, 0))
    masked = np.asarray(jlp.lpips_distance_masked(
        jp, np.pad(x, pad), np.pad(y, pad), np.array([h, w])))
    np.testing.assert_allclose(got, masked, rtol=1e-5)
    g = np.asarray(jax.grad(lambda a: jlp.lpips_distance(jp, a, y).sum())(x))
    assert np.linalg.norm(xt.grad.numpy() - g) <= 1e-4 * np.linalg.norm(g)


def test_lpips_stays_out_of_the_model_and_frozen(lp):
    _, net = lp
    assert all(not p.requires_grad and p.dtype == torch.float32
               for p in net.parameters())
    assert len(list(net.parameters())) == 13 * 2 + 5
    model = TransHumanNet(embed_dim=12, vit_depth=1, vit_heads=2, knn_k=3)
    assert not any("conv0_0" in k or "lin0" in k for k in model.state_dict())
    # bf16 inputs are computed in float32, as the JAX package's f32 pred
    x = torch.rand(1, 16, 16, 3) * 2 - 1
    np.testing.assert_allclose(net(x.bfloat16(), x).numpy(),
                               net(x.bfloat16().float(), x).numpy())
    assert net(x, x).dtype == torch.float32


def _npz(tmp_path, name, arrays):
    path = str(tmp_path / name)
    np.savez(path, **arrays)
    return path


def test_loader_keeps_the_jax_loaders_two_errors(lp, tmp_path):
    jp, _ = lp
    full = {k: np.asarray(v) for k, v in jp.items()}
    lins = {k: v for k, v in full.items() if k.startswith("lin")}
    convs = {k: v for k, v in full.items() if k.startswith("conv")}
    lins_p, convs_p = _npz(tmp_path, "l.npz", lins), _npz(tmp_path, "c.npz",
                                                          convs)
    for fn in (tlp.load_lpips_params, jlp.load_lpips_params):
        with pytest.raises(ValueError, match="lins-only"):
            fn(lins_p)
        with pytest.raises(ValueError, match="calibration heads"):
            fn(convs_p)
    merged = tlp.load_lpips_params(lins_p, backbone=convs_p)
    assert merged.keys() == full.keys()
    for k in full:
        np.testing.assert_array_equal(merged[k], full[k])
    with pytest.raises(FileNotFoundError):
        tlp.load_lpips_params(str(tmp_path / "missing.npz"))
    cfg = Config().merge_opts(["lpips_weights", lins_p, "lpips_backbone",
                               convs_p])
    net = tlp.lpips_module(cfg, "cpu")
    assert not net.training
    assert tlp.lpips_module(Config(), "cpu") is None


def _vgg_and_lins(rng):
    vgg, c_in = {}, 3
    for stage, (idxs, (_, ch)) in enumerate(zip(
            tconv_lpips.VGG16_FEATURE_IDX, tlp.VGG16_STAGES)):
        for li in idxs:
            vgg[f"{li}.weight"] = rng.standard_normal(
                (ch, c_in, 3, 3)).astype(np.float32)
            vgg[f"{li}.bias"] = rng.standard_normal(ch).astype(np.float32)
            c_in = ch
    lins = {f"lin{si}.model.1.weight": np.abs(rng.standard_normal(
        (1, ch, 1, 1))).astype(np.float32)
        for si, (_, ch) in enumerate(tlp.VGG16_STAGES)}
    return vgg, lins


def test_convert_lpips_equals_the_jax_copy(tmp_path):
    vgg, lins = _vgg_and_lins(np.random.default_rng(3))
    for v in (vgg, None):
        got, want = tconv_lpips.convert(v, lins), jconv_lpips.convert(v, lins)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    # main: the torch files in, the same npz out
    torch.save({f"features.{k}": torch.from_numpy(v) for k, v in vgg.items()},
               tmp_path / "vgg.pth")
    torch.save({k: torch.from_numpy(v) for k, v in lins.items()},
               tmp_path / "lins.pth")
    args = ["--vgg", str(tmp_path / "vgg.pth"), "--lins",
            str(tmp_path / "lins.pth")]
    tconv_lpips.main(args + [str(tmp_path / "t.npz")])
    jconv_lpips.main(args + [str(tmp_path / "j.npz")])
    with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_array_equal(t[k], j[k])
    # the converted file gives the JAX package's LPIPS
    x = np.random.default_rng(4).uniform(-1, 1, (1, 16, 16, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        tlp.LPIPS.from_npz(str(tmp_path / "t.npz"))(
            torch.from_numpy(x), torch.from_numpy(-x)).numpy(),
        np.asarray(jlp.lpips_distance(
            jlp.load_lpips_params(str(tmp_path / "j.npz")), x, -x)),
        rtol=1e-5)


def _resnet18(rng):
    sd = {"conv1.weight": (64, 3, 7, 7), "bn1.weight": (64,),
          "bn1.bias": (64,)}
    for layer, c_in, c in (("layer1", 64, 64), ("layer2", 64, 128)):
        for b in range(2):
            base, ci = f"{layer}.{b}", c_in if b == 0 else c
            sd.update({f"{base}.conv1.weight": (c, ci, 3, 3),
                       f"{base}.bn1.weight": (c,), f"{base}.bn1.bias": (c,),
                       f"{base}.conv2.weight": (c, c, 3, 3),
                       f"{base}.bn2.weight": (c,), f"{base}.bn2.bias": (c,)})
            if b == 0 and c != c_in:
                sd.update({f"{base}.downsample.0.weight": (c, c_in, 1, 1),
                           f"{base}.downsample.1.weight": (c,),
                           f"{base}.downsample.1.bias": (c,)})
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in sd.items()}


def test_convert_resnet_and_apply_pretrained_equal_the_jax_copy(tmp_path):
    sd = _resnet18(np.random.default_rng(5))
    got, want = tconv_resnet.convert(sd), jconv_resnet.convert(sd)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # onto the same starting weights, both packages' apply_pretrained
    jmodel, _, frame, _, _ = synthetic_setup(
        n_views=2, image_hw=(32, 32), n_verts=64, n_clusters=8, n_samples=4,
        embed_dim=12, vit_depth=1, vit_heads=2, knn_k=3)
    params = init_params(jmodel, frame, 8, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    jout = jconv_resnet.apply_pretrained(params, dict(want))
    net = TransHumanNet(embed_dim=12, vit_depth=1, vit_heads=2, knn_k=3)
    weights.load_reference_state_dict(
        net, weights.state_dict_from_jax(params["params"], 1))
    tconv_resnet.apply_pretrained(net, dict(got))
    want_sd = weights.live_state_dict(weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, jout["params"]), 1))
    for k, v in net.state_dict().items():
        torch.testing.assert_close(v, want_sd[k], rtol=0, atol=0, msg=k)
    assert torch.equal(net.state_dict()["encoder.model.conv1.weight"],
                       torch.from_numpy(sd["conv1.weight"]))
    with pytest.raises(ValueError, match="conv1/kernel"):
        tconv_resnet.apply_pretrained(net, {"conv1/kernel": np.zeros(
            (3, 3, 3, 64), np.float32)})


def test_patch_losses_with_lpips_match_jax(lp):
    jp, net = lp
    rng = np.random.default_rng(6)
    p, ps, r = 2, 16, 400
    pred = rng.random((r, 3)).astype(np.float32)
    target = rng.random((p, ps, ps, 3)).astype(np.float32)
    idx = rng.permutation(p * ps * ps - 1)[:r].astype(np.int32)

    class _S:
        pass

    js, ts = _S(), _S()
    js.target_patches, js.ray_pixel_idx = jnp.asarray(target), jnp.asarray(idx)
    ts.target_patches, ts.ray_pixel_idx = (torch.from_numpy(target),
                                           torch.from_numpy(idx))

    def jfn(x):
        return jloss.patch_losses(x, js, jlp.make_lpips_fn(jp), 0.7, 0.1)

    (jl, jst), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_(True)
    tl, tst = tloss.patch_losses(pt, ts, net, 0.7, 0.1)
    tl.backward()
    assert set(tst) == set(jst) == {"mse_loss", "lpips_loss", "loss"}
    for k in jst:
        np.testing.assert_allclose(float(tst[k].detach()), float(jst[k]),
                                   rtol=1e-5)
    assert float(tst["lpips_loss"]) > 0
    jg = np.asarray(jg)
    assert np.linalg.norm(pt.grad.numpy() - jg) <= 1e-4 * np.linalg.norm(jg)
    # without LPIPS: the MSE alone, and no lpips_loss stat
    l0, s0 = tloss.patch_losses(pt, ts, None, 0.7, 0.1)
    assert set(s0) == {"mse_loss", "loss"}
    assert float(l0) == pytest.approx(float(tst["mse_loss"]))


# ------------------------------------------------------- one train step
HW, NV, NC, NS, EMBED, DEPTH, HEADS, K = 32, 128, 16, 4, 12, 2, 2, 3
OPTS = ["num_class", str(NC), "patch.size", "16", "patch.N_patches", "2",
        "ep_iter", "4"]
LOSS_RTOL_BF16, GRAD_TOL_BF16 = 1e-3, 0.1  # tests/test_torch_bf16.py's
# the pixel keys' bias shifts every key alike under the softmax over the
# keys: its gradient vanishes in exact arithmetic.  At these 512 rays both
# packages leave float32 noise there (the same step without LPIPS reads
# 1.4x its own norm apart), so it is held to that floor, not to 1e-3 of
# its norm
VANISHING = "['heads']['fusion']['pix_key']['bias']"

_JIT = jax.jit


@contextlib.contextmanager
def _as_written(dtype):
    """bf16: the JAX reference's jits compile with XLA's excess precision
    off, as in tests/test_torch_bf16.py."""
    if dtype == "float32":
        yield
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", functools.partial(
            _JIT, compiler_options={"xla_allow_excess_precision": False}))
        yield


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def lpips_step(request, lp):
    """One sample's loss, gradients and first Adam update with LPIPS at
    weight 0.1, jitter off, in both packages, in the compute dtype."""
    dtype = request.param
    jp, tnet = lp
    jdata = JDataset(JConfig().merge_opts(list(OPTS)), "train", n_frames=2,
                     image_hw=(HW, HW), n_verts=NV)
    tdata = SyntheticDataset(Config().merge_opts(list(OPTS)), n_frames=2,
                             image_hw=(HW, HW), n_verts=NV)
    js, ts = jdata.get_train_sample(0), tdata.get_train_sample(0)
    jmodel, _, jframe, jsmpl, jcluster = synthetic_setup(
        n_views=3, image_hw=(HW, HW), n_verts=NV, n_clusters=NC,
        n_samples=NS, embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
        knn_k=K)
    params = init_params(jmodel, jframe, NC, jax.random.PRNGKey(0))
    table = weights.reference_pe_table(normalize_positions(
        jcluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
    pipes = {d: JPipeline(jmodel.clone(dtype=d), jcluster, jsmpl.v_template,
                          n_samples=NS, pe_table=table)
             for d in (jnp.float32, jnp.bfloat16)}
    pipes[jnp.bfloat16]._cull = pipes[jnp.float32]._cull  # the port's cull
    jpipe = pipes[jnp.bfloat16 if dtype == "bfloat16" else jnp.float32]
    key = jax.random.PRNGKey(0)
    with _as_written(dtype):
        jfn = jstep.make_sample_loss(jpipe, jlp.make_lpips_fn(jp),
                                     perturb=False)
        (jl, jst), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
            params, js, key)
        tx, _ = jstep.make_optimizer(iters_per_epoch=4)
        upd = jax.jit(lambda g, p: optax.apply_updates(
            p, tx.update(g, tx.init(p), p)[0]))(jg, params)
    sd = weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH)
    net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                        knn_k=K, compute_dtype=getattr(torch, dtype))
    weights.load_reference_state_dict(net, sd)
    pipe = RenderPipeline(net, ClusterSpec(jcluster.vert2cluster, NC),
                          SMPLModel.synthetic(n_verts=NV).v_template,
                          n_samples=NS, device="cpu")
    opt, sched = tstep.make_optimizer(net.parameters(), iters_per_epoch=4)
    state = tstep.TrainState(net, opt, sched)
    stats = tstep.make_train_step(pipe, perturb=False, lpips_fn=tnet,
                                  lpips_weight=0.1)(state, ts, 0)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in net.named_parameters()}
    return dict(
        dtype=dtype, jl=float(jl), jst={k: float(v) for k, v in jst.items()},
        jg=_leaves(jg["params"]), ju=_leaves(upd["params"]),
        p0=_leaves(params["params"]), stats=stats,
        tg=_leaves(weights.jax_params_from_state_dict(grads)["params"]),
        tu=_leaves(weights.jax_params_from_state_dict(net.state_dict())[
            "params"]), lpips_grad=[p.grad for p in tnet.parameters()])


def test_train_step_with_lpips_matches_jax(lpips_step):
    """The loss and its LPIPS term, every gradient leaf and the first Adam
    update: tests/test_torch_train.py's bounds in float32,
    tests/test_torch_bf16.py's in bf16."""
    s = lpips_step
    st = s["stats"]
    assert set(st) == {"mse_loss", "lpips_loss", "loss", "lr"}
    assert st["lpips_loss"] > 0 and np.isfinite(st["loss"])
    assert all(g is None for g in s["lpips_grad"])  # LPIPS stays frozen
    rtol = 1e-5 if s["dtype"] == "float32" else LOSS_RTOL_BF16
    for k in ("loss", "mse_loss", "lpips_loss"):
        assert st[k] == pytest.approx(s["jst"][k], rel=rtol), k
    assert set(s["tg"]) == set(s["jg"])
    gmax = max(np.linalg.norm(g) for g in s["jg"].values())
    for k, want in s["jg"].items():
        got = s["tg"][k]
        if k == VANISHING:
            # zero in exact arithmetic: float32 noise on both sides, far
            # below every other leaf (chip_smoke.py phase 6's floor)
            assert max(np.linalg.norm(got), np.linalg.norm(want)) <= (
                1e-5 * gmax), k
        elif s["dtype"] == "float32":
            assert np.linalg.norm(got - want) <= (
                1e-3 * np.linalg.norm(want) + 1e-10), k
        else:
            assert np.linalg.norm(got - want) <= GRAD_TOL_BF16 * gmax, k
    lr = 7e-4 / 300
    tight = total = 0
    for k, p0 in s["p0"].items():
        dt, dj, g = s["tu"][k] - p0, s["ju"][k] - p0, s["jg"][k]
        slack = 2 * np.spacing(np.abs(p0).astype(np.float32))
        assert (np.abs(dt) <= lr * 1.001 + slack).all(), k
        if s["dtype"] == "float32":
            sure = np.abs(g) > 1e-6
            assert (np.abs(dt - dj)[sure] <= 0.01 * lr + slack[sure]).all(), k
            tight += sure.sum()
            total += g.size
    if s["dtype"] == "float32":
        assert tight >= 0.75 * total


# ------------------------------------------------------------ evaluator
def _frames(rng, n, hw=(40, 48)):
    h, w = hw
    out = []
    for i in range(n):
        mask = np.zeros((h, w), bool)
        mask[3 + i:3 + i + 20 + 3 * i, 5:5 + 17 + 2 * i] = True
        r = int(mask.sum())
        out.append((rng.random((r, 3)).astype(np.float32),
                    rng.random((r, 3)).astype(np.float32), mask.ravel()))
    return out


def test_evaluator_lpips_column_matches_jax(lp, tmp_path):
    """Per-frame LPIPS on the bbox crop against the JAX evaluator's bucketed
    masked form within 1e-5; the other arrays within 1e-9; the summary's
    lpips line."""
    jp, net = lp
    frames = _frames(np.random.default_rng(7), 3)
    jev = JEvaluator(str(tmp_path / "jax"),
                     lpips_fn=jax.jit(jlp.make_lpips_masked_fn(jp)),
                     save_images=False)

    def tfn(a, b):
        with torch.no_grad():
            return net(torch.from_numpy(a), torch.from_numpy(b)).numpy()

    tev = Evaluator(str(tmp_path / "port"), lpips_fn=tfn, save_images=False)
    for pred, gt, mask in frames:
        j = jev.evaluate_frame(pred, gt, mask, (40, 48))
        t = tev.evaluate_frame(pred, gt, mask, (40, 48))
        assert t["lpips"] == pytest.approx(j["lpips"], rel=1e-5)
    jsum, tsum = jev.summarize(), tev.summarize()
    for name in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(np.load(tmp_path / "port" / f"{name}.npy"),
                                   np.load(tmp_path / "jax" / f"{name}.npy"),
                                   rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.load(tmp_path / "port" / "lpips.npy"),
                               np.load(tmp_path / "jax" / "lpips.npy"),
                               rtol=1e-5)
    assert np.load(tmp_path / "port" / "lpips.npy").shape == (3,)
    assert tsum["lpips"] == pytest.approx(jsum["lpips"], rel=1e-5)
    text = (tmp_path / "port" / "summary.txt").read_text()
    assert f"lpips: {tsum['lpips']}" in text and "n/a" not in text


def test_evaluator_16px_guard_fires_before_any_metric(lp, tmp_path):
    jp, net = lp
    h, w = 30, 30
    mask = np.zeros((h, w), bool)
    mask[2:22, 4:14] = True  # 10 px wide: SSIM runs, LPIPS cannot
    r = int(mask.sum())
    pred = np.full((r, 3), 0.5, np.float32)
    gt = np.full((r, 3), 0.25, np.float32)
    tev = Evaluator(str(tmp_path / "t"), lpips_fn=lambda a, b: np.zeros(1),
                    save_images=False)
    jev = JEvaluator(str(tmp_path / "j"), lpips_fn=lambda a, b, hw: 0.0,
                     save_images=False)
    for ev in (tev, jev):
        with pytest.raises(ValueError, match="LPIPS needs a crop >= 16px"):
            ev.evaluate_frame(pred, gt, mask.ravel(), (h, w))
        assert ev.mse == ev.psnr == ev.ssim == ev.lpips == []
    # without LPIPS the same frame evaluates, and the column reads n/a
    ev = Evaluator(str(tmp_path / "n"), save_images=False)
    assert ev.evaluate_frame(pred, gt, mask.ravel(), (h, w))["lpips"] is None
    ev.summarize()
    assert "lpips: n/a" in (tmp_path / "n" / "summary.txt").read_text()
