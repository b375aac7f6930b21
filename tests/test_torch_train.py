"""The training slice: the port's token gradient through the K2 Function,
losses, schedule, optimizers, synthetic train data, and one whole train step
against the JAX package on the CPU, with the same numpy inputs and bridged
weights; then the port's train entry point and its checkpoint."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.synthetic import SyntheticDataset as JDataset
from transhuman_tpu.models.heads import dparf_representation as jax_rep
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu.train import loss as jloss
from transhuman_tpu.train import step as jstep
from transhuman_tpu.train.schedule import warmup_cosine_epoch_schedule as jsch
from transhuman_tpu_torch import kernels, weights
from transhuman_tpu_torch.cli import train as tcli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.geometry.clusters import (
    ClusterSpec,
    normalize_positions,
)
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.models.heads import dparf_representation
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.render.pipeline import RenderPipeline
from transhuman_tpu_torch.train import loss as tloss
from transhuman_tpu_torch.train import step as tstep
from transhuman_tpu_torch.train.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from transhuman_tpu_torch.train.schedule import warmup_cosine_epoch_schedule


def test_token_gradient_through_the_k2_function_matches_jax():
    rng = np.random.default_rng(0)
    n, c, v, d = 300, 40, 2, 16
    pts = (rng.standard_normal((n, 3)) * 0.4).astype(np.float32)
    centers = (rng.standard_normal((c, 3)) * 0.4).astype(np.float32)
    rot = np.stack([np.linalg.qr(m)[0] for m in
                    rng.standard_normal((c, 3, 3))]).astype(np.float32)
    tokens = rng.standard_normal((v, c, d)).astype(np.float32)
    g = rng.standard_normal((v, n, d + 63)).astype(np.float32)

    def jloss_fn(t):
        rep, _ = jax_rep(jnp.asarray(pts), jnp.asarray(centers),
                         jnp.asarray(rot), t)
        return jnp.sum(rep * jnp.asarray(g))

    want = jax.grad(jloss_fn)(jnp.asarray(tokens))
    tk = torch.from_numpy(tokens).requires_grad_(True)
    rep, _ = dparf_representation(torch.from_numpy(pts),
                                  torch.from_numpy(centers),
                                  torch.from_numpy(rot), tk)
    (rep * torch.from_numpy(g)).sum().backward()
    assert kernels.launch_counts()["dparf"] == 0  # CPU: the plain twin
    # each token sums ~50 weighted cotangent rows; float32, two orders
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(want), atol=2e-5)


# ---------------------------------------------------------------- losses
def test_patch_and_ray_losses_match_jax():
    rng = np.random.default_rng(1)
    p, ps, r = 2, 4, 30
    pred = rng.random((r, 3)).astype(np.float32)
    target = rng.random((p, ps, ps, 3)).astype(np.float32)
    idx = rng.permutation(p * ps * ps - 1)[:r].astype(np.int32)
    idx[-3:] = -1  # invalid rays; the port drops them
    pred[-3:] = 0.0  # (the JAX scatter wraps -1 onto the last pixel, which
    #                  no valid ray covers here, and writes the zeros there)
    tgt_rgb = rng.random((r, 3)).astype(np.float32)
    mask = rng.random(r) > 0.3

    t = torch.from_numpy
    got = tloss.unpack_patches(t(pred), t(idx), target.shape)
    want = jloss.unpack_patches(jnp.asarray(pred), jnp.asarray(idx),
                                target.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    class _S:
        pass

    js, ts = _S(), _S()
    js.target_patches, js.ray_pixel_idx = jnp.asarray(target), jnp.asarray(idx)
    ts.target_patches, ts.ray_pixel_idx = t(target), t(idx)
    js.target_rgb, ts.target_rgb = jnp.asarray(tgt_rgb), t(tgt_rgb)
    js.rays, ts.rays = _S(), _S()
    js.rays.mask, ts.rays.mask = jnp.asarray(mask), t(mask)
    # float32 means over at most 96 values: rounding only
    for (lt, st), (lj, sj) in [
        (tloss.patch_losses(t(pred), ts, None, 0.7),
         jloss.patch_losses(jnp.asarray(pred), js, None, 0.7)),
        (tloss.random_ray_losses(t(pred), ts, 0.7),
         jloss.random_ray_losses(jnp.asarray(pred), js, 0.7)),
    ]:
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
        assert set(st) == set(sj)
        for k in st:
            np.testing.assert_allclose(float(st[k]), float(sj[k]), rtol=1e-6)
    np.testing.assert_allclose(
        float(tloss.masked_mse(t(pred), t(tgt_rgb), t(mask))),
        float(jloss.masked_mse(jnp.asarray(pred), jnp.asarray(tgt_rgb),
                               jnp.asarray(mask))), rtol=1e-6)


EP_ITER, WARM, DECAY = 5, 3, 7


def test_schedule_matches_jax():
    t = warmup_cosine_epoch_schedule(7e-4, 1e-6, WARM, DECAY, EP_ITER)
    j = jsch(7e-4, 1e-6, WARM, DECAY, EP_ITER)
    steps = [0, 1, EP_ITER, WARM * EP_ITER - 1, WARM * EP_ITER,
             WARM * EP_ITER + 1, (WARM + 2) * EP_ITER, DECAY * EP_ITER,
             (DECAY + 5) * EP_ITER]
    # the JAX schedule computes in float32
    np.testing.assert_allclose([t(s) for s in steps],
                               [float(j(s)) for s in steps], rtol=1e-6)
    assert t(0) == pytest.approx(7e-4 / WARM)


@pytest.mark.parametrize("optim,wd", [("adam", 0.0), ("adam", 0.01),
                                      ("radam", 0.0), ("sgd", 0.0)])
def test_optimizer_updates_match_optax(optim, wd):
    """Four updates with clipping at 40, across a warmup/cosine boundary:
    the update k uses lr(k), as optax's schedule does."""
    rng = np.random.default_rng(2)
    p0 = rng.standard_normal((50,)).astype(np.float32)
    grads = [rng.standard_normal((50,)).astype(np.float32) * s
             for s in (1e-3, 50.0, 1.0, 1e-2)]
    tx, _ = jstep.make_optimizer(7e-4, 1e-6, 1, 3, 2, weight_decay=wd,
                                 optim=optim)
    pj = jnp.asarray(p0)
    st = tx.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = tstep.make_optimizer([pt], 7e-4, 1e-6, 1, 3, 2,
                                      weight_decay=wd, optim=optim)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, upd)
        pt.grad = torch.from_numpy(g.copy())
        torch.nn.utils.clip_grad_value_([pt], 40.0)
        opt.step()
        sched.step()
    # float32 arithmetic in two orders; RAdam places eps after the bias
    # correction in optax and before it in torch (its first steps are
    # unrectified, so eps does not enter them)
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="unknown optimizer"):
        tstep.make_optimizer([pt], optim="lion")


# ----------------------------------------------------------------- slice
HW, NV, NC, NS, EMBED, DEPTH, HEADS, K = 32, 128, 16, 4, 12, 2, 2, 3
OPTS = ["num_class", str(NC), "patch.size", "4", "patch.N_patches", "2",
        "ep_iter", "4"]


@pytest.fixture(scope="module")
def slice_setup():
    jcfg = JConfig().merge_opts(list(OPTS))
    tcfg = Config().merge_opts(list(OPTS))
    jdata = JDataset(jcfg, "train", n_frames=2, image_hw=(HW, HW),
                     n_verts=NV)
    tdata = SyntheticDataset(tcfg, n_frames=2, image_hw=(HW, HW), n_verts=NV)
    jmodel, _, jframe, jsmpl, jcluster = synthetic_setup(
        n_views=3, image_hw=(HW, HW), n_verts=NV, n_clusters=NC,
        n_samples=NS, embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
        knn_k=K)
    params = init_params(jmodel, jframe, NC, jax.random.PRNGKey(0))
    table = weights.reference_pe_table(normalize_positions(
        jcluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
    jpipe = JPipeline(jmodel, jcluster, jsmpl.v_template, n_samples=NS,
                      pe_table=table)
    sd = weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH)

    def port_pipe():
        net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                            knn_k=K)
        weights.load_reference_state_dict(net, sd)
        return RenderPipeline(net, ClusterSpec(jcluster.vert2cluster, NC),
                              SMPLModel.synthetic(n_verts=NV).v_template,
                              n_samples=NS)

    return jdata, tdata, jpipe, params, port_pipe


def test_synthetic_train_sample_matches_jax(slice_setup):
    jdata, tdata, *_ = slice_setup
    for epoch in (0, 1):
        jdata.set_epoch(epoch)
        tdata.set_epoch(epoch)
        j, t = jdata.get_train_sample(1), tdata.get_train_sample(1)
        for f in ("target_patches", "ray_pixel_idx"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))
        for f in ("ray_o", "ray_d", "near", "far", "mask"):
            np.testing.assert_array_equal(getattr(t.rays, f).numpy(),
                                          np.asarray(getattr(j.rays, f)))
        for f in ("images", "K", "R", "T", "verts_world", "blend_rot"):
            np.testing.assert_array_equal(getattr(t.frame, f).numpy(),
                                          np.asarray(getattr(j.frame, f)))
    assert t.rays.mask.all()  # no -1 rays: see the loss test for those


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


@pytest.fixture(scope="module")
def one_step(slice_setup):
    """The loss, gradients and one Adam update of one sample, jitter off,
    raw_noise_std 0, LPIPS off, in both packages."""
    jdata, tdata, jpipe, params, port_pipe = slice_setup
    jdata.set_epoch(0)
    tdata.set_epoch(0)
    js, ts = jdata.get_train_sample(0), tdata.get_train_sample(0)
    key = jax.random.PRNGKey(0)

    jfn = jstep.make_sample_loss(jpipe, None, perturb=False)
    (jl, _), jg = jax.value_and_grad(jfn, has_aux=True)(params, js, key)
    tx, _ = jstep.make_optimizer(iters_per_epoch=4)
    jtrain = jstep.make_train_step(jpipe, tx, perturb=False, donate=False)
    batch = jax.tree.map(lambda x: np.asarray(x)[None], js)
    jstate, jstats = jtrain(jstep.init_state(params, tx), batch, key)

    pipe = port_pipe()
    net = pipe.model
    tl, _ = tstep.make_sample_loss(pipe, perturb=False)(ts, seed=0)
    tl.backward()
    tg = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
          for n, p in net.named_parameters()}
    pipe2 = port_pipe()
    opt, sched = tstep.make_optimizer(pipe2.model.parameters(),
                                      iters_per_epoch=4)
    state = tstep.TrainState(pipe2.model, opt, sched)
    stats = tstep.make_train_step(pipe2, perturb=False)(state, ts, 0)
    return dict(jl=float(jl), jg=_leaves(jg["params"]),
                tl=float(tl.detach()),
                tg=_leaves(weights.jax_params_from_state_dict(tg)["params"]),
                jstats=jstats, jp=_leaves(jstate.params["params"]),
                p0=_leaves(params["params"]), stats=stats, state=state,
                tp=_leaves(weights.jax_params_from_state_dict(
                    pipe2.model.state_dict())["params"]))


def test_train_loss_and_gradients_match_jax(one_step):
    s = one_step
    assert np.isfinite(s["tl"]) and s["tl"] > 0
    # float32 forward through the same composition: rounding only
    np.testing.assert_allclose(s["tl"], s["jl"], rtol=1e-5)
    assert set(s["tg"]) == set(s["jg"])
    nonzero = 0
    for k, want in s["jg"].items():
        got, scale = s["tg"][k], np.linalg.norm(want)
        # per leaf, relative to the leaf's norm: float32 backward sums in two
        # orders through up to ~20 layers; 1e-10 absolute for leaves whose
        # gradient is zero (the unused mask token)
        assert np.linalg.norm(got - want) <= 1e-3 * scale + 1e-10, k
        nonzero += scale > 0
    assert nonzero >= len(s["jg"]) - 1  # all but the mask token


def test_train_step_update_matches_jax(one_step):
    s = one_step
    lr = 7e-4 / 300  # lr(0): optax's count is 0 at the first update
    assert s["stats"]["lr"] == pytest.approx(lr)
    np.testing.assert_allclose(s["stats"]["loss"], float(s["jstats"]["loss"]),
                               rtol=1e-5)
    assert s["state"].step == 1
    tight = total = 0
    for k, p0 in s["p0"].items():
        dt, dj, g = s["tp"][k] - p0, s["jp"][k] - p0, s["jg"][k]
        slack = 2 * np.spacing(np.abs(p0).astype(np.float32))
        # Adam's first update is -lr g / (|g| + 1e-8): +-lr wherever |g| is
        # well above 1e-8, whatever the small gradient differences; where
        # |g| <= 1e-6 (or zero) the two sides may land anywhere in [-lr, lr]
        sure = np.abs(g) > 1e-6
        assert (np.abs(dt - dj)[sure] <= 0.01 * lr + slack[sure]).all(), k
        assert (np.abs(dt - dj) <= 2 * lr + slack).all(), k
        tight += sure.sum()
        total += g.size
    assert tight >= 0.75 * total  # 86.5% of the elements at these sizes


def test_checkpoint_round_trip_and_serving_load(one_step, tmp_path):
    state = one_step["state"]
    path = str(tmp_path / "latest.pth")
    save_checkpoint(path, state, epoch=3)
    net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                        knn_k=K)
    assert weights.load_checkpoint_file(net, path) == 3
    for (n, a), b in zip(state.model.state_dict().items(),
                         net.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    opt, sched = tstep.make_optimizer(net.parameters(), iters_per_epoch=4)
    fresh = tstep.TrainState(net, opt, sched)
    assert load_checkpoint(path, fresh) == 3
    assert fresh.step == 1 and fresh.scheduler.last_epoch == 1
    assert fresh.optimizer.state_dict()["state"].keys() == \
        state.optimizer.state_dict()["state"].keys()


def test_render_train_seed_drives_jitter_and_noise(
        slice_setup):
    """A seed without jitter or noise changes nothing; the jitter and the
    density noise each change the render, reproducibly per seed."""
    tdata, pipe = slice_setup[1], slice_setup[4]()
    tdata.set_epoch(0)
    s = tdata.get_train_sample(0)
    with torch.no_grad():
        def render(seed, jitter, noise_std):
            pipe.raw_noise_std = noise_std
            return pipe.render_train(s.frame, s.rays, seed, jitter)

        base = render(None, True, 0.0)
        torch.testing.assert_close(render(5, False, 0.0), base, rtol=0,
                                   atol=0)
        jit = render(5, True, 0.0)
        assert not torch.equal(jit["depth_map"], base["depth_map"])
        torch.testing.assert_close(render(5, True, 0.0), jit, rtol=0, atol=0)
        noisy = render(5, False, 10.0)
        assert not torch.equal(noisy["acc_map"], base["acc_map"])
        torch.testing.assert_close(render(5, False, 10.0), noisy, rtol=0,
                                   atol=0)
        both = render(5, True, 10.0)
        assert not torch.equal(both["acc_map"], jit["acc_map"])


def test_train_entry_point_trains_and_saves(tmp_path, capsys):
    out = str(tmp_path / "ckpt" / "latest.pth")
    state, records = tcli.main([
        "--device", "cpu", "--steps", "3", "--out", out, "H", "64", "W", "64", "num_class", "20",
        "vit_depth", "1", "N_samples", "8", "patch.size", "6",
        "patch.N_patches", "2", "ep_iter", "2", "raw_noise_std", "1.0",
        "dataset", "synthetic", "trained_model_dir", str(tmp_path / "tm"),
        "record_dir", str(tmp_path / "rec")])
    assert [r["step"] for r in records] == [0, 1, 2]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in records)
    assert records[2]["lr"] > records[0]["lr"]  # epoch 1 of the warmup
    assert state.step == 3
    for n, p in state.model.named_parameters():
        assert n == "ViT.mask_token" or (
            p.grad is not None and torch.isfinite(p.grad).all()), n
    text = capsys.readouterr()
    assert "perceptual loss DISABLED" in text.err
    assert text.out.count("loss") >= 3 and "checkpoint:" in text.out
    net = TransHumanNet(embed_dim=192, vit_depth=1, vit_heads=3)
    assert weights.load_checkpoint_file(net, out) == 1


@pytest.mark.parametrize("argv", [["--device", "cuda", "--steps", "1"],
                                  ["--steps", "1"]])
def test_train_entry_point_without_a_card_fails(argv):
    """--device cuda, and no --device at all (the card is the default),
    fail without a card."""
    assert tcli.parse_args(["--steps", "1"])[0].device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(argv)
