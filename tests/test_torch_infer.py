"""Ray-sharded inference (``mesh_axis_rays``, parallel/infer.py) on the CPU:
the sharded render against the port's one-device render_frame (bit for
bit) and against the JAX package's ``make_sharded_render`` on 2 host
devices; a failing share; evaluate_frames, serve's /healthz and the card
route's refusals."""

import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from transhuman_tpu.parallel.infer import make_sharded_render as jax_sharded
from transhuman_tpu.render.pipeline import RayBundle as JRayBundle
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.render.pipeline import pad_rays
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu_torch import kernels, weights
from transhuman_tpu_torch.cli import common
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.cli import train as train_cli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.evals.evaluator import Evaluator
from transhuman_tpu_torch.geometry.clusters import (
    ClusterSpec,
    normalize_positions,
)
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.parallel import infer
from transhuman_tpu_torch.parallel.mesh import DataMesh
from transhuman_tpu_torch.render.pipeline import FrameInputs, RenderPipeline
from transhuman_tpu_torch.serve import RenderServer, RenderService
from transhuman_tpu_torch.testing import synthetic_rays

HW, V, NV, NC, NS, EMBED, DEPTH, HEADS, K, CR = 24, 3, 100, 10, 8, 12, 1, 2, 3, 8
N_RAYS = 45  # a multiple of neither chunk_rays * 2 nor chunk_rays * 3


@pytest.fixture(scope="module")
def scene():
    """The JAX pipeline, its params and frame; the port's pipeline with the
    bridged weights and the same clusters and PE table; the port's frame."""
    jmodel, _, jframe, jsmpl, jcluster = synthetic_setup(
        n_views=V, image_hw=(HW, HW), n_verts=NV, n_clusters=NC,
        n_samples=NS, chunk_rays=CR, embed_dim=EMBED, vit_depth=DEPTH,
        vit_heads=HEADS, knn_k=K)
    params = init_params(jmodel, jframe, NC, jax.random.PRNGKey(0))
    table = weights.reference_pe_table(normalize_positions(
        jcluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
    jpipe = JPipeline(jmodel, jcluster, jsmpl.v_template, n_samples=NS,
                      chunk_rays=CR, pe_table=table)
    net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                        knn_k=K)
    weights.load_reference_state_dict(net, weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH))
    smpl = SMPLModel.synthetic(n_verts=NV)
    pipe = _pipe(net.eval(), ClusterSpec(jcluster.vert2cluster, NC),
                 smpl.v_template)
    frame = FrameInputs(**{
        f.name: torch.from_numpy(np.array(getattr(jframe, f.name)))
        for f in dataclasses.fields(FrameInputs)
        if getattr(jframe, f.name) is not None})
    return jpipe, params, jframe, pipe, frame, smpl


def _pipe(net, cluster, verts):
    return RenderPipeline(net, cluster, verts, n_samples=NS, chunk_rays=CR,
                          device="cpu")


def masked_rays(n=N_RAYS):
    rays = synthetic_rays(n)
    rays.mask[::7] = False  # masked rays render zeros
    return rays


@pytest.mark.parametrize("r", [2, 3])
def test_sharded_render_equals_one_device_bit_for_bit(scene, r):
    _, _, _, pipe, frame, _ = scene
    rays = masked_rays()
    want = pipe.render_frame(frame, rays)
    stats = dict(pipe.last_frame_stats)
    kernels.reset_launch_counts()
    render = infer.make_sharded_render(pipe, ["cpu"] * r)
    pipe.last_frame_stats = {}
    got = render(frame, rays)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["acc_map"].max() > 0.05  # the body is in view
    assert not got["rgb_map"][~rays.mask].any()
    # the replicas' counts summed: every point of every share, the same
    # survivors as one device
    assert pipe.last_frame_stats == stats
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(),
                                                    0)


def test_share_bounds_sit_on_whole_chunks():
    assert infer.share_bounds(45, 8, 2) == [(0, 24), (24, 45)]
    assert infer.share_bounds(45, 8, 3) == [(0, 16), (16, 32), (32, 45)]
    # fewer chunks than shares: the first holds them, the rest are empty
    assert infer.share_bounds(5, 8, 2) == [(0, 0), (0, 5)]
    for n, r in ((45, 2), (45, 3), (64, 4), (1, 3)):
        bounds = infer.share_bounds(n, 8, r)
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        assert all(a % 8 == 0 for a, _ in bounds)
        assert all(b0 == a1 for (_, b0), (a1, _) in zip(bounds, bounds[1:]))


def test_an_empty_share_is_skipped(scene):
    _, _, _, pipe, frame, _ = scene
    rays = masked_rays(5)
    want = pipe.render_frame(frame, rays)
    got = infer.make_sharded_render(pipe, ["cpu", "cpu"])(frame, rays)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_two_shares_match_the_jax_sharded_render(scene):
    """The JAX package's make_sharded_render over 2 host devices (rays
    padded to its multiple, the padding dropped) against the port over
    [cpu, cpu], with the same weights: the serve parity bounds (PERF.md
    section 2)."""
    jpipe, params, jframe, pipe, frame, _ = scene
    rays = masked_rays()
    render, multiple = jax_sharded(
        jpipe, Mesh(np.array(jax.devices()[:2]), ("data",)))
    jrays = pad_rays(JRayBundle(**{
        f: getattr(rays, f).numpy() for f in ("ray_o", "ray_d", "near",
                                              "far", "mask")}), multiple)
    want = {k: np.asarray(v)[:N_RAYS] for k, v in
            render(params, jframe, jrays).items()}
    got = infer.make_sharded_render(pipe, ["cpu", "cpu"])(frame, rays)
    assert want["acc_map"].max() > 0.05
    np.testing.assert_allclose(got["rgb_map"].numpy(), want["rgb_map"],
                               atol=2e-3)
    np.testing.assert_allclose(got["acc_map"].numpy(), want["acc_map"],
                               atol=2e-3)
    np.testing.assert_allclose(got["depth_map"].numpy(), want["depth_map"],
                               atol=1e-2)


def test_a_failing_share_raises_in_the_caller(scene, monkeypatch):
    _, _, _, pipe, frame, _ = scene
    real = infer.replicate
    ran = []

    def broken(p, devices):
        reps = real(p, devices)

        def fail(frame, rays):
            ran.append(threading.current_thread().name)
            raise RuntimeError("share 1 failed")

        reps[1].render_frame = fail
        return reps

    monkeypatch.setattr(infer, "replicate", broken)
    render = infer.make_sharded_render(pipe, ["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="share 1 failed"):
        render(frame, masked_rays())
    assert ran and ran[0].startswith("ray-share")  # on a worker thread


def test_replicas_share_the_model_on_its_device(scene):
    _, _, _, pipe, _, _ = scene
    reps = infer.replicate(pipe, ["cpu", "cpu", "cpu"])
    assert len({id(r) for r in reps}) == 3
    assert all(r.model is pipe.model and r.pe_can is pipe.pe_can
               for r in reps)


OPTS = ["H", str(2 * 32), "W", str(2 * 32), "num_class", str(NC),
        "N_samples", str(NS), "vit_depth", str(DEPTH),
        "test.frame_interval", "4", "chunk_size", str(CR * NS)]


def test_evaluate_frames_with_two_ray_shares_equals_one(scene, tmp_path):
    """evaluate_frames with mesh_axis_rays 2 (two CPU shares) writes the
    metrics of mesh_axis_rays 1, within 1e-9."""
    data = SyntheticDataset(Config().merge_opts(OPTS), "test",
                            image_hw=(32, 32), n_verts=NV)
    net = scene[3].model
    pipe = _pipe(net, data.cluster, data.smpl.v_template)
    sums = {}
    for r in (1, 2):
        ev = Evaluator(str(tmp_path / str(r)))
        cfg = Config().merge_opts(OPTS + ["mesh_axis_rays", str(r)])
        renderer = run_cli.FrameRenderer(cfg, pipe)
        assert renderer.devices == [torch.device("cpu")] * r
        sums[r], _ = run_cli.evaluate_frames(cfg, pipe, data, ev,
                                             renderer=renderer)
    assert sums[1]["psnr"] == pytest.approx(sums[2]["psnr"], abs=1e-9)
    assert sums[1]["ssim"] == pytest.approx(sums[2]["ssim"], abs=1e-9)
    for name in ("mse", "psnr", "ssim"):
        np.testing.assert_allclose(np.load(tmp_path / "2" / f"{name}.npy"),
                                   np.load(tmp_path / "1" / f"{name}.npy"),
                                   atol=1e-9, rtol=0)


def test_healthz_lists_the_ray_devices(scene):
    _, _, _, pipe, frame, smpl = scene
    cfg = Config().merge_opts(["H", str(2 * HW), "W", str(2 * HW),
                               "ratio", "0.5", "mesh_axis_rays", "2"])
    svc = RenderService(cfg, pipe, smpl)
    server = RenderServer(svc, port=0)
    server.start()
    try:
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{server.port}/healthz", timeout=30).read())
    finally:
        server.shutdown()
    assert health["devices"] == ["cpu", "cpu"]
    one = RenderService(Config().merge_opts(["H", str(2 * HW), "W",
                                             str(2 * HW)]), pipe, smpl)
    assert one.renderer.devices == [pipe.device]


def test_the_card_route_refuses_too_few_cards(monkeypatch, tmp_path):
    """R cards more than are visible is a SystemExit with the counts, from
    FrameRenderer (under torchrun from cuda:LOCAL_RANK*R on) and from
    configure_device; the train entry point's --test under torchrun with
    R > 1 reaches validation with the key."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert infer.ray_devices("cuda", 3) == [torch.device("cuda", i)
                                            for i in range(3)]
    with pytest.raises(SystemExit, match=r"needs cards 0\.\.3, but 3 CUDA"):
        run_cli.FrameRenderer(Config().merge_opts(["mesh_axis_rays", "4"]),
                              type("P", (), {"device": torch.device("cuda")}))
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(SystemExit, match=r"local rank 1 needs cards 2\.\.3"):
        infer.ray_devices("cuda", 2)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit, match="2 local ranks x mesh_axis_rays 2 "
                                         "need 4 CUDA cards but 3"):
        common.configure_device("cuda", "gloo", rays=2)
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.setattr(train_cli, "make_mesh",
                        lambda n: DataMesh(rank=0, size=2, group=object()))
    seen = []
    monkeypatch.setattr(train_cli, "validate",
                        lambda cfg, device, dataset, weights, mesh:
                        seen.append((cfg.mesh_axis_rays, mesh.size)))
    train_cli.main(["--device", "cpu", "--test", "dataset", "synthetic",
                    "mesh_axis_rays", "2", "trained_model_dir",
                    str(tmp_path)])
    assert seen == [(2, 2)]


def test_fewer_devices_than_the_key_asks_is_an_error(scene):
    pipe = scene[3]
    with pytest.raises(ValueError, match="mesh_axis_rays=3 but 2 devices"):
        run_cli.FrameRenderer(Config().merge_opts(["mesh_axis_rays", "3"]),
                              pipe, devices=["cpu", "cpu"])
