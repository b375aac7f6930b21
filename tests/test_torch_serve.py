"""The serving slice as a whole: one render request through the JAX package's
RenderService (dense render, compact_ratio=None) and through the PyTorch
port's RenderService on the CPU, with the same scene, the same bridged
weights and the same reference PE table; then the port's HTTP server."""

import io
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.serve import RenderService as JService
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu_torch import kernels, serve, weights
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.geometry.clusters import (
    ClusterSpec,
    normalize_positions,
)
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.kernels import build as kbuild
from transhuman_tpu_torch.kernels.dparf import dparf_cuda
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.render.pipeline import RenderPipeline
from transhuman_tpu_torch.serve import (
    RenderServer,
    RenderService,
    RequestError,
    parse_render_request,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW, V, NV, NC, NS, EMBED, DEPTH, HEADS, K = 32, 3, 120, 12, 8, 24, 2, 2, 4
OPTS = ["H", str(2 * HW), "W", str(2 * HW), "ratio", "0.5"]


def _request(frame, target=1):
    return {
        "images": np.asarray(frame.images), "K": np.asarray(frame.K),
        "R": np.asarray(frame.R), "T": np.asarray(frame.T),
        "verts_world": np.asarray(frame.verts_world),
        "blend_rot": np.asarray(frame.blend_rot),
        "tK": np.asarray(frame.K[target]), "tR": np.asarray(frame.R[target]),
        "tT": np.asarray(frame.T[target]), "H": HW, "W": HW,
    }


@pytest.fixture(scope="module")
def scene():
    jmodel, _, frame, jsmpl, jcluster = synthetic_setup(
        n_views=V, image_hw=(HW, HW), n_verts=NV, n_clusters=NC,
        n_samples=NS, chunk_rays=8, embed_dim=EMBED, vit_depth=DEPTH,
        vit_heads=HEADS, knn_k=K,
    )
    params = init_params(jmodel, frame, NC, jax.random.PRNGKey(0))
    table = weights.reference_pe_table(normalize_positions(
        jcluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
    jpipe = JPipeline(jmodel, jcluster, jsmpl.v_template, n_samples=NS,
                      chunk_rays=8, pe_table=table)
    jsvc = JService(JConfig().merge_opts(["pad_bucket", "64"] + OPTS), jpipe,
                    params, jsmpl)

    tnet = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                         knn_k=K)
    weights.load_reference_state_dict(tnet, weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH))
    smpl = SMPLModel.synthetic(n_verts=NV)
    cluster = ClusterSpec(jcluster.vert2cluster, NC)
    # the port computes the same reference table from the same clusters
    pipe = RenderPipeline(tnet.eval(), cluster, smpl.v_template,
                          n_samples=NS, chunk_rays=8)
    np.testing.assert_array_equal(pipe.pe_can.numpy(), table)
    svc = RenderService(Config().merge_opts(OPTS), pipe, smpl)
    return jsvc, svc, frame


@pytest.fixture(scope="module")
def renders(scene):
    jsvc, svc, frame = scene
    kernels.reset_launch_counts()
    req = _request(frame)
    return jsvc.render(req), svc.render(req)


def test_render_matches_the_jax_service(renders):
    want, got = renders
    for key in ("rgb", "depth", "acc"):
        assert got[key].shape == want[key].shape
        assert np.isfinite(got[key]).all()
    assert got["acc"].max() > 0.05  # the body is in view
    np.testing.assert_allclose(got["rgb"], want["rgb"], atol=2e-3)
    np.testing.assert_allclose(got["acc"], want["acc"], atol=2e-3)
    np.testing.assert_allclose(got["depth"], want["depth"], atol=1e-2)


def test_cpu_render_never_launches_a_cuda_kernel(scene, renders):
    assert kernels.launch_counts() == {"min_excess2": 0, "dparf": 0,
                                       "dfeat_scatter": 0,
                                       "feature_gather": 0, "dparf_bf16": 0,
                                       "dfeat_scatter_bf16": 0,
                                       "feature_sample_bf16": 0}
    assert not kbuild.loaded()
    pipe = scene[1].pipe
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dparf_cuda(x, x, torch.zeros(4, 3, 3), torch.zeros(1, 4, 8), k=2)
    assert 0 < pipe.last_frame_stats["survivors"] < pipe.last_frame_stats[
        "points"]


def test_smpl_params_request_equals_explicit_verts(scene, renders):
    _, svc, frame = scene
    req = _request(frame)
    del req["verts_world"], req["blend_rot"]
    req["poses"], req["shapes"] = np.zeros(72), np.zeros(10)
    np.testing.assert_allclose(svc.render(req)["rgb"], renders[1]["rgb"],
                               atol=1e-6)


@pytest.mark.parametrize("drop, msg", [("images", "images"), ("tK", "tK"),
                                       ("blend_rot", "verts_world")])
def test_bad_requests_are_request_errors(scene, drop, msg):
    _, svc, frame = scene
    req = _request(frame)
    del req[drop]
    if drop == "blend_rot":
        del req["verts_world"]
    with pytest.raises(RequestError, match=msg):
        parse_render_request(req, svc.cfg, svc.smpl)


def test_http_roundtrip(scene, renders):
    _, svc, frame = scene
    server = RenderServer(svc, port=0)
    server.start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        health = json.loads(urllib.request.urlopen(base + "/healthz",
                                                   timeout=30).read())
        assert health["status"] == "ok" and health["n_params"] > 0
        buf = io.BytesIO()
        np.savez(buf, **_request(frame))
        reply = urllib.request.urlopen(urllib.request.Request(
            base + "/render", data=buf.getvalue()), timeout=120)
        out = dict(np.load(io.BytesIO(reply.read())))
        np.testing.assert_allclose(out["rgb"], renders[1]["rgb"], atol=1e-6)
        png = urllib.request.urlopen(urllib.request.Request(
            base + "/render?format=png", data=buf.getvalue()), timeout=120)
        assert png.headers["Content-Type"] == "image/png"
        assert png.read()[:8] == b"\x89PNG\r\n\x1a\n"
        stats = json.loads(urllib.request.urlopen(base + "/stats",
                                                  timeout=30).read())
        assert stats["renders"] >= 2 and stats["latency_ms"]["p50"] > 0
        bad = urllib.request.Request(base + "/render", data=b"not an npz")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(bad, timeout=30)
        assert ei.value.code == 400
    finally:
        server.shutdown()


def test_serve_main_loads_weights_and_answers(tmp_path):
    """`python -m transhuman_tpu_torch.serve --weights w.pth` end to end on
    the CPU: strict load of a reference-layout .pth, then one request whose
    body is given as SMPL parameters."""
    opts = ["vit_depth", "1", "num_class", "12", "N_samples", "4"]
    cfg = Config().merge_opts(opts)
    net = TransHumanNet.from_config(cfg)
    torch.save({"net": net.state_dict(), "epoch": 3}, tmp_path / "w.pth")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.Popen(
        [sys.executable, "-m", "transhuman_tpu_torch.serve", "--weights",
         str(tmp_path / "w.pth"), "--device", "cpu", "--port", "0",
         "--no_warmup", *opts],
        cwd=tmp_path, env=env, stderr=subprocess.PIPE, text=True,
    )
    watchdog = threading.Timer(120, proc.kill)  # a hung server fails the test
    watchdog.start()
    try:
        url = None
        for line in proc.stderr:  # blocks until the server says where it is
            if "listening on" in line:
                url = line.split()[3]
                break
        assert url, "server exited before listening"
        K = np.array([[30, 0, 16], [0, 30, 16], [0, 0, 1]], np.float32)
        req = {"images": np.zeros((3, 32, 32, 3), np.float32),
               "K": np.tile(K, (3, 1, 1)),
               "R": np.tile(np.eye(3, dtype=np.float32), (3, 1, 1)),
               "T": np.tile(np.float32([0, 0, 2.5]), (3, 1)),
               "poses": np.zeros(72), "shapes": np.zeros(10),
               "tK": K, "tR": np.eye(3, dtype=np.float32),
               "tT": np.float32([0, 0, 2.5]), "H": 32, "W": 32}
        buf = io.BytesIO()
        np.savez(buf, **req)
        reply = urllib.request.urlopen(urllib.request.Request(
            url + "/render", data=buf.getvalue()), timeout=120)
        out = dict(np.load(io.BytesIO(reply.read())))
        assert out["rgb"].shape == (32, 32, 3) and np.isfinite(out["rgb"]).all()
        health = json.loads(urllib.request.urlopen(url + "/healthz",
                                                   timeout=30).read())
        assert health["devices"] == ["cpu"]
        assert health["n_params"] == sum(p.numel() for p in net.parameters())
    finally:
        watchdog.cancel()
        proc.terminate()
        proc.wait(timeout=30)


def test_full_queue_is_503_and_shutdown_is_bounded(scene, monkeypatch):
    _, svc, frame = scene
    monkeypatch.setattr(serve, "ENQUEUE_WAIT_S", 0.1)
    server = RenderServer(svc, port=0, max_queue=1)
    # only the HTTP thread: a worker that never starts keeps the queue full
    threading.Thread(target=server.httpd.serve_forever, daemon=True).start()
    fut1 = server.submit(_request(frame))
    buf = io.BytesIO()
    np.savez(buf, **_request(frame))
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(urllib.request.Request(
            f"http://127.0.0.1:{server.port}/render", data=buf.getvalue()),
            timeout=60)
    assert ei.value.code == 503 and ei.value.headers["Retry-After"] == "30"
    assert fut1.cancel()
    server.shutdown()
    assert fut1.cancelled()


class _StubService:
    """Records the executor's calls; renders nothing."""

    def __init__(self):
        self.calls = []
        self.latencies_ms = []

    def dispatch(self, arrays):
        self.calls.append(f"dispatch{arrays['i']}")
        return arrays["i"]

    def fetch(self, i):
        self.calls.append(f"fetch{i}")
        return {"i": i}


def test_executor_fetches_each_request_before_taking_the_next():
    """Two requests queued before the executor starts: request 0 is fetched
    (its reply delivered) before request 1 is dispatched."""
    stub = _StubService()
    server = RenderServer(stub, port=0)
    futs = [server.submit({"i": i}) for i in range(2)]
    server.start()
    try:
        assert [f.result(timeout=30) for f in futs] == [{"i": 0}, {"i": 1}]
    finally:
        server.shutdown()
    assert stub.calls == ["dispatch0", "fetch0", "dispatch1", "fetch1"]
    assert len(stub.latencies_ms) == 2
