"""The evaluate and visualize slice: the port's metrics, evaluator, synthetic
eval items and evaluate_frames against the JAX package's on the same inputs
and bridged weights (a tiny model on the CPU), and the run entry point."""

import os

import cv2
import jax
import numpy as np
import pytest
import torch

from transhuman_tpu.cli.run import evaluate_frames as jax_evaluate_frames
from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.synthetic import SyntheticDataset as JDataset
from transhuman_tpu.evals import metrics as jmetrics
from transhuman_tpu.evals.evaluator import Evaluator as JEvaluator
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.testing import init_params, synthetic_setup
from tests.test_avi_writer import parse_avi
from transhuman_tpu_torch import kernels, weights
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.cli import train as train_cli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.loader import PREFETCH, WORKERS, Loader
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.evals import metrics
from transhuman_tpu_torch.evals.evaluator import Evaluator, bounding_rect
from transhuman_tpu_torch.geometry.clusters import normalize_positions
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.render.pipeline import RenderPipeline

HW, NV, NC, NS, EMBED, DEPTH, HEADS, K = 64, 400, 20, 8, 24, 1, 2, 4
OPTS = ["H", str(2 * HW), "W", str(2 * HW), "num_class", str(NC),
        "N_samples", str(NS), "vit_depth", str(DEPTH),
        "test.frame_interval", "4"]


@pytest.mark.parametrize("shape", [(7, 7, 3), (9, 13, 3), (31, 17, 3),
                                   (64, 51, 3), (7, 30)])
def test_metrics_equal_the_jax_package(shape):
    """psnr and ssim_multi against the JAX package's (whose box filter is
    cv2.blur), on crops down to the 7x7 window and odd sizes."""
    rng = np.random.default_rng(sum(shape))
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    got = metrics.ssim_multi(a, b, (2.0, 1.0))
    want = jmetrics.ssim_multi(a, b, (2.0, 1.0))
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    with pytest.raises(ValueError, match="smaller than"):
        metrics.ssim(a[:6], b[:6])


def _frame_inputs(rng, hw=(40, 48)):
    h, w = hw
    mask = np.zeros((h, w), bool)
    mask[5:33, 9:40] = True
    mask[5, 9] = mask[32, 39] = True
    mask = mask.reshape(-1)
    r = int(mask.sum())
    pred = rng.random((r, 3)).astype(np.float32)
    pred[:5] = [1.3, -0.2, 0.5]  # outside [0, 1]: clipped in the PNG
    gt = rng.random((r, 3)).astype(np.float32)
    inputs = rng.random((3, h, w, 3)).astype(np.float32)
    return pred, gt, mask, hw, inputs


def test_evaluator_files_equal_the_jax_evaluator(tmp_path):
    rng = np.random.default_rng(0)
    jev = JEvaluator(str(tmp_path / "jax"), exp_name="x", epoch=3)
    tev = Evaluator(str(tmp_path / "port"), exp_name="x", epoch=3)
    for frame in range(2):
        pred, gt, mask, hw, inputs = _frame_inputs(rng)
        for white in (False, True):
            kw = dict(human="h", frame_index=frame, cam_ind=int(white),
                      input_imgs=inputs, white_bkgd=white)
            want = jev.evaluate_frame(pred, gt, mask, hw, **kw)
            got = tev.evaluate_frame(pred, gt, mask, hw, **kw)
            assert got.keys() == want.keys() and got["lpips"] is None
            for k in ("mse", "psnr"):
                assert got[k] == want[k]
            assert got["ssim"] == pytest.approx(want["ssim"], abs=1e-12)
    want, got = jev.summarize(), tev.summarize()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == pytest.approx(v, abs=1e-12) if isinstance(
            v, float) else got[k] == v
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for name in ("mse", "psnr", "ssim", "lpips"):
        np.testing.assert_allclose(np.load(tdir / f"{name}.npy"),
                                   np.load(jdir / f"{name}.npy"), atol=1e-12)
    jtext = (jdir / "summary.txt").read_text().splitlines()
    ttext = (tdir / "summary.txt").read_text().splitlines()
    assert [x.split(":")[0] for x in ttext] == [x.split(":")[0] for x in jtext]
    for a, b in zip(ttext, jtext):
        try:
            assert float(a.split(": ")[1]) == pytest.approx(
                float(b.split(": ")[1]), abs=1e-12)
        except ValueError:
            assert a == b
    pngs = sorted(os.path.relpath(os.path.join(d, f), jdir)
                  for d, _, fs in os.walk(jdir) for f in fs
                  if f.endswith(".png"))
    assert len(pngs) == 2 * 2 * 2 + 2 * 3  # inputs: per frame, not view
    for rel in pngs:
        want_px = cv2.imread(str(jdir / rel), cv2.IMREAD_UNCHANGED)
        got_px = cv2.imread(str(tdir / rel), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(got_px, want_px, err_msg=rel)


def test_evaluator_refuses_degenerate_frames(tmp_path):
    ev = Evaluator(str(tmp_path))
    mask = np.zeros(20 * 20, bool)
    mask[:6] = True  # a 6x1 box, below the 7x7 window
    with pytest.raises(ValueError, match="degenerate eval frame"):
        ev.evaluate_frame(np.zeros((6, 3)), np.zeros((6, 3)), mask, (20, 20))
    assert ev.mse == []
    assert bounding_rect(np.zeros((4, 5), bool)) == (0, 0, 0, 0)
    m = np.zeros((4, 5), bool)
    m[1, 2] = m[3, 3] = True
    assert bounding_rect(m) == cv2.boundingRect(m.astype(np.uint8))


def test_loader_keeps_order_and_stops_early():
    seen = []

    def fetch(i):
        seen.append(i)
        return i * i

    assert list(Loader(fetch, range(9))) == [i * i for i in range(9)]
    seen.clear()
    it = iter(Loader(fetch, range(100)))
    assert next(it) == 0
    it.close()  # the consumer stops: nothing past the in-flight window runs
    assert len(seen) <= WORKERS + PREFETCH + 1


@pytest.fixture(scope="module")
def datasets():
    jdata = JDataset(JConfig().merge_opts(list(OPTS)), "test",
                     image_hw=(HW, HW), n_verts=NV)
    tdata = SyntheticDataset(Config().merge_opts(list(OPTS)), "test",
                             image_hw=(HW, HW), n_verts=NV)
    return jdata, tdata


def test_synthetic_eval_items_equal_the_jax_dataset(datasets):
    jdata, tdata = datasets
    want, got = jdata.get_eval_item(3), tdata.get_eval_item(3)
    for f in ("pix_idx", "mask_at_box", "rgb"):
        np.testing.assert_array_equal(getattr(got.eval_rays, f),
                                      getattr(want.eval_rays, f))
    for f in ("ray_o", "ray_d", "near", "far", "mask"):
        np.testing.assert_array_equal(
            getattr(got.eval_rays.rays, f).numpy(),
            np.asarray(getattr(want.eval_rays.rays, f)))
    for f in ("images", "K", "R", "T", "verts_world", "tar_verts_smpl"):
        np.testing.assert_array_equal(getattr(got.frame, f).numpy(),
                                      np.asarray(getattr(want.frame, f)))
    np.testing.assert_array_equal(got.target_img, want.target_img)
    np.testing.assert_array_equal(got.target_msk, want.target_msk)
    assert (got.human, got.human_idx, got.frame_index, got.cam_ind) == (
        want.human, want.human_idx, want.frame_index, want.cam_ind)
    assert got.eval_rays.pix_idx.size > 200
    for opts in ([], ["test.full_eval", "True"],
                 ["test.frame_interval", "3"],
                 ["test.sampler", "Other", "test.frame_interval", "3"]):
        j = JDataset.__new__(JDataset)
        j.cfg, j.n_frames = JConfig().merge_opts(opts), 8
        t = SyntheticDataset.__new__(SyntheticDataset)
        t.cfg, t.n_frames = Config().merge_opts(opts), 8
        for fe in (None, True, False):
            np.testing.assert_array_equal(t.frame_sampler_indices(fe),
                                          j.frame_sampler_indices(fe))


@pytest.fixture(scope="module")
def eval_runs(datasets, tmp_path_factory):
    """Both packages' evaluate_frames over the same 2 frames, with the same
    bridged weights and clusters: (per-frame (rgb, metrics) of JAX, of the
    port; the two summaries)."""
    jdata, tdata = datasets
    jmodel, _, jframe, jsmpl, _ = synthetic_setup(
        n_views=3, image_hw=(HW, HW), n_verts=NV, n_clusters=NC,
        n_samples=NS, chunk_rays=32, embed_dim=EMBED, vit_depth=DEPTH,
        vit_heads=HEADS, knn_k=K)
    params = init_params(jmodel, jframe, NC, jax.random.PRNGKey(0))
    table = weights.reference_pe_table(normalize_positions(
        jdata.cluster.pool_matrix @ jsmpl.v_template, 1.5), EMBED)
    jpipe = JPipeline(jmodel, jdata.cluster, jsmpl.v_template, n_samples=NS,
                      chunk_rays=32, pe_table=table)
    net = TransHumanNet(embed_dim=EMBED, vit_depth=DEPTH, vit_heads=HEADS,
                        knn_k=K)
    weights.load_reference_state_dict(net, weights.state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params["params"]), DEPTH))
    tpipe = RenderPipeline(net.eval(), tdata.cluster, tdata.smpl.v_template,
                           n_samples=NS, chunk_rays=32)
    out = tmp_path_factory.mktemp("eval")

    def collect(store, ev):
        def per_frame(item, o):
            store.append((item.frame_index, np.asarray(o["rgb_map"]),
                          ev.psnr[-1], ev.ssim[-1]))
            return {}
        return per_frame

    jev = JEvaluator(str(out / "jax"))
    tev = Evaluator(str(out / "port"))
    jframes, tframes = [], []
    jsum, _ = jax_evaluate_frames(
        JConfig().merge_opts(list(OPTS) + ["pad_bucket", "256"]), jpipe,
        params, jdata, jev, collect(jframes, jev))
    kernels.reset_launch_counts()
    tsum, _ = run_cli.evaluate_frames(Config().merge_opts(list(OPTS)), tpipe,
                                      tdata, tev, collect(tframes, tev))
    return jframes, tframes, jsum, tsum


def test_evaluate_frames_matches_the_jax_package(eval_runs):
    jframes, tframes, jsum, tsum = eval_runs
    assert [f[0] for f in tframes] == [f[0] for f in jframes] == [0, 4]
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
    for (_, jrgb, jpsnr, jssim), (_, trgb, tpsnr, tssim) in zip(jframes,
                                                              tframes):
        assert trgb.shape == jrgb.shape and np.isfinite(trgb).all()
        assert trgb.max() > 0.05  # the body is in view
        # tests/test_torch_serve.py's render tolerance
        np.testing.assert_allclose(trgb, jrgb, atol=2e-3)
        # what 2e-3 on each colour allows an MSE of ~0.1: ~0.05 dB
        assert tpsnr == pytest.approx(jpsnr, abs=0.05)
        assert tssim == pytest.approx(jssim, abs=2e-3)
    assert tsum["psnr"] == pytest.approx(jsum["psnr"], abs=0.05)
    assert tsum["ssim"] == pytest.approx(jsum["ssim"], abs=2e-3)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A checkpoint written by the train entry point on the CPU, under
    trained_model_dir/task/exp_name/latest.pth."""
    root = tmp_path_factory.mktemp("cli")
    opts = list(OPTS) + ["patch.size", "6", "patch.N_patches", "2",
                         "trained_model_dir", str(root / "tm"),
                         "result_dir", str(root / "res"),
                         "kmeans_dir", str(root / "none"),
                         "dataset", "synthetic", "ep_iter", "1",
                         "record_dir", str(root / "rec")]
    train_cli.main(["--device", "cpu", "--steps", "1", *opts])
    return root, opts


def test_run_entry_point_evaluates_and_visualizes(trained, capsys):
    root, opts = trained
    summary = run_cli.main(["--type", "evaluate", "--device", "cpu", *opts])
    assert np.isfinite(summary["psnr"]) and summary["epoch"] == 0
    out = root / "res" / "epoch_-1" / "debug"
    text = (out / "summary.txt").read_text()
    assert "lpips: n/a" in text and "ssim(data_range=1.0)" in text
    assert np.load(out / "psnr.npy").shape == (2,)  # frames 0 and 4 of 8
    for sub, name in (("pred", "frame4_view0.png"),
                      ("gt", "frame4_view0_gt.png"),
                      ("input", "frame4_t_0_view_2.png")):
        img = cv2.imread(str(out / "synthetic" / sub / name))
        assert img is not None and img.ndim == 3
    log = capsys.readouterr().out
    assert "[synthetic f4 c0] mse:" in log
    paths = run_cli.main(["--type", "visualize", "--device", "cpu", *opts])
    assert len(paths) == 8  # visualize renders every frame
    img = cv2.imread(paths[-1])
    assert img.shape == (HW, HW, 3) and img.any()
    # then the human's frames as one MJPG/AVI beside them, one per PNG
    avi = root / "res" / "epoch_-1" / "debug" / "perform" / "synthetic.avi"
    assert f"video: {avi}" in capsys.readouterr().out
    movie = parse_avi(str(avi))
    assert len(movie["frames"]) == len(movie["idx"]) == 8
    s, n = movie["frames"][-1]
    last = cv2.imdecode(np.frombuffer(movie["buf"][s:s + n], np.uint8),
                        cv2.IMREAD_COLOR)
    assert last.shape == img.shape
    assert np.abs(last.astype(int) - img.astype(int)).mean() < 4


def test_run_entry_point_fails_loudly(trained, tmp_path):
    _, opts = trained
    assert run_cli.parse_args([])[0].device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            run_cli.main(["--type", "evaluate", *opts])
    with pytest.raises(SystemExit, match="needs --ply"):
        run_cli.main(["--type", "light_stage", "--device", "cpu", *opts])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_cli.main(["--type", "evaluate", "--device", "cpu", "--weights",
                      str(tmp_path / "missing.pth"), *opts])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        run_cli.main(["--type", "evaluate", "--device", "cpu", *opts,
                      "test.epoch", "7"])
