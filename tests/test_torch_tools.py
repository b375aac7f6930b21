"""The port's remaining command-line tools and helpers against the JAX
package's on the same inputs (CPU): make_kmeans, data_fixes (rename313,
cleanmask, cleansmpl), the debug helpers, doctor (the four cases of
tests/test_doctor.py under --device cpu, and the card row without a card)
and the validate_official runbook on the JAX test's stand-ins."""

import json
import os
import pickle
import sys
import types

import cv2
import jax
import numpy as np
import pytest
import torch

from tests._torch_codings import encode_png
from tests.test_validate_official import (  # noqa: F401  (fixture reuse)
    _argv,
    _dataset_factory,
    _write_smpl_pickle,
    runbook_assets,
)
from tests.test_zju_data import fake_zju  # noqa: F401  (fixture reuse)
from transhuman_tpu.geometry.smpl import SMPLModel as JSMPLModel
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu.tools import data_fixes as jfixes
from transhuman_tpu.tools import make_kmeans as jkmeans
from transhuman_tpu.tools.validate_official import main as jax_runbook
from transhuman_tpu.utils import debug as jdebug
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.data import catalog
from transhuman_tpu_torch.geometry.clusters import ClusterSpec
from transhuman_tpu_torch.geometry.smpl import SMPLModel
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.tools import data_fixes, doctor, make_kmeans
from transhuman_tpu_torch.tools import validate_official as vo
from transhuman_tpu_torch.utils import debug


# ------------------------------------------------------------- make_kmeans
def test_make_kmeans_writes_the_jax_tools_file(tmp_path):
    _write_smpl_pickle(JSMPLModel.synthetic(n_verts=240), str(tmp_path / "s"))
    argv = ["--smpl_dir", str(tmp_path / "s"), "--num_clusters", "12",
            "--seed", "3"]
    jkmeans.main(argv + [str(tmp_path / "jax")])
    path = make_kmeans.main(argv + [str(tmp_path / "port")])
    assert path == str(tmp_path / "port" / "kmeans_dict_12.npy")
    want = (tmp_path / "jax" / "kmeans_dict_12.npy").read_bytes()
    assert open(path, "rb").read() == want
    spec = ClusterSpec.load_reference_dict(path)
    assert spec.num_clusters == 12
    smpl = SMPLModel.load(str(tmp_path / "s"))
    np.testing.assert_array_equal(
        spec.vert2cluster,
        ClusterSpec.from_kmeans(smpl.v_template, 12, seed=3).vert2cluster)


# -------------------------------------------------------------- data_fixes
LONG = "CoreView_313_1_Camera (3)_000042_2019.08.23_10:00:00.000"


def _layout_313(root):
    for rel, ext in (("Camera (3)", ".jpg"), ("mask/Camera (3)", ".png"),
                     ("mask_cihp/Camera (3)", ".png"),
                     ("Camera (4)", ".jpg"), ("other", ".jpg")):
        d = root / rel
        d.mkdir(parents=True)
        (d / (LONG + ext)).write_bytes(b"x")
        (d / "000001.jpg").write_bytes(b"y")  # already short: kept


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_rename313_renames_as_the_jax_tool(tmp_path):
    _layout_313(tmp_path / "jax")
    _layout_313(tmp_path / "port")
    assert data_fixes.rename_313_315(str(tmp_path / "port"),
                                     dry_run=True) == 4
    want = jfixes.rename_313_315(str(tmp_path / "jax"))
    got = data_fixes.main(["rename313", str(tmp_path / "port")])
    assert got == want == 4
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert (tmp_path / "port" / "mask" / "Camera (3)" / "000042.png").exists()


def _masks(root):
    rng = np.random.default_rng(0)
    for sub in ("mask/Camera_B1", "mask_cihp/Camera_B2"):
        (root / sub).mkdir(parents=True)
    m = (rng.random((20, 24)) > 0.6).astype(np.uint8)
    rgb = np.zeros((20, 24, 3), np.uint8)
    rgb[..., 0] = m * 255
    rgb[3:5, 3:9, 2] = 7  # a non-zero blue channel alone counts too
    cv2.imwrite(str(root / "mask/Camera_B1/000000.png"), rgb)
    rgba = np.concatenate([rgb, np.full((20, 24, 1), 255, np.uint8)], -1)
    cv2.imwrite(str(root / "mask_cihp/Camera_B2/000003.png"), rgba)
    cv2.imwrite(str(root / "mask/Camera_B1/000001.png"), m * 255)  # grey
    (root / "mask/Camera_B1/notes.txt").write_text("kept")


def test_cleanmask_gives_the_jax_tools_pixels(tmp_path):
    _masks(tmp_path / "jax")
    _masks(tmp_path / "port")
    assert data_fixes.clean_channel_masks(str(tmp_path / "port"),
                                          dry_run=True) == 2
    assert jfixes.clean_channel_masks(str(tmp_path / "jax")) == 2
    assert data_fixes.main(["cleanmask", str(tmp_path / "port")]) == 2
    pngs = [p for p in _tree(tmp_path / "jax") if p.endswith(".png")]
    assert len(pngs) == 3 and _tree(tmp_path / "port") == _tree(
        tmp_path / "jax")
    for rel in pngs:
        want = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(tmp_path / "port" / rel), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape and got.dtype == want.dtype, rel
        np.testing.assert_array_equal(got, want, err_msg=rel)
    assert cv2.imread(str(tmp_path / "port/mask/Camera_B1/000000.png"),
                      cv2.IMREAD_UNCHANGED).ndim == 2


def test_cleanmask_reads_adam7_masks_as_the_jax_tool(tmp_path):
    """An Adam7-interlaced RGB mask (cv2 reads it for the JAX tool, the
    port's own PNG reader for the port) is rewritten to the same pixels."""
    m = (np.random.default_rng(1).random((21, 26)) > 0.5).astype(np.uint8)
    rgb = np.zeros((21, 26, 3), np.uint8)
    rgb[..., 1] = m * 200
    data = encode_png(rgb, 8, 2, interlace=True)
    for tree in ("jax", "port"):
        (tmp_path / tree / "mask/Camera_B1").mkdir(parents=True)
        (tmp_path / tree / "mask/Camera_B1/000000.png").write_bytes(data)
    assert jfixes.clean_channel_masks(str(tmp_path / "jax")) == 1
    assert data_fixes.clean_channel_masks(str(tmp_path / "port")) == 1
    rel = "mask/Camera_B1/000000.png"
    want = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED)
    got = cv2.imread(str(tmp_path / "port" / rel), cv2.IMREAD_UNCHANGED)
    assert got.shape == want.shape == (21, 26) and want.max() == 1
    np.testing.assert_array_equal(got, want)


def _chumpy_pickle(path):
    """A pickle whose stream references chumpy.ch.Ch, as a raw SMPL
    download's does, written with a stand-in chumpy module."""
    mod, sub = types.ModuleType("chumpy"), types.ModuleType("chumpy.ch")

    class Ch:
        def __init__(self, x):
            self.x = x

    Ch.__module__, Ch.__qualname__ = "chumpy.ch", "Ch"
    sub.Ch = mod.Ch = Ch
    mod.ch = sub
    sys.modules["chumpy"], sys.modules["chumpy.ch"] = mod, sub
    try:
        with open(path, "wb") as f:
            pickle.dump({"v_template": Ch(np.arange(12.0).reshape(4, 3)),
                         "f": np.zeros((2, 3)), "kintree_table":
                         np.arange(6).reshape(2, 3)}, f)
    finally:
        del sys.modules["chumpy"], sys.modules["chumpy.ch"]


def test_cleansmpl_gives_the_jax_tools_pickle(tmp_path):
    src = tmp_path / "SMPL_NEUTRAL.pkl"
    _chumpy_pickle(src)
    want_path = jfixes.clean_smpl_pickle(str(src), str(tmp_path / "jax"))
    got_path = data_fixes.main(["cleansmpl", str(src),
                                str(tmp_path / "port")])
    assert os.path.basename(got_path) == "SMPL_NEUTRAL.pkl"
    with open(want_path, "rb") as f:
        want = pickle.load(f)
    with open(got_path, "rb") as f:
        got = pickle.load(f)
    assert got.keys() == want.keys()
    for k in want:
        assert type(got[k]) is np.ndarray
        np.testing.assert_array_equal(got[k], want[k])


# ------------------------------------------------------------------ debug
def test_save_point_cloud_writes_the_jax_writers_bytes(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((10, 3)).astype(np.float32)
    rgb = rng.integers(-20, 300, (10, 3))  # clipped to [0, 255]
    for tag, colour in (("plain", None), ("rgb", rgb)):
        jdebug.save_point_cloud(str(tmp_path / f"j_{tag}.ply"), pts,
                                rgb=colour)
        debug.save_point_cloud(str(tmp_path / f"t_{tag}.ply"),
                               torch.from_numpy(pts), rgb=colour)
        assert (tmp_path / f"t_{tag}.ply").read_bytes() == (
            tmp_path / f"j_{tag}.ply").read_bytes()
    assert "uchar red" in (tmp_path / "t_rgb.ply").read_text()


def test_param_count_equals_the_jax_count():
    """On the JAX model's parameter tree (its shapes, traced without a
    compile) and the port's model holding those weights."""
    jmodel, _, jframe, _, _ = synthetic_setup(
        n_views=3, image_hw=(24, 24), n_verts=100, n_clusters=10,
        n_samples=8, chunk_rays=8, embed_dim=12, vit_depth=1, vit_heads=2,
        knn_k=3)
    shapes = jax.eval_shape(
        lambda: init_params(jmodel, jframe, 10, jax.random.PRNGKey(0)))
    params = jax.tree_util.tree_map(
        lambda x: np.ones(x.shape, x.dtype), shapes)
    net = TransHumanNet(embed_dim=12, vit_depth=1, vit_heads=2, knn_k=3)
    weights.load_reference_state_dict(net, weights.state_dict_from_jax(
        params["params"], 1))
    want = jdebug.param_count(params)
    assert want > 1000
    assert debug.param_count(net) == want
    assert debug.param_count(params) == want
    assert debug.param_count({"a": np.zeros((3, 4)),
                              "b": {"c": torch.zeros(5)}}) == 17


# ----------------------------------------------------------------- doctor
def _fake_catalog(monkeypatch, info):
    monkeypatch.setattr(catalog, "get_human_info",
                        lambda split, mode="": dict(info))


def _doctor(*opts):
    return doctor.main(["--device", "cpu", *opts,
                        "test.input_view", "[0, 1]",
                        "test.target_view", "[2]"])


def test_doctor_passes_on_fake_dataset(fake_zju, monkeypatch,  # noqa: F811
                                       capsys):
    cfg0, _, info = fake_zju
    _fake_catalog(monkeypatch, info)
    rc = _doctor("data_root", cfg0.data_root,
                 "rasterize_root", cfg0.rasterize_root, "ratio", "0.5")
    out = capsys.readouterr().out
    assert rc == 0, out
    for row in ("[PASS] g++", "[PASS] host-library build",
                "[PASS] dataset humans", "[PASS] annots",
                "[PASS] sample frame", "[PASS] vizmaps",
                # absent but recoverable, or not needed on the CPU: warned
                "[WARN] SMPL model", "[WARN] k-means dict",
                "[WARN] kernel build"):
        assert row in out, row
    if not torch.cuda.is_available():
        assert "[WARN] CUDA card" in out


def test_doctor_fails_without_dataset(tmp_path, capsys):
    rc = _doctor("data_root", str(tmp_path / "nope"))
    out = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] dataset root" in out


def test_doctor_fails_on_missing_eval_checkpoint(fake_zju,  # noqa: F811
                                                 monkeypatch, capsys,
                                                 tmp_path):
    """run_mode test needs a checkpoint: WARN becomes FAIL."""
    cfg0, _, info = fake_zju
    _fake_catalog(monkeypatch, info)
    rc = _doctor("data_root", cfg0.data_root,
                 "rasterize_root", cfg0.rasterize_root, "run_mode", "test",
                 "trained_model_dir", str(tmp_path / "none"))
    out = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] checkpoint" in out


@pytest.mark.parametrize("name", ["ep5.ckpt", "3.pth"])
def test_doctor_accepts_epoch_only_checkpoints(fake_zju,  # noqa: F811
                                               monkeypatch, capsys,
                                               tmp_path, name):
    """A model dir holding only an epoch's checkpoint (the JAX package's
    ep{N}.ckpt, or the port's {N}.pth) is loadable: find_checkpoint picks
    the highest epoch, so doctor does not FAIL it."""
    cfg0, _, info = fake_zju
    _fake_catalog(monkeypatch, info)
    mdir = tmp_path / "model" / "transhuman" / "default"
    mdir.mkdir(parents=True)
    (mdir / name).write_bytes(b"stub")
    rc = _doctor("data_root", cfg0.data_root,
                 "rasterize_root", cfg0.rasterize_root, "run_mode", "test",
                 "trained_model_dir", str(tmp_path / "model"),
                 "exp_name", "default")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "[PASS] checkpoint" in out and name in out


def test_doctor_fails_the_card_rows_without_a_card(fake_zju,  # noqa: F811
                                                   monkeypatch, capsys,
                                                   tmp_path):
    """On the card route (the default) no card is a FAIL, and so is a
    kernel build without nvcc; the depth maps depth_vizmap reads are a
    FAIL when absent."""
    from transhuman_tpu_torch.kernels import build as kbuild

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    cfg0, _, info = fake_zju
    _fake_catalog(monkeypatch, info)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(kbuild, "find_nvcc", no_nvcc)
    rc = doctor.main(["data_root", cfg0.data_root,
                      "rasterize_root", cfg0.rasterize_root,
                      "test.input_view", "[0, 1]", "test.target_view", "[2]",
                      "depth_map", "True", "depth_vizmap", "True",
                      "depth_root", str(tmp_path / "no_depth")])
    out = capsys.readouterr().out
    assert rc == 1
    for row in ("[FAIL] CUDA card", "[FAIL] nvcc", "[FAIL] kernel build",
                "[FAIL] depth maps", "[PASS] annots"):
        assert row in out, row
    assert "nvcc not found" in out


# -------------------------------------------------------- validate_official
def test_compare_fails_on_unmatched_expected_protocol():
    """An --expected protocol that matched no run FAILs loudly, not PASS
    with no comparison made (a typo'd protocol name)."""
    rows, ok = vo.compare(
        {"fitting": {"psnr": 30.0, "ssim": 0.95, "lpips": None, "mse": 1e-3}},
        {"identity_generalisation": {"psnr": 24.8}},  # note the typo
        vo.DEFAULT_TOL)
    assert not ok
    bad = [r for r in rows if r.get("verdict") == "FAIL"]
    assert bad and "was not run" in bad[0]["error"]


def test_expected_template_schema():
    """The committed --expected template parses, its '_' keys are skipped,
    its 0.0 placeholders FAIL if passed unedited, a filled-in copy
    passes; the protocols and tolerances are the JAX tool's."""
    from transhuman_tpu.tools import validate_official as jvo

    assert vo.PROTOCOLS == jvo.PROTOCOLS and vo.DEFAULT_TOL == jvo.DEFAULT_TOL
    with open(os.path.join(os.path.dirname(__file__), "..", "configs",
                           "expected_official.template.json")) as f:
        tpl = json.load(f)
    labels = {k for k in tpl if not k.startswith("_")}
    assert labels == {r[0] for r in vo.PROTOCOLS}
    summaries = {lab: {"psnr": 30.0, "ssim": 0.95, "lpips": 0.08, "mse": 1e-3}
                 for lab in labels}
    rows, ok = vo.compare(summaries, tpl, vo.DEFAULT_TOL)
    assert not ok
    assert not any(r["protocol"].startswith("_") for r in rows)
    assert (rows, ok) == jvo.compare(summaries, tpl, jvo.DEFAULT_TOL)
    rows, ok = vo.compare(summaries, {lab: dict(summaries[lab])
                                      for lab in labels}, vo.DEFAULT_TOL)
    assert ok


def _port_dataset_factory(smpl_dir, info):
    def factory(run_argv):
        from transhuman_tpu_torch.cli.common import parse_args
        from transhuman_tpu_torch.data.zju import ZJUDataset

        _, cfg = parse_args(run_argv, need_type=True)
        return ZJUDataset(cfg, "test", smpl=SMPLModel.load(smpl_dir),
                          human_info=info)

    return factory


def test_runbook_matches_the_jax_runbook(runbook_assets,  # noqa: F811
                                         tmp_path):
    """The port's runbook on the JAX test's stand-ins (the official-layout
    .pth, SMPL pickle, k-means dict, VGG16 and lin heads) on the CPU, with
    the JAX runbook's numbers as --expected: the protocol run PASSes
    within DEFAULT_TOL, which are the eval parity bounds (PSNR 0.05 dB,
    SSIM and LPIPS 2e-3); an expected protocol that was not run FAILs, so
    the exit code is 1.  Both run in float32: the config of record
    computes in bf16, where the JAX package also culls in bf16 and the
    port in float32 (PERF.md section 4).  The port decodes in chunks of
    4,096 points: its compaction is exact, so the chunk changes no
    result."""
    cfg0, smpl, info, root, lins = runbook_assets

    def argv(work, extra=()):
        return _argv(cfg0, root, lins, work, extra) + ["compute_dtype",
                                                       "float32"]

    assert jax_runbook(argv(tmp_path / "jax"),
                       dataset_factory=_dataset_factory(smpl, info)) == 0
    (want,) = json.loads(
        (tmp_path / "jax" / "parity_report.json").read_text())["results"]
    expected = tmp_path / "expected.json"
    expected.write_text(json.dumps({
        want["protocol"]: {k: want[k] for k in ("psnr", "ssim", "lpips")},
        "fitting": {"psnr": want["psnr"]}}))
    work = tmp_path / "port"
    rc = vo.main(argv(work, ("--device", "cpu", "--expected",
                             str(expected))) + ["chunk_size", "4096"],
                 dataset_factory=_port_dataset_factory(str(root / "smpl"),
                                                       info))
    report = json.loads((work / "parity_report.json").read_text())
    rows = {r["protocol"]: r for r in report["results"]}
    assert rc == 1
    assert report["lpips"] is True and report["device"] == "cpu"
    assert (work / "lpips_vgg.npz").exists()
    row = rows["identity_generalization"]
    assert row["verdict"] == "PASS", row
    assert abs(row["psnr"] - want["psnr"]) <= 0.05
    assert rows["fitting"]["verdict"] == "FAIL"
    assert "was not run" in rows["fitting"]["error"]
    text = (work / "parity_report.txt").read_text().splitlines()
    assert text[0] == "fitting:   [FAIL]"
    assert text[1].startswith("identity_generalization: psnr=")
    assert text[1].endswith("[PASS]")
