"""The train loop's lifecycle in the port against the JAX package on the CPU:
a JAX ``.ckpt`` read without JAX, epoch saves and resume, the pretrained
encoder, the Recorder's streams, the prefetching loader and the ``--test``
validation pass; end to end, the JAX train entry point trains epoch 0 from
configs/train_or_eval.yaml and the port resumes from its ``ep0.ckpt`` and
trains epoch 1 as the JAX package does."""

import json
import os
import pickle
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from transhuman_tpu.cli import train as jtrain_cli
from transhuman_tpu.config import Config as JConfig
from transhuman_tpu.data.synthetic import SyntheticDataset as JDataset
from transhuman_tpu.models.lpips import init_lpips_params
from transhuman_tpu.testing import init_params, synthetic_setup
from transhuman_tpu.train import checkpoint as jckpt
from transhuman_tpu.train import step as jstep
from transhuman_tpu.utils import tb_writer as jtb
from transhuman_tpu.utils.recorder import Recorder as JRecorder
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.cli import run as run_cli
from transhuman_tpu_torch.cli import train as train_cli
from transhuman_tpu_torch.config import Config
from transhuman_tpu_torch.data.loader import Loader
from transhuman_tpu_torch.data.synthetic import SyntheticDataset
from transhuman_tpu_torch.models.network import TransHumanNet
from transhuman_tpu_torch.train import checkpoint as tckpt
from transhuman_tpu_torch.train import step as tstep
from transhuman_tpu_torch.utils.recorder import Recorder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_FILE = os.path.join(ROOT, "configs", "train_or_eval.yaml")


# ------------------------------------------------------ the JAX .ckpt
@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A JAX package checkpoint after one Adam update (non-zero moments),
    with a PE table, written by its own save_checkpoint."""
    root = tmp_path_factory.mktemp("jckpt")
    depth, nc = 1, 8
    jmodel, _, frame, _, _ = synthetic_setup(
        n_views=2, image_hw=(32, 32), n_verts=64, n_clusters=nc, n_samples=4,
        embed_dim=12, vit_depth=depth, vit_heads=2, knn_k=3)
    params = init_params(jmodel, frame, nc, jax.random.PRNGKey(0))
    tx, _ = jstep.make_optimizer(iters_per_epoch=4)
    state = jstep.init_state(params, tx)
    grads = jax.tree_util.tree_map(
        lambda p: np.random.default_rng(p.size).standard_normal(
            p.shape).astype(np.float32), params)
    upd, opt_state = tx.update(grads, state.opt_state, params)
    pe = np.random.default_rng(1).random((nc, 12)).astype(np.float32)
    payload = {"params": params, "opt_state": opt_state, "step": 5,
               "recorder": {"step": 5, "epoch": 1}, "pe_table": pe}
    jckpt.save_checkpoint(str(root), payload, 1, save_epoch_copy=True)
    jckpt.save_checkpoint(str(root / "wonly"), {"params": params}, 2)
    return dict(root=root, params=params, opt_state=opt_state, pe=pe,
                depth=depth)


_READ_PROBE = r"""
import sys, torch

class _Blocked:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "flax", "optax", "transhuman_tpu",
                                  "yaml"):
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, _Blocked())
from transhuman_tpu_torch.train.checkpoint import read_checkpoint
ck = read_checkpoint(sys.argv[1], int(sys.argv[2]))
torch.save(ck, sys.argv[3])
"""


def test_jax_ckpt_is_read_without_jax(jax_ckpt, tmp_path):
    """Read in a process where JAX, Flax, Optax and the JAX package cannot
    be imported: the parameters bit for bit through the bridge, Adam's
    moments likewise, the count, step, epoch, recorder and PE table."""
    out = str(tmp_path / "read.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "-c", _READ_PROBE,
         str(jax_ckpt["root"] / "ep1.ckpt"), str(jax_ckpt["depth"]), out],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    ck = torch.load(out, weights_only=False)
    d = jax_ckpt["depth"]
    np_tree = jax.tree_util.tree_map(np.asarray, jax_ckpt["params"])
    want = weights.state_dict_from_jax(np_tree["params"], d)
    assert ck["net"].keys() == want.keys()
    for k in want:
        torch.testing.assert_close(ck["net"][k], want[k], rtol=0, atol=0)
    adam = jax_ckpt["opt_state"][1][0]
    for name, tree in (("mu", adam.mu), ("nu", adam.nu)):
        w = weights.live_state_dict(weights.state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, tree)["params"], d))
        assert ck["jax_optim"][name].keys() == w.keys()
        for k in w:
            torch.testing.assert_close(ck["jax_optim"][name][k], w[k],
                                       rtol=0, atol=0)
    assert ck["jax_optim"]["count"] == 1
    assert (ck["step"], ck["epoch"], ck["recorder"]) == (
        5, 1, {"step": 5, "epoch": 1})
    np.testing.assert_array_equal(ck["pe_table"], jax_ckpt["pe"])
    assert ck["optim"] is None


def test_restore_places_adam_and_the_schedule(jax_ckpt):
    """torch Adam gets the moments and optax's count as its step; the next
    update uses lr(count), as optax's schedule does."""
    d = jax_ckpt["depth"]
    ck = tckpt.read_checkpoint(str(jax_ckpt["root"] / "latest.ckpt"), d)
    net = TransHumanNet(embed_dim=12, vit_depth=d, vit_heads=2, knn_k=3)
    opt, sched = tstep.make_optimizer(net.parameters(), iters_per_epoch=4)
    state = tstep.TrainState(net, opt, sched)
    tckpt.restore(state, ck)
    assert state.step == 5
    names = [n for n, _ in net.named_parameters()]
    st = opt.state_dict()["state"]
    for i, n in enumerate(names):
        assert float(st[i]["step"]) == 1.0
        torch.testing.assert_close(st[i]["exp_avg"], ck["jax_optim"]["mu"][n],
                                   rtol=0, atol=0)
    _, schedule = jstep.make_optimizer(iters_per_epoch=4)
    assert opt.param_groups[0]["lr"] == pytest.approx(float(schedule(1)),
                                                      rel=1e-6)
    assert sched.last_epoch == 1
    # a weights-only checkpoint starts Adam fresh, with the JAX message
    wo = tckpt.read_checkpoint(str(jax_ckpt["root"] / "wonly" / "ep2.ckpt"),
                               d)
    assert wo["jax_optim"] is None and wo["epoch"] == 2


def test_weights_only_ckpt_starts_the_optimizer_fresh(jax_ckpt, capsys):
    d = jax_ckpt["depth"]
    wo = tckpt.read_checkpoint(str(jax_ckpt["root"] / "wonly" /
                                   "latest.ckpt"), d)
    net = TransHumanNet(embed_dim=12, vit_depth=d, vit_heads=2, knn_k=3)
    opt, sched = tstep.make_optimizer(net.parameters(), iters_per_epoch=4)
    state = tstep.TrainState(net, opt, sched)
    tckpt.restore(state, wo)
    assert "starting optimizer state fresh" in capsys.readouterr().out
    assert opt.state_dict()["state"] == {} and state.step == 0


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("payload", [_Evil(), {"params": _Evil()}])
def test_a_pickle_naming_another_global_is_refused(tmp_path, payload):
    path = tmp_path / "latest.ckpt"
    path.write_bytes(pickle.dumps(payload))
    with pytest.raises(pickle.UnpicklingError, match="refusing global"):
        tckpt.load_jax_ckpt(str(path))


def test_find_checkpoint_prefers_the_ports_then_the_jax_files(tmp_path):
    d = str(tmp_path)
    assert tckpt.find_checkpoint(d) is None
    for name in ("ep3.ckpt", "ep12.ckpt"):
        (tmp_path / name).write_bytes(b"")
    assert tckpt.find_checkpoint(d) == os.path.join(d, "ep12.ckpt")
    (tmp_path / "latest.ckpt").write_bytes(b"")
    assert tckpt.find_checkpoint(d) == os.path.join(d, "latest.ckpt")
    (tmp_path / "4.pth").write_bytes(b"")
    (tmp_path / "10.pth").write_bytes(b"")
    assert tckpt.find_checkpoint(d) == os.path.join(d, "10.pth")
    (tmp_path / "latest.pth").write_bytes(b"")
    assert tckpt.find_checkpoint(d) == os.path.join(d, "latest.pth")
    assert tckpt.find_checkpoint(d, 3) == os.path.join(d, "ep3.ckpt")
    assert tckpt.find_checkpoint(d, 4) == os.path.join(d, "4.pth")
    assert tckpt.find_checkpoint(d, 5) is None


# --------------------------------------------------- the port's lifecycle
TINY = ["--device", "cpu", "dataset", "synthetic", "H", "32", "W", "32",
        "num_class", "12", "vit_depth", "1", "N_samples", "4", "patch.size",
        "4", "patch.N_patches", "2", "ep_iter", "2", "kmeans_dir", "none"]


def _dirs(root):
    return ["trained_model_dir", str(root / "tm"), "record_dir",
            str(root / "rec"), "result_dir", str(root / "res")]


def _mdir(root):
    return root / "tm" / "transhuman" / "transhuman_tpu"


def test_epoch_saves_follow_save_freq(tmp_path):
    state, records = train_cli.main(TINY + _dirs(tmp_path) + [
        "train.epoch", "3", "save_freq", "2"])
    assert sorted(os.listdir(_mdir(tmp_path))) == ["1.pth", "latest.pth"]
    assert [r["step"] for r in records] == list(range(6))
    assert [("save_s" in r) for r in records] == [False, True] * 3
    blob = torch.load(_mdir(tmp_path) / "latest.pth", weights_only=True)
    assert set(blob) == {"net", "optim", "scheduler", "epoch", "step",
                         "recorder"}
    assert (blob["epoch"], blob["step"]) == (2, 6)
    assert blob["recorder"] == {"step": 5, "epoch": 2}
    for n, p in state.model.state_dict().items():
        assert torch.equal(blob["net"][n], p), n
    one = torch.load(_mdir(tmp_path) / "1.pth", weights_only=True)
    assert (one["epoch"], one["step"]) == (1, 4)


def test_resume_continues_bit_for_bit(tmp_path):
    """Two epochs in one run, against one epoch and a resumed second: the
    same losses and, after it, the same parameters and Adam state, bit for
    bit; the resumed run starts at epoch 1 with the step and lr carried."""
    whole, recs = train_cli.main(TINY + _dirs(tmp_path / "a") + [
        "train.epoch", "2"])
    cut = TINY + _dirs(tmp_path / "b")
    train_cli.main(cut + ["train.epoch", "1"])
    part, recs_b = train_cli.main(cut + ["train.epoch", "2"])
    assert [r["step"] for r in recs_b] == [2, 3]
    assert part.step == whole.step == 4
    for a, b in zip(recs[2:], recs_b):
        assert (a["loss"], a["lr"]) == (b["loss"], b["lr"])
    for (n, a), b in zip(whole.model.state_dict().items(),
                         part.model.state_dict().values()):
        assert torch.equal(a, b), n
    sa, sb = (s.optimizer.state_dict()["state"] for s in (whole, part))
    for i in sa:
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)
    # resume off: a fresh start over the same directory
    fresh, recs_c = train_cli.main(cut + ["train.epoch", "1", "resume",
                                          "False"])
    assert recs_c[0]["step"] == 0 and recs_c[0]["loss"] == recs[0]["loss"]


def test_specified_resume_to_a_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="specified_resume"):
        train_cli.main(TINY + _dirs(tmp_path) + [
            "specified_resume", str(tmp_path / "nope.pth")])
    assert not os.path.exists(_mdir(tmp_path))


def test_lpips_and_encoder_files_that_are_missing_are_errors(tmp_path):
    with pytest.raises(FileNotFoundError):
        train_cli.main(TINY + _dirs(tmp_path) + [
            "lpips_weights", str(tmp_path / "nope.npz")])
    with pytest.raises(FileNotFoundError):
        train_cli.main(TINY + _dirs(tmp_path) + [
            "encoder_weights", str(tmp_path / "nope.npz")])


def test_pretrained_encoder_starts_the_run(tmp_path, capsys):
    """encoder_weights with pretrained True: the first step starts from the
    npz's encoder (one update of at most lr away); pretrained False ignores
    it."""
    from transhuman_tpu_torch.tools.convert_resnet import convert

    net = TransHumanNet(embed_dim=192, vit_depth=1, vit_heads=3)
    rng = np.random.default_rng(0)
    # a torchvision-layout ResNet-18 stem and layer1/layer2, through the
    # converter
    sd = {n[len("encoder.model."):]: rng.standard_normal(
        tuple(p.shape)).astype(np.float32)
        for n, p in net.named_parameters() if n.startswith("encoder.model.")}
    flat = convert(sd)
    assert len(flat) == len(sd)
    npz = str(tmp_path / "r.npz")
    np.savez(npz, **flat)
    opts = TINY + _dirs(tmp_path) + ["train.epoch", "1", "ep_iter", "1",
                                     "encoder_weights", npz]
    state, recs = train_cli.main(opts)
    assert "loaded pretrained encoder weights" in capsys.readouterr().out
    w0 = torch.from_numpy(np.transpose(flat["conv1/kernel"], (3, 2, 0, 1)))
    moved = (state.model.encoder.model.conv1.weight.detach() - w0).abs()
    slack = 2 * np.spacing(np.abs(w0.numpy()))  # the update's rounding
    assert (moved.numpy() <= recs[0]["lr"] * 1.001 + slack).all()
    off, _ = train_cli.main(TINY + _dirs(tmp_path / "off") + [
        "train.epoch", "1", "ep_iter", "1", "encoder_weights", npz,
        "pretrained", "False"])
    assert float((off.model.encoder.model.conv1.weight.detach()
                  - w0).abs().max()) > 0.1


def test_loader_order_does_not_depend_on_workers():
    def fetch(i):
        import time
        time.sleep(0.002 * ((7 * i) % 5))
        return i * i

    idx = list(np.random.default_rng(0).permutation(20))
    want = [i * i for i in idx]
    for workers in (0, 1, 3):
        assert list(Loader(fetch, idx, num_workers=workers)) == want


# ---------------------------------------------------------- the Recorder
def _tb_records(path):
    """(step, [(tag, value)]) of every scalar event, each record's CRCs
    checked with the JAX package's CRC32C."""
    data, pos, out = open(path, "rb").read(), 0, []
    while pos < len(data):
        header = data[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        assert struct.unpack("<I", data[pos + 8:pos + 12])[0] == \
            jtb.masked_crc32c(header)
        payload = data[pos + 12:pos + 12 + n]
        assert struct.unpack("<I", data[pos + 12 + n:pos + 16 + n])[0] == \
            jtb.masked_crc32c(payload)
        pos += 16 + n
        out.append(_event(payload))
    return out


def _fields(buf):
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            n, i = _varint(buf, i)
            v, i = buf[i:i + n], i + n
        yield field, v


def _varint(buf, i):
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return out, i


def _event(payload):
    step, values = 0, []
    for f, v in _fields(payload):
        if f == 2:
            step = v
        elif f == 5:
            for _, val in _fields(v):
                d = dict(_fields(val))
                if 2 in d:
                    values.append((d[1].decode(),
                                   struct.unpack("<f", d[2])[0]))
                elif 4 in d:
                    img = dict(_fields(d[4]))
                    values.append((d[1].decode(), (img[1], img[2], img[3],
                                                   img[4][:8])))
    return step, values


def test_recorder_writes_the_jax_packages_rows_and_records(tmp_path):
    rows = {}
    for tag, cls in (("jax", JRecorder), ("port", Recorder)):
        rec = cls(str(tmp_path / tag), record_interval=2, log_interval=1)
        for step in range(5):
            rec.step, rec.epoch = step, step // 2
            rec.update({"loss": 1.0 / (step + 1), "mse_loss": 0.5 * step})
            rec.record("train")
        rec.record("val", extra={"img_loss": 0.25, "psnr": 30.5}, force=True)
        line = rec.console_line(10, 7e-4)
        assert line.startswith("eta: ") and "loss: " in line
        assert "lr: 0.000700" in line and line.endswith("MB")
        assert rec.state_dict() == {"step": 4, "epoch": 2}
        if tag == "port":
            rec.record_image("rgb", np.random.default_rng(0).random(
                (6, 5, 3)).astype(np.float32))
            rec.record_image("acc", np.zeros((6, 5), np.uint8))
        rec.close()
        with open(tmp_path / tag / "metrics.jsonl") as f:
            rows[tag] = [json.loads(x) for x in f]
        files = [f for f in os.listdir(tmp_path / tag)
                 if f.startswith("events.out.tfevents.")]
        assert len(files) == 1
        rows[tag + "_tb"] = _tb_records(str(tmp_path / tag / files[0]))
    assert rows["port"] == rows["jax"]
    assert [r["step"] for r in rows["port"]] == [0, 2, 4, 4]
    assert rows["port_tb"][:-2] == rows["jax_tb"]
    (s1, [(t1, i1)]), (s2, [(t2, i2)]) = rows["port_tb"][-2:]
    assert (t1, i1[:3]) == ("train/rgb", (6, 5, 3))
    assert (t2, i2[:3]) == ("train/acc", (6, 5, 1))
    assert i1[3] == i2[3] == b"\x89PNG\r\n\x1a\n"
    r = Recorder(str(tmp_path / "off"), enabled=False)
    r.record("train", force=True)
    assert not os.path.exists(tmp_path / "off")


# ------------------------------------------- end to end against JAX
E2E = ["dataset", "synthetic", "H", "64", "W", "64", "num_class", "16",
       "vit_depth", "1", "N_samples", "4", "patch.size", "16",
       "patch.N_patches", "2", "ep_iter", "1", "save_freq", "1",
       "perturb", "0", "compute_dtype", "float32", "mesh_axis_data", "1",
       "chunk_size", "256", "pad_bucket", "256", "kmeans_dir", "none"]
HW, NV = 32, 128
EVAL_HW = 96  # the body's box crop is >= 16 px a side: LPIPS runs on it


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """JAX cli.train.main trains epoch 0 from --cfg_file
    configs/train_or_eval.yaml (LPIPS on), then resumes and trains epoch 1;
    the port resumes from JAX's ep0.ckpt and trains epoch 1."""
    root = tmp_path_factory.mktemp("e2e")
    lp = init_lpips_params(jax.random.PRNGKey(0))
    np.savez(root / "L.npz", **{k: np.asarray(v) for k, v in lp.items()})
    opts = E2E + ["lpips_weights", str(root / "L.npz"),
                  "record_dir", str(root / "rec"),
                  "result_dir", str(root / "res")]
    jdir = ["trained_model_dir", str(root / "jax")]
    mp = pytest.MonkeyPatch()
    mp.setenv("TRANSHUMAN_CACHE_DIR", str(root / "cache"))
    try:
        jdata = JDataset(JConfig().merge_opts(list(opts)), "train",
                         image_hw=(HW, HW), n_verts=NV)
        jtrain_cli.main(["--cfg_file", CFG_FILE, *opts, *jdir,
                         "train.epoch", "1"], dataset=jdata, smpl=jdata.smpl)
        ep0 = str(root / "jax" / "transhuman" / "transhuman_tpu" /
                  "ep0.ckpt")
        ck0 = jckpt.load_checkpoint(os.path.dirname(ep0), 0)
        jstate = jtrain_cli.main(["--cfg_file", CFG_FILE, *opts, *jdir,
                                  "train.epoch", "2"], dataset=jdata,
                                 smpl=jdata.smpl)
    finally:
        mp.undo()
    tdata = SyntheticDataset(Config().merge_opts(list(opts)),
                             image_hw=(HW, HW), n_verts=NV)
    state, records = train_cli.main(
        ["--device", "cpu", "--cfg_file", CFG_FILE, *opts,
         "trained_model_dir", str(root / "port"), "specified_resume", ep0,
         "train.epoch", "2"], dataset=tdata)
    return dict(root=root, opts=opts, ck0=ck0, jstate=jstate, state=state,
                records=records)


def _flat_params(tree):
    return {jax.tree_util.keystr(k): np.asarray(v, np.float32) for k, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def test_port_resumes_a_jax_epoch_and_trains_the_next_as_jax_does(
        lifecycle):
    s = lifecycle
    recs = s["records"]
    assert [r["step"] for r in recs] == [1]  # epoch 1, one step
    assert recs[0]["lpips_loss"] > 0 and np.isfinite(recs[0]["loss"])
    assert s["state"].step == int(s["jstate"].step) == 2
    _, schedule = jstep.make_optimizer(iters_per_epoch=1)
    lr = float(schedule(1))
    assert recs[0]["lr"] == pytest.approx(lr, rel=1e-6)
    p0 = _flat_params(s["ck0"]["params"]["params"])
    pj = _flat_params(jax.tree_util.tree_map(np.asarray,
                                             s["jstate"].params)["params"])
    pt = _flat_params(weights.jax_params_from_state_dict(
        s["state"].model.state_dict())["params"])
    assert pt.keys() == pj.keys()
    tight = total = 0
    for k, w0 in p0.items():
        dt, dj = pt[k] - w0, pj[k] - w0
        slack = 2 * np.spacing(np.abs(w0).astype(np.float32))
        err = np.abs(dt - dj)
        # Adam's second update from the same moments and a gradient that
        # agrees to ~1e-3 of itself (tests/test_torch_train.py's bounds):
        # within 1% of lr where the update is sure, within 2 lr everywhere
        assert (err <= 2 * lr + slack).all(), k
        tight += int((err <= 0.01 * lr + slack).sum())
        total += err.size
    assert tight >= 0.75 * total, (tight, total)
    # the port's latest.pth holds epoch 1, the step, and the JAX recorder
    blob = torch.load(s["root"] / "port" / "transhuman" / "transhuman_tpu" /
                      "latest.pth", weights_only=True)
    assert (blob["epoch"], blob["step"]) == (1, 2)
    assert blob["recorder"] == {"step": 1, "epoch": 1}


def test_validate_matches_the_jax_validate(lifecycle, tmp_path):
    """--test from the JAX package's latest.ckpt in both packages: the
    per-frame img_loss, PSNR, SSIM and LPIPS within tests/test_torch_eval.py's
    bounds, and one forced 'val' record."""
    s = lifecycle
    opts = s["opts"] + ["trained_model_dir", str(s["root"] / "jax"),
                        "test.frame_interval", "4"]
    jopts = opts + ["record_dir", str(tmp_path / "jrec"),
                    "result_dir", str(tmp_path / "jres")]
    topts = opts + ["record_dir", str(tmp_path / "trec"),
                    "result_dir", str(tmp_path / "tres")]
    mp = pytest.MonkeyPatch()
    mp.setenv("TRANSHUMAN_CACHE_DIR", str(s["root"] / "cache"))
    try:
        jdata = JDataset(JConfig().merge_opts(list(jopts)), "test",
                         image_hw=(EVAL_HW, EVAL_HW), n_verts=NV)
        jstats, jsum = jtrain_cli.main(
            ["--test", "--cfg_file", CFG_FILE, *jopts], dataset=jdata,
            smpl=jdata.smpl)
    finally:
        mp.undo()
    tdata = SyntheticDataset(Config().merge_opts(list(topts)), "test",
                             image_hw=(EVAL_HW, EVAL_HW), n_verts=NV)
    tstats, tsum = train_cli.main(
        ["--test", "--device", "cpu", "--cfg_file", CFG_FILE, *topts],
        dataset=tdata)
    assert set(tstats) == set(jstats) == {"img_loss", "loss"}
    # rgb within 2e-3 per colour: ~0.05 dB of PSNR, ~1% of the MSE
    assert tstats["img_loss"] == pytest.approx(jstats["img_loss"], rel=1e-2)
    assert tsum["epoch"] == jsum["epoch"] == 1
    assert tsum["psnr"] == pytest.approx(jsum["psnr"], abs=0.05)
    assert tsum["ssim"] == pytest.approx(jsum["ssim"], abs=2e-3)
    assert tsum["lpips"] is not None and jsum["lpips"] is not None
    assert tsum["lpips"] == pytest.approx(jsum["lpips"], abs=2e-3)
    rows = {}
    for tag in ("jrec", "trec"):
        with open(tmp_path / tag / "metrics.jsonl") as f:
            rows[tag] = [json.loads(x) for x in f]
    assert len(rows["trec"]) == 1 and rows["trec"][0]["prefix"] == "val"
    assert rows["trec"][0].keys() == rows["jrec"][0].keys()
    text = (tmp_path / "tres" / "epoch_-1" / "debug" / "summary.txt").read_text()
    assert "lpips: " in text and "n/a" not in text


def test_run_entry_point_evaluates_a_jax_checkpoint_dir(lifecycle, tmp_path):
    """--type evaluate with no --weights finds the JAX package's
    latest.ckpt in trained_model_dir, with the LPIPS column."""
    s = lifecycle
    opts = s["opts"] + ["trained_model_dir", str(s["root"] / "jax"),
                        "result_dir", str(tmp_path / "res"),
                        "test.frame_interval", "8"]
    tdata = SyntheticDataset(Config().merge_opts(list(opts)), "test",
                             image_hw=(EVAL_HW, EVAL_HW), n_verts=NV)
    summary = run_cli.main(["--type", "evaluate", "--device", "cpu",
                            "--cfg_file", CFG_FILE, *opts], dataset=tdata)
    assert summary["epoch"] == 1 and summary["lpips"] > 0
    assert np.load(tmp_path / "res" / "epoch_-1" / "debug" /
                   "lpips.npy").shape == (1,)
