"""Data-parallel training and frame-sharded evaluation of the port over 2
gloo ranks on the CPU, against the JAX package's 2-device data-parallel
step and against the port in one process.

Each rank is a subprocess (tests/_torch_parallel_worker.py, which imports
no JAX) joined over a ``file://`` rendezvous under the test's temporary
directory, with its own timeout, so a hung collective fails the test.  The
JAX side runs here, on the shared scene of tests/_torch_batch_setup.py: its
model's BatchNorm pooled over ('batch', 'data') and its step under
``shard_map`` on a 2-device ('data',) mesh of the host devices
tests/conftest.py provides.  The train bounds are those of
tests/test_torch_batch.py (``check_f32``)."""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_batch_setup as S
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.cli import train as train_cli
from transhuman_tpu_torch.render.pipeline import fold_in

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_parallel_worker.py")
RANK_TIMEOUT = 240  # s per rank; a hung collective fails the test
# the 2-rank step against the one-process B = 2 step, per gradient leaf:
# within SAME_STEP_RTOL of its norm plus SAME_STEP_ATOL of the largest
# leaf's (for leaves whose gradient is 0 up to rounding).  The same sums in
# another order: 1e-5 was set before the first run, which measured up to
# 2.9e-5 (TransHE's norm scales; median 1.7e-6), where the JAX package's
# own 2-device step lies up to 3.0e-4 from its B = 2 step.  Without
# BatchNorm pooled over the ranks the gap is orders of magnitude larger.
SAME_STEP_RTOL, SAME_STEP_ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def scene():
    return S.Scene()


@pytest.fixture(scope="module")
def p0(scene):
    return S.leaves(scene.params["params"])


def run_ranks(job, out_dir, world):
    """Start the ranks together, each with RANK_TIMEOUT; raise with the
    output of any rank that fails or times out."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "XLA_FLAGS")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, job, str(out_dir), str(r), str(world)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RANK_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{out}"
    return outs


def port_shape():
    return {"embed": S.EMBED, "depth": S.DEPTH, "heads": S.HEADS, "k": S.K,
            "n_clusters": S.NC, "n_verts": S.NV, "n_samples": S.NS}


def run_port_dp(scene, out_dir, samples, b_local, accum=1, train_cull=False):
    """The port's step over 2 ranks of b_local samples each: each rank's
    saved result (stats, gradients, parameters, ...)."""
    torch.save({"sd": scene.sd, "vert2cluster": scene.cluster.vert2cluster,
                "shape": port_shape(), "samples": samples, "b_local": b_local,
                "accum": accum, "train_cull": train_cull},
               out_dir / "input.pt")
    run_ranks("step", out_dir, 2)
    return [torch.load(out_dir / f"step_{r}.pt", weights_only=False)
            for r in range(2)]


def as_step(res):
    """A worker's result as S.port_step's (loss, grads, stats, params)."""
    return (res["stats"]["loss"],
            S.leaves(weights.jax_params_from_state_dict(res["grads"])
                     ["params"]),
            res["stats"],
            S.leaves(weights.jax_params_from_state_dict(res["params"])
                     ["params"]))


def jax_dp_step(scene, batch, accum_steps=1, n_dev=2):
    """The JAX package's data-parallel step over a 2-device ('data',) mesh,
    its model's norms over ('batch', 'data'), jitter off: (loss, gradients,
    stats, updated params) as S.jax_step gives them.  The gradients are the
    pmean over 'data' of local_step's per-device accum_value_and_grad; the
    stats and the update come from make_train_step with the mesh."""
    model = scene.jmodel["float32"].clone(axis_name=("batch", "data"))
    pipe = JPipeline(model, scene.cluster, scene.smpl.v_template,
                     n_samples=S.NS, pe_table=scene.table)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    sample_loss = jstep.make_sample_loss(pipe, None, perturb=False)
    key = jax.random.PRNGKey(0)

    def local(params, batch):
        b = jax.tree_util.tree_leaves(batch)[0].shape[0]
        gidx = jax.lax.axis_index("data") * b + jnp.arange(b)
        rngs = jax.vmap(lambda i: jax.random.fold_in(key, i))(gidx)

        def loss_fn(params, mb_batch, mb_rngs):
            losses, stats = jax.vmap(functools.partial(sample_loss, params),
                                     axis_name="batch")(mb_batch, mb_rngs)
            return jnp.mean(losses), jax.tree.map(jnp.mean, stats)

        (loss, _), grads = jstep.accum_value_and_grad(
            loss_fn, params, batch, rngs, accum_steps)
        return jax.lax.pmean(loss, "data"), jax.lax.pmean(grads, "data")

    loss, grads = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P("data")), out_specs=(P(), P()),
        check_vma=False))(scene.params, batch)
    tx, _ = jstep.make_optimizer(iters_per_epoch=4)
    train = jstep.make_train_step(pipe, tx, mesh=mesh, perturb=False,
                                  donate=False, accum_steps=accum_steps)
    state, stats = train(jstep.init_state(scene.params, tx), batch, key)
    return (float(loss), S.leaves(grads["params"]),
            {k: float(v) for k, v in stats.items()},
            S.leaves(state.params["params"]))


def check_stats(port_stats, ref_stats):
    stats = dict(port_stats)
    assert stats.pop("lr") == pytest.approx(7e-4 / 300)
    assert stats.keys() == ref_stats.keys()
    for k in stats:
        np.testing.assert_allclose(stats[k], ref_stats[k], rtol=S.LOSS_RTOL)


def check_ranks_agree(res):
    """Both ranks hold the same averaged gradients and updated weights, and
    no norm pools outside the step."""
    for k in res[0]["params"]:
        assert torch.equal(res[0]["params"][k], res[1]["params"][k]), k
    for k in res[0]["grads"]:
        assert torch.equal(res[0]["grads"][k], res[1]["grads"][k]), k
    assert all(r["norm_groups"] for r in res)
    assert res[0]["stats"] == res[1]["stats"]


@pytest.fixture(scope="module")
def dp_b1(scene, tmp_path_factory):
    """2 ranks x B = 1: each rank's result, and the samples."""
    _, ts = scene.samples(2)
    return run_port_dp(scene, tmp_path_factory.mktemp("dp_b1"), ts, 1), ts


def test_two_rank_step_matches_the_jax_dp_step(scene, p0, dp_b1):
    """(a) The step over 2 ranks of one sample each against the JAX
    package's step on a 2-device mesh: the loss, each gradient leaf and
    the first Adam update at the float32 train bounds, the stats equal;
    both ranks end with the same weights; the gradient all-reduce was
    timed and sized; rank 0's encoder and decode alone after the step ran
    no collective."""
    res, _ = dp_b1
    jb, _ = scene.samples(2)
    ref = jax_dp_step(scene, jb)
    port = as_step(res[0])
    S.check_f32(port, ref, p0)
    check_stats(port[2], ref[2])
    check_ranks_agree(res)
    # sample i of rank r folds the global index r * B + i into the seed
    assert [r["seeds"] for r in res] == [[fold_in(7, 0)], [fold_in(7, 1)]]
    comm = res[0]["comm"]
    assert comm["grad_allreduce_ms"] > 0
    n = sum(g.numel() for g in res[0]["grads"].values())
    assert comm["grad_allreduce_mb"] == pytest.approx(n * 4 / 2**20)
    assert res[0]["eval"] is not None and res[1]["eval"] is None


def test_two_rank_step_equals_the_one_process_batch_step(scene, dp_b1):
    """(b) The same step against the port's one-process step on both
    samples (B = 2, BatchNorm pooled over the batch): the loss within
    LOSS_RTOL, each gradient leaf within the SAME_STEP bounds; each
    sample's step alone, averaged (ranks whose norms do not pool), misses
    them by more than tenfold.  The largest gaps are printed."""
    res, ts = dp_b1
    one = S.port_step(scene, scene.port_pipe(), ts)
    dp = as_step(res[0])
    np.testing.assert_allclose(dp[0], one[0], rtol=S.LOSS_RTOL)
    alone = [S.port_step(scene, scene.port_pipe(), [t])[1] for t in ts]
    unpooled = {k: (alone[0][k] + alone[1][k]) / 2 for k in one[1]}
    top = max(np.linalg.norm(g) for g in one[1].values())

    def worst(grads):
        gap = 0.0
        for k, want in one[1].items():
            err = np.linalg.norm(grads[k] - want)
            gap = max(gap, err / (SAME_STEP_RTOL * np.linalg.norm(want)
                                  + SAME_STEP_ATOL * top))
        return gap

    assert worst(dp[1]) <= 1.0
    assert worst(unpooled) > 10.0
    rel = sorted(((np.linalg.norm(dp[1][k] - w) / np.linalg.norm(w), k)
                  for k, w in one[1].items() if np.linalg.norm(w) > 0),
                 reverse=True)
    print(f"2 ranks vs one process, B = 2: loss {dp[0]!r} vs {one[0]!r}; "
          f"largest gradient gaps {rel[:3]}; of the bounds: 2 ranks "
          f"{worst(dp[1]):.3g}, unpooled {worst(unpooled):.3g}")


def test_two_rank_accumulation_matches_the_jax_dp_step(scene, p0,
                                                       tmp_path):
    """(c) 2 ranks x B = 2 in 2 microbatches each (strided, BatchNorm
    pooled over the ranks within each microbatch) against the JAX step on
    the 2-device mesh with accum_steps 2, at the float32 train bounds."""
    jb, ts = scene.samples(4)
    res = run_port_dp(scene, tmp_path, ts, 2, accum=2)
    ref = jax_dp_step(scene, jb, accum_steps=2)
    port = as_step(res[0])
    S.check_f32(port, ref, p0)
    check_stats(port[2], ref[2])
    check_ranks_agree(res)


def test_cull_with_survivors_on_one_rank_only(scene, tmp_path):
    """(e) Under train.cull, rank 1's sample lies 100 m from its body, so
    nothing of it survives the cull; the step completes on both ranks
    (rank 1 decodes one masked point, and its missing gradients join the
    all-reduce as zeros), and cull_survivors is the fraction of both
    ranks' points."""
    _, ts = scene.samples(2)
    far = ts[1].frame
    far.tar_verts_smpl = far.tar_verts_smpl + 100.0
    res = run_port_dp(scene, tmp_path, ts, 1, train_cull=True)
    check_ranks_agree(res)
    local = [r["local"] for r in res]
    assert local[0]["survivors"] > 0 and local[1]["survivors"] == 0
    want = local[0]["survivors"] / (local[0]["points"] + local[1]["points"])
    assert res[0]["stats"]["cull_survivors"] == pytest.approx(want)
    assert np.isfinite(res[0]["stats"]["loss"])
    assert all(torch.isfinite(g).all() for g in res[0]["grads"].values())


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A 1-step checkpoint of the train entry point on the CPU."""
    root = tmp_path_factory.mktemp("ckpt")
    path = str(root / "t.pth")
    train_cli.main(["--device", "cpu", "--steps", "1", "--out", path,
                    *EVAL_OPTS, "trained_model_dir", str(root / "tm"),
                    "record_dir", str(root / "rec"), "patch.size", "6",
                    "patch.N_patches", "2"])
    return path


EVAL_OPTS = ["dataset", "synthetic", "H", "64", "W", "64", "num_class",
             "20", "vit_depth", "1", "N_samples", "8", "kmeans_dir",
             "/nonexistent", "test.frame_interval", "3"]


def run_entry(checkpoint, tmp_path, world, *argv):
    """The run entry point over world ranks (1: one process) with argv:
    (its result directory, each rank's output and run_<rank>.json)."""
    d = tmp_path / f"w{world}"
    d.mkdir()
    (d / "argv.json").write_text(json.dumps(
        [*argv[:2], "--device", "cpu", "--weights", checkpoint, *EVAL_OPTS,
         "result_dir", str(d / "res"), *argv[2:]]))
    outs = run_ranks("run", d, world)
    return (d / "res" / "epoch_-1" / "debug", outs,
            [json.loads((d / f"run_{r}.json").read_text())
             for r in range(world)])


def test_two_rank_evaluate_of_unequal_shares_equals_one_process(
        checkpoint, tmp_path):
    """(d) 3 frames (rank 0 takes 2, rank 1 one), each frame's input views
    scaled differently, evaluated by 2 ranks and by one process, each a
    subprocess with the same thread count: rank 0 alone writes the files;
    the .npy metrics agree within 1e-9 in the same (frame) order, and every
    rank returns the one-process summary.  Each frame's metrics equal the
    one-process frame's, so no rank's statistics took in another rank's
    frames."""
    one, _, (want,) = run_entry(checkpoint, tmp_path, 1, "--type",
                                "evaluate")
    two, outs, got = run_entry(checkpoint, tmp_path, 2, "--type", "evaluate")
    assert "[synthetic f3 c0]" in outs[1]  # rank 1's frame
    assert [g["writes"] for g in got] == [[True], [False]]
    for name in ("mse", "psnr", "ssim"):
        a, b = np.load(one / f"{name}.npy"), np.load(two / f"{name}.npy")
        assert a.shape == b.shape == (3,), name
        assert len(set(a.tolist())) == 3, name  # the frames differ
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-9, err_msg=name)
    assert np.load(two / "lpips.npy").shape == (0,)
    for r in range(2):
        assert got[r]["out"].keys() == want["out"].keys()
        for k, v in want["out"].items():
            if isinstance(v, float):
                assert abs(got[r]["out"][k] - v) <= 1e-9, (r, k)
            else:
                assert got[r]["out"][k] == v, (r, k)
    lines = [(one / "summary.txt").read_text().splitlines(),
             (two / "summary.txt").read_text().splitlines()]
    assert len(lines[0]) == len(lines[1])
    for a, b in zip(*lines):
        (ka, va), (kb, vb) = a.split(": ", 1), b.split(": ", 1)
        assert ka == kb
        try:
            assert abs(float(va) - float(vb)) <= 1e-9, ka
        except ValueError:
            assert va == vb, ka


def test_two_rank_visualize_assembles_one_video(checkpoint, tmp_path):
    """Visualize over 2 ranks: each renders every other of the 8 frames,
    and rank 0 alone assembles the AVI, of all 8, after both ranks'
    PNGs are written."""
    from tests.test_avi_writer import parse_avi

    out, outs, got = run_entry(checkpoint, tmp_path, 2, "--type",
                               "visualize")
    assert [len(g["out"]) for g in got] == [4, 4]
    assert ["video: " in o for o in outs] == [True, False]
    movie = parse_avi(str(out / "perform" / "synthetic.avi"))
    assert len(movie["frames"]) == 8


def test_two_rank_reconstruction_writes_each_frame_once(checkpoint,
                                                        tmp_path):
    """Reconstruction of 2 frames over 2 ranks: one PLY a rank, each equal
    to the one-process PLY of its frame (frames 0 and 4, whose input
    views differ)."""
    from transhuman_tpu_torch.mesh_ops.ply import load_ply

    argv = ["--type", "reconstruction", "test.frame_interval", "4",
            "voxel_size", "0.04,0.04,0.04", "mesh_th", "5"]
    _, _, (one,) = run_entry(checkpoint, tmp_path, 1, *argv)
    _, _, two = run_entry(checkpoint, tmp_path, 2, *argv)
    assert [len(g["out"]) for g in two] == [1, 1]
    meshes = [load_ply(p)[0] for p in one["out"]]
    assert meshes[0].shape != meshes[1].shape or not np.array_equal(
        *meshes)  # the two frames' meshes differ
    assert [os.path.basename(p) for g in two for p in g["out"]] == [
        os.path.basename(p) for p in one["out"]]
    for p1, p2 in zip(one["out"], [p for g in two for p in g["out"]]):
        (v1, t1), (v2, t2) = load_ply(p1), load_ply(p2)
        assert len(v1) > 0 and v1.shape == v2.shape, (p1, len(v1), len(v2))
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_allclose(v2, v1, rtol=0, atol=1e-6)


def test_train_entry_point_over_two_ranks(tmp_path):
    """The train entry point over 2 ranks at train.batch_size 1 (a global
    batch of 2): step k gives rank r sample perm[2k + r] of the seeded
    permutation; both ranks log the same losses; rank 0 alone records and
    saves; then --test validates the 3 frames split over the ranks, and
    both ranks get one summary."""
    opts = [*EVAL_OPTS, "patch.size", "6", "patch.N_patches", "2",
            "ep_iter", "2", "train.epoch", "1", "record_interval", "1",
            "trained_model_dir",
            str(tmp_path / "tm"), "record_dir", str(tmp_path / "rec"),
            "result_dir", str(tmp_path / "res")]
    (tmp_path / "argv.json").write_text(json.dumps(
        ["--device", "cpu", *opts, "mesh_axis_data", "2"]))
    (tmp_path / "test_argv.json").write_text(json.dumps(
        ["--device", "cpu", "--test", *opts]))
    run_ranks("train", tmp_path, 2)
    out = [json.loads((tmp_path / f"train_{r}.json").read_text())
           for r in range(2)]
    perm = np.random.default_rng(123).permutation(8)
    assert out[0]["taken"] == [int(perm[0]), int(perm[2])]
    assert out[1]["taken"] == [int(perm[1]), int(perm[3])]
    assert [r["loss"] for r in out[0]["records"]] == [
        r["loss"] for r in out[1]["records"]]
    assert all(r["grad_allreduce_mb"] > 0 for r in out[0]["records"])
    assert (tmp_path / "tm" / "transhuman" / "transhuman_tpu" /
            "latest.pth").is_file()
    lines = (tmp_path / "rec" / "metrics.jsonl").read_text().splitlines()
    prefixes = [json.loads(ln)["prefix"] for ln in lines]
    assert prefixes == ["train", "train", "val"]  # rank 0's alone
    assert out[0]["summary"] == out[1]["summary"]
    assert out[0]["val"] == out[1]["val"]
    assert np.load(tmp_path / "res" / "epoch_-1" / "debug" /
                   "psnr.npy").shape == (3,)
