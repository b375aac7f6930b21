"""Tensor-parallel training of the port (parallel/tp.py) over a 2 x 2
('data', 'model') mesh of 4 gloo ranks on the CPU, against the JAX
package's tensor-parallel step on a make_tp_mesh(2, 2) of host devices and
against the port's one-process step.

The ranks are subprocesses of tests/_torch_tp_worker.py (no JAX), joined
over a ``file://`` rendezvous with a timeout each; one run of them serves
every test here.  The JAX side runs in this process on the shared scene of
tests/_torch_batch_setup.py (EMBED 12, HEADS 2, DEPTH 2), global batch 4,
2 samples a data rank.  Bounds: check_f32's against JAX (loss 1e-5
relative, each gradient leaf 1e-3 of its norm + 1e-10, Adam's first
update), tests/test_torch_parallel.py's SAME_STEP bounds against one
process, JAX's own atol 1e-5 for accum_steps 2 against 1, bit for bit
across a save and a resume."""

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch

import _torch_batch_setup as S
import _torch_tp_worker as W
from test_torch_parallel import SAME_STEP_ATOL, SAME_STEP_RTOL, as_step, \
    port_shape
from transhuman_tpu.parallel import shard_batch
from transhuman_tpu.parallel.tp import (
    make_tp_mesh as jax_tp_mesh,
    make_tp_train_step as jax_tp_step,
    shard_train_state,
)
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch import weights
from transhuman_tpu_torch.parallel import tp
from transhuman_tpu_torch.render.pipeline import fold_in
from transhuman_tpu_torch.train import checkpoint as ckpt_io
from transhuman_tpu_torch.train import step as tstep

B_LOCAL = 2  # samples a data rank: global batch 4 over 2 data indices


@pytest.fixture(scope="module")
def scene():
    return S.Scene()


@pytest.fixture(scope="module")
def p0(scene):
    return S.leaves(scene.params["params"])


def one_process_file(scene, ts, path):
    """The port's one-process state after 2 steps on the 4 samples,
    written as a checkpoint."""
    pipe = scene.port_pipe()
    opt, sched = tstep.make_optimizer(pipe.model.parameters(),
                                      iters_per_epoch=4)
    state = tstep.TrainState(pipe.model, opt, sched)
    step = tstep.make_train_step(pipe, perturb=False)
    for it in range(2):
        step(state, ts, it)
    ckpt_io.save_checkpoint(str(path), state, 0)


@pytest.fixture(scope="module")
def tp_run(scene, tmp_path_factory):
    """Every rank's result of the worker's ``tp`` job, the samples, and
    the JAX batch; the JAX step runs while the ranks do."""
    d = tmp_path_factory.mktemp("tp")
    jb, ts = scene.samples(4)
    one_process_file(scene, ts, d / "one.pth")
    # accumulation pools BatchNorm within each microbatch: as JAX's test,
    # the same input images in every sample (the targets differ)
    same = [dataclasses.replace(t, frame=dataclasses.replace(
        t.frame, images=ts[0].frame.images)) for t in ts]
    torch.save({"sd": scene.sd, "vert2cluster": scene.cluster.vert2cluster,
                "shape": port_shape(), "samples": ts, "b_local": B_LOCAL,
                "same_images": same, "train_cull": False}, d / "input.pt")
    procs = W.spawn("tp", d, 4)
    ref = jax_tp(scene, jb)
    W.join(procs)
    res = [torch.load(d / f"tp_{r}.pt", weights_only=False)
           for r in range(4)]
    return res, ts, ref, d


def jax_tp(scene, batch):
    """The JAX package's tensor-parallel step on make_tp_mesh(2, 2), jitter
    off: (loss, gradients, stats, updated params) as S.jax_step gives
    them; the gradient is the step's own, read from Adam's first moment
    (mu = (1 - b1) g after one update)."""
    pipe = scene.jax_pipe()
    tx, _ = jstep.make_optimizer(iters_per_epoch=4)
    mesh = jax_tp_mesh(2, 2)
    step = jax_tp_step(pipe, tx, mesh, donate=False, perturb=False)
    state, stats = step(shard_train_state(mesh, jstep.init_state(
        scene.params, tx)), shard_batch(mesh, batch), jax.random.PRNGKey(0))
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    (adam,) = [s for s in jax.tree_util.tree_leaves(state.opt_state,
                                                    is_leaf=is_adam)
               if is_adam(s)]
    grads = {k: v / np.float32(0.1) for k, v in
             S.leaves(adam.mu["params"]).items()}
    return (float(stats["loss"]), grads,
            {k: float(v) for k, v in stats.items()},
            S.leaves(state.params["params"]))


def test_tp_step_matches_the_jax_tp_step(tp_run, p0):
    """The 4-rank step (2 data x 2 model) against the JAX TP step on the
    same weights and batch: loss, each gradient leaf and Adam's first
    update at check_f32's bounds; every rank ends with the same whole
    weights; the stats are the JAX step's."""
    res, _, ref, _ = tp_run
    port = as_step(res[0]["step"])
    S.check_f32(port, ref, p0)
    stats = dict(port[2])
    stats.pop("lr")
    for k, v in stats.items():
        np.testing.assert_allclose(v, ref[2][k], rtol=S.LOSS_RTOL)
    for r in res[1:]:
        for k, v in res[0]["step"]["params"].items():
            assert torch.equal(r["step"]["params"][k], v), k
        assert r["step"]["stats"] == res[0]["step"]["stats"]


def test_tp_step_equals_the_one_process_batch_step(scene, tp_run):
    """The same run against the port's one-process step on all 4 samples:
    the loss within 1e-5 relative, each gradient leaf within the SAME_STEP
    bounds of tests/test_torch_parallel.py."""
    res, ts, _, _ = tp_run
    one = S.port_step(scene, scene.port_pipe(), ts)
    got = as_step(res[0]["step"])
    np.testing.assert_allclose(got[0], one[0], rtol=S.LOSS_RTOL)
    top = max(np.linalg.norm(g) for g in one[1].values())
    for k, want in one[1].items():
        err = np.linalg.norm(got[1][k] - want)
        assert err <= (SAME_STEP_RTOL * np.linalg.norm(want)
                       + SAME_STEP_ATOL * top), (k, err)


def test_sharding_is_real_and_counted(tp_run):
    """Each model rank holds half of the rows of every qkv and fc1 weight
    (and half of the columns of proj and fc2) and its Adam moments are
    those shards; the replicated leaves' gradients, averaged over every
    rank, are equal on the two model ranks bit for bit; the model axis ran
    4 all-reduces a block for each sample's TransHE."""
    res, _, _, _ = tp_run
    d = S.EMBED
    for r in res:
        st = r["step"]
        assert len(st["sharded"]) == 6 * S.DEPTH
        for i in range(S.DEPTH):
            blk = f"ViT.blocks.{i}."
            want = {"attn.qkv.weight": (3 * d // 2, d),
                    "attn.qkv.bias": (3 * d // 2,),
                    "attn.proj.weight": (d, d // 2), "attn.proj.bias": (d,),
                    "mlp.fc1.weight": (2 * d, d), "mlp.fc1.bias": (2 * d,),
                    "mlp.fc2.weight": (d, 2 * d), "mlp.fc2.bias": (d,)}
            for leaf, shape in want.items():
                assert st["shapes"][blk + leaf] == shape, (blk + leaf)
                assert st["moment_shapes"][blk + leaf] == shape
        assert st["comm"]["model_allreduce_count"] == 4 * S.DEPTH * B_LOCAL
        assert st["comm"]["model_allreduce_ms"] > 0
        assert st["comm"]["grad_allreduce_mb"] > 0
    full = sum(v.numel() * 4 for k, v in res[0]["step"]["params"].items()
               if k.startswith("ViT."))
    assert res[0]["step"]["bytes"]["vit_param_bytes"] < 0.6 * full
    assert res[0]["step"]["bytes"]["vit_moment_bytes"] == \
        2 * res[0]["step"]["bytes"]["vit_param_bytes"]
    by = {(r["data_rank"], r["model_rank"]): r for r in res}
    for d_idx in range(2):
        a, b = (by[(d_idx, m)]["step"]["local_grads"] for m in range(2))
        for k in a:
            if k not in res[0]["step"]["sharded"]:
                assert torch.equal(a[k], b[k]), k


def test_attention_falls_back_to_replicated_at_three_heads(tp_run):
    """TransHE at 3 heads over 2 model ranks: attention stays whole (plain
    Linears), the MLP is sharded, 2 all-reduces a block each way, and the
    output and every gradient are the unsharded module's."""
    for r in tp_run[0]:
        fb = r["fallback"]
        assert fb["kinds"] == ["Linear", "Linear", "ColumnParallelLinear",
                               "RowParallelLinear"]
        assert fb["sharded"] == sorted(
            f"blocks.{i}.mlp.{n}" for i in range(2)
            for n in ("fc1.weight", "fc1.bias", "fc2.weight"))
        assert fb["count"] == 2 * 2
        assert fb["out_err"] <= 1e-6 and fb["grad_err"] <= 1e-6, fb


def test_tp_specs_fall_back_when_not_divisible(scene):
    """The rule match alone: at 8 model ranks the 2-head attention stays
    replicated and the MLP (48 rows) shards; at 2 ranks TransHE tiny's 3
    heads keep attention replicated, where JAX's column split would shard
    both."""
    specs = tp.tp_param_specs(scene.sd, 8, S.HEADS)
    assert specs["ViT.blocks.0.attn.qkv.weight"] is None
    assert specs["ViT.blocks.0.attn.proj.weight"] is None
    assert specs["ViT.blocks.0.mlp.fc1.weight"] == tp.TPSpec(0)
    assert specs["ViT.blocks.0.mlp.fc2.weight"] == tp.TPSpec(1)
    assert specs["ViT.blocks.0.mlp.fc2.bias"] is None
    assert specs["ViT.norm.weight"] is None
    assert specs["encoder.model.conv1.weight"] is None
    tiny = {"blocks.0.attn.qkv.weight": torch.zeros(576, 192),
            "blocks.0.mlp.fc1.weight": torch.zeros(768, 192)}
    got = tp.tp_param_specs(tiny, 2, 3)
    assert got == {"blocks.0.attn.qkv.weight": None,
                   "blocks.0.mlp.fc1.weight": tp.TPSpec(0)}
    assert tp.tp_param_specs(scene.sd, 2, S.HEADS)[
        "ViT.blocks.1.attn.qkv.bias"] == tp.TPSpec(0, 3)


def test_head_split_shards_round_trip():
    """shard_tensor cuts each of q, k and v by whole heads and
    unshard_tensors puts the pieces back bit for bit."""
    w = torch.arange(3 * 8 * 2, dtype=torch.float32).reshape(24, 2)
    spec = tp.TPSpec(0, 3)
    pieces = [tp.shard_tensor(w, spec, r, 2) for r in range(2)]
    assert pieces[0][:, 0].tolist() == [0, 2, 4, 6, 16, 18, 20, 22, 32, 34,
                                        36, 38]
    assert torch.equal(tp.unshard_tensors(pieces, spec), w)


def test_tp_accumulation_matches_accum_one(tp_run):
    """accum_steps 2 (each rank's 2 samples one microbatch each) against
    accum_steps 1, both on samples with the same input images (BatchNorm
    pools within a microbatch), as JAX's test_tp_grad_accum_matches_one_shot:
    the loss within 1e-6, JAX's atol 1e-5 on every weight."""
    res, _, _, _ = tp_run
    for r in res:
        one, two = r["accum"]
        assert abs(one["loss"] - two["loss"]) < 1e-6
        for k, v in one["params"].items():
            np.testing.assert_allclose(two["params"][k].numpy(), v.numpy(),
                                       atol=1e-5, err_msg=k)


def test_tp_checkpoint_round_trip_resumes_bitwise(tp_run, scene):
    """2 steps, a save (gathered, written by rank 0), a resume into a fresh
    mesh: the state equals the saved one bit for bit, and the third step
    the uninterrupted run's bit for bit.  The file loads into one process
    (its weights and moments those the ranks gathered), which steps on."""
    res, ts, _, d = tp_run
    for r in res:
        assert r["resumed_equal"] and r["resumed_step"] == 2
        assert r["third_equal"]
    blob = ckpt_io.read_checkpoint(str(d / "tp.pth"), S.DEPTH)
    params, optim = res[0]["two"]
    for k, v in params.items():
        assert torch.equal(blob["net"][k], v), k
    pipe = scene.port_pipe()
    opt, sched = tstep.make_optimizer(pipe.model.parameters(),
                                      iters_per_epoch=4)
    state = tstep.TrainState(pipe.model, opt, sched)
    ckpt_io.restore(state, blob)
    assert state.step == 2
    for i, st in state.optimizer.state_dict()["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(st[key], optim["state"][i][key]), (i, key)
    stats = tstep.make_train_step(pipe, perturb=False)(state, ts, 2)
    assert np.isfinite(stats["loss"])


def test_a_one_process_file_resumes_under_tp(tp_run):
    """The one-process file: each rank's shards of its weights and moments
    equal the file's cut by the rule, and the step goes on from it."""
    for r in tp_run[0]:
        assert r["one_resumed_equal"] and r["one_moments_equal"]
        assert r["one_step"] == 2 and np.isfinite(r["one_next_loss"])


def test_tp_seeds_fold_the_data_index(tp_run):
    """With jitter on, the sample i of data index d folds d * B + i, the
    one-process step's seed for that global sample; both model ranks of a
    data index use the same seeds (the world rank would give model rank 1
    another's)."""
    res, _, _, _ = tp_run
    for r in res:
        d = r["data_rank"]
        assert r["seeds"] == [fold_in(fold_in(7, 0), d * B_LOCAL + i)
                              for i in range(B_LOCAL)]
    one = [fold_in(fold_in(7, 0), i) for i in range(2 * B_LOCAL)]
    got = [s for d in range(2) for r in res if r["data_rank"] == d
           and r["model_rank"] == 0 for s in r["seeds"]]
    assert got == one


def test_reference_state_dict_round_trips_through_shards(scene):
    """shard_state_dict then unshard_tensors gives the reference state
    dict back bit for bit, and weights.jax_params_from_state_dict reads
    it."""
    specs = tp.tp_param_specs(scene.sd, 2, S.HEADS)
    from transhuman_tpu_torch.parallel.mesh import Axis

    parts = [tp.shard_state_dict(scene.sd, specs, Axis("model", r, 2))
             for r in range(2)]
    back = {k: (tp.unshard_tensors([p[k] for p in parts], specs[k])
                if specs[k] is not None else parts[0][k]) for k in scene.sd}
    for k, v in scene.sd.items():
        assert torch.equal(back[k], v), k
    weights.jax_params_from_state_dict(back)


def test_train_entry_point_with_mesh_axis_model_2(tmp_path):
    """The train entry point over 2 ranks at mesh_axis_model 2 (one data
    index): both model ranks take the same samples, log the same losses
    and end with bit-equal replicated parameters, the model axis ran its
    all-reduces, rank 0 alone saves a whole checkpoint that loads into
    one process, then --test validates the 3 frames split over the
    ranks."""
    import json

    from test_torch_parallel import EVAL_OPTS, run_ranks

    opts = [*EVAL_OPTS, "patch.size", "6", "patch.N_patches", "2",
            "ep_iter", "2", "train.epoch", "1", "record_interval", "1",
            "vit_depth", "2", "trained_model_dir", str(tmp_path / "tm"),
            "record_dir", str(tmp_path / "rec"), "result_dir",
            str(tmp_path / "res"), "mesh_axis_model", "2"]
    (tmp_path / "argv.json").write_text(json.dumps(["--device", "cpu",
                                                    *opts]))
    (tmp_path / "test_argv.json").write_text(json.dumps(
        ["--device", "cpu", "--test", *opts]))
    outs = run_ranks("train", tmp_path, 2)
    out = [json.loads((tmp_path / f"train_{r}.json").read_text())
           for r in range(2)]
    assert out[0]["taken"] == out[1]["taken"] and len(out[0]["taken"]) == 2
    assert [r["loss"] for r in out[0]["records"]] == [
        r["loss"] for r in out[1]["records"]]
    # TransHE tiny: 3 heads keep attention whole at 2 model ranks, so the
    # MLP's 2 all-reduces a block, of 2 blocks
    assert all(r["model_allreduce_count"] == 2 * 2
               for r in out[0]["records"])
    # one data index: the replicated leaves still reduce over both ranks
    assert all(r["grad_allreduce_mb"] > 0 for r in out[0]["records"])
    assert sum("checkpoint: " in o for o in outs) == 1
    reps = [json.loads(o.split("rank report: ", 1)[1].splitlines()[0])
            for o in outs]
    # after 2 updates the replicated parameters are bit-equal on the two
    # model ranks, which hold different TransHE shards
    assert reps[0]["replicated_digest"] == reps[1]["replicated_digest"]
    assert reps[0]["vit_digest"] != reps[1]["vit_digest"]
    path = tmp_path / "tm" / "transhuman" / "transhuman_tpu" / "latest.pth"
    blob = ckpt_io.read_checkpoint(str(path), 2)
    from transhuman_tpu_torch.models.network import TransHumanNet

    net = TransHumanNet(embed_dim=192, vit_depth=2, vit_heads=3)
    weights.load_reference_state_dict(net, blob["net"])
    assert blob["net"]["ViT.blocks.0.mlp.fc1.weight"].shape == (768, 192)
    assert out[0]["summary"] == out[1]["summary"]
    assert out[0]["val"] == out[1]["val"]
