"""The port's multi-card wiring on the CPU: the data-parallel step over 4
gloo ranks in the configuration of ``__graft_entry__.dryrun_multichip``
(two samples a rank in 2 microbatches, remat, train.cull) against the JAX
package's step on a 4-device ('data',) mesh; the card each rank takes with
a faked card count (configure_device under NCCL, ray_devices, the worker
of ``chip_smoke.py``'s rank jobs, each rank report's card); and
``chip_smoke.py --cards N`` refusing to run on fewer than N cards.

The ranks are subprocesses of tests/_torch_parallel_worker.py (no JAX)
over a ``file://`` rendezvous, each with a timeout, as in
tests/test_torch_parallel.py, whose helpers and bounds this file reuses.
"""

import functools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import _torch_batch_setup as S
from tests.test_torch_parallel import (ROOT, as_step, check_stats,
                                       port_shape, run_ranks)
from transhuman_tpu.render.pipeline import RenderPipeline as JPipeline
from transhuman_tpu.train import step as jstep
from transhuman_tpu_torch.cli import common
from transhuman_tpu_torch.parallel import infer

RANKS = 4
B_LOCAL, ACCUM = 2, 2  # dryrun_multichip: 2 samples a device, accum 2


def jax_dp_step_dryrun(scene, batch):
    """The JAX package's data-parallel step over a RANKS-device ('data',)
    mesh with accum_steps ACCUM, its pipeline culling in training
    (train_cull at capacity 1: every point decoded, the culled ones
    masked, which the port's compacted decode equals) and rematerialising
    the decode, jitter off: (loss, gradients, stats, updated params) as
    tests/test_torch_parallel.py's jax_dp_step gives them."""
    model = scene.jmodel["float32"].clone(axis_name=("batch", "data"))
    pipe = JPipeline(model, scene.cluster, scene.smpl.v_template,
                     n_samples=S.NS, pe_table=scene.table, train_cull=True,
                     train_cull_ratio=1.0, remat=True)
    mesh = Mesh(np.array(jax.devices()[:RANKS]), ("data",))
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
            loss_fn, params, batch, rngs, ACCUM)
        return jax.lax.pmean(loss, "data"), jax.lax.pmean(grads, "data")

    loss, grads = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P("data")), out_specs=(P(), P()),
        check_vma=False))(scene.params, batch)
    tx, _ = jstep.make_optimizer(iters_per_epoch=4)
    train = jstep.make_train_step(pipe, tx, mesh=mesh, perturb=False,
                                  donate=False, accum_steps=ACCUM)
    state, stats = train(jstep.init_state(scene.params, tx), batch, key)
    return (float(loss), S.leaves(grads["params"]),
            {k: float(v) for k, v in stats.items()},
            S.leaves(state.params["params"]))


def test_four_rank_step_in_the_dryrun_configuration_matches_jax(tmp_path):
    """(a) 4 gloo ranks x 2 samples in 2 microbatches each, remat and
    train.cull, against the JAX step on a 4-device mesh in the same
    configuration: the loss, each gradient leaf and the first Adam update
    at the float32 train bounds, the stats (cull_survivors among them)
    equal; every rank ends with the same gradients and weights, and each
    sample folded its global index into the seed."""
    from transhuman_tpu_torch.render.pipeline import fold_in

    scene = S.Scene()
    jb, ts = scene.samples(RANKS * B_LOCAL)
    torch.save({"sd": scene.sd, "vert2cluster": scene.cluster.vert2cluster,
                "shape": port_shape(), "samples": ts, "b_local": B_LOCAL,
                "accum": ACCUM, "train_cull": True, "remat": True},
               tmp_path / "input.pt")
    # the ranks run while JAX compiles and runs its step here
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, "step", tmp_path, RANKS)
        ref = jax_dp_step_dryrun(scene, jb)
        ranks.result()
    res = [torch.load(tmp_path / f"step_{r}.pt", weights_only=False)
           for r in range(RANKS)]
    port = as_step(res[0])
    S.check_f32(port, ref, S.leaves(scene.params["params"]))
    # JAX's step reports no survivor fraction, and no overflow at
    # capacity 1
    stats = dict(port[2])
    assert 0.05 < stats.pop("cull_survivors") < 0.95  # a real cull
    assert stats.pop("overflow") == 0.0 and "overflow" not in ref[2]
    check_stats(stats, ref[2])
    for r in res[1:]:
        assert r["stats"] == res[0]["stats"]
        for k in res[0]["params"]:
            assert torch.equal(r["params"][k], res[0]["params"][k]), k
            assert torch.equal(r["grads"][k], res[0]["grads"][k]), k
    assert all(all(r["norm_groups"]) for r in res)
    # microbatch j of rank r holds its samples j, j + ACCUM, ...: each
    # sample's seed is fold_in(7, r * B_LOCAL + i), however it is split
    for rank, r in enumerate(res):
        assert sorted(r["seeds"]) == sorted(
            fold_in(7, rank * B_LOCAL + i) for i in range(B_LOCAL))
    n = sum(g.numel() for g in res[0]["grads"].values())
    assert res[0]["comm"]["grad_allreduce_mb"] == pytest.approx(n * 4 / 2**20)


@pytest.fixture
def four_cards(monkeypatch):
    """A host with 4 cards: set_device records the cards asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    return chosen


@pytest.mark.parametrize("local", range(RANKS))
def test_each_nccl_rank_takes_its_own_card(four_cards, monkeypatch, local):
    """(b) Under NCCL local rank r of 4 takes cuda:r and makes it current;
    so does the rank worker of chip_smoke.py's multi-rank phases (its
    pipeline stages among them)."""
    import chip_smoke

    monkeypatch.setenv("LOCAL_RANK", str(local))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(RANKS))
    want = torch.device("cuda", local)
    assert common.configure_device("cuda", "nccl") == want
    assert chip_smoke.worker_device("nccl") == want
    assert four_cards == [want, want]


def test_a_fifth_nccl_rank_on_four_cards_is_refused(four_cards,
                                                    monkeypatch):
    """(b) Five local ranks on four cards: NCCL refuses, with the counts,
    and no card is made current."""
    monkeypatch.setenv("LOCAL_RANK", "4")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "5")
    with pytest.raises(SystemExit, match="5 local ranks but 4 CUDA card"):
        common.configure_device("cuda", "nccl")
    assert four_cards == []


def test_ray_shares_of_local_rank_1_take_cards_2_and_3(four_cards,
                                                       monkeypatch):
    """(b) mesh_axis_rays 2 on local rank 1 of 2: its shares on cuda:2
    and cuda:3, the rank itself on cuda:2 (configure_device's rays
    branch)."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert infer.ray_devices("cuda", 2) == [torch.device("cuda", 2),
                                            torch.device("cuda", 3)]
    assert common.configure_device("cuda", "nccl", rays=2) == torch.device(
        "cuda", 2)
    assert four_cards == [torch.device("cuda", 2)]


def test_rank_report_names_the_card(monkeypatch, capsys):
    """(b) A rank's report names the card it made current: index, name,
    UUID and PCI address; a process that never touched a card names
    none."""
    from transhuman_tpu_torch.parallel import DataMesh

    mesh = DataMesh(rank=1, size=4, group=object())
    common.rank_report(mesh, loss=[0.5])
    line = capsys.readouterr().out
    assert json.loads(line.split("rank report: ", 1)[1])["card"] is None

    class Props:
        name = "NVIDIA H100 80GB HBM3"
        uuid = "GPU-1234"
        pci_domain_id, pci_bus_id, pci_device_id = 0, 0x1b, 0

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props)
    common.rank_report(mesh, loss=[0.5])
    rep = json.loads(capsys.readouterr().out.split("rank report: ", 1)[1])
    assert rep["card"] == {"index": 3, "name": "NVIDIA H100 80GB HBM3",
                           "uuid": "GPU-1234", "pci": "0000:1b:00"}
    assert (rep["rank"], rep["world"], rep["loss"]) == (1, 4, [0.5])


def test_chip_smoke_cards_mode_fails_without_the_cards():
    """(c) ``chip_smoke.py --cards 4`` on a host with no card exits
    non-zero, naming the counts, and prints no result line."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py"),
                        "--cards", "4"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert "--cards 4: 0 CUDA card(s) visible, 4 needed" in p.stderr
    assert '"ok"' not in p.stdout and '"kernels"' not in p.stdout


def test_rank_jobs_run_in_one_process_group(tmp_path):
    """chip_smoke.py's rank-job runner (``--dist-worker``) over 2 gloo
    ranks on the CPU, running the default run's phases j and l as
    ``phase_ranks`` lists them (``jl_jobs``: the float32 and bf16 train
    runs, evaluate, visualize and reconstruction on the first run's
    checkpoint, the tensor-parallel float32 and bf16 runs, the pipelined
    TransHE over 2 stages) in one process group, at a tiny size: each job's
    output kept apart per rank, with its seconds and every rank's report;
    the ranks of each train run agree on its losses, the frames split
    between the ranks, the tensor-parallel ranks' replicated digests
    equal; the pipeline's output on each rank the unpipelined TransHE's
    within l2's bound, its stages 0 and 1."""
    import chip_smoke as cs

    worker = os.path.join(ROOT, "tests", "_torch_multicard_worker.py")
    run = str(tmp_path)
    tiny = ["H", "64", "W", "64", "num_class", "20", "vit_depth", "2",
            "N_samples", "8", "patch.size", "6", "patch.N_patches", "2",
            "kmeans_dir", "/nonexistent"]
    jobs = cs.jl_jobs(run)
    for job in jobs:
        if "argv" in job:
            job["argv"] = [("cpu" if a == "cuda" else a)
                           for a in job["argv"]] + tiny
        if job["tag"] == "reconstruction":  # coarse voxels on the CPU
            i = job["argv"].index("voxel_size")
            job["argv"][i + 1] = "0.04,0.04,0.04"
    spec = tmp_path / "jobs.json"
    spec.write_text(json.dumps({"backend": "gloo", "jobs": jobs}))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT", "XLA_FLAGS")}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, worker, str(spec), str(r),
                               "2"], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    reps = {}
    for job in jobs:
        texts = [(tmp_path / f"{job['tag']}.{r}.out").read_text()
                 for r in range(2)]
        assert all(t.rstrip().splitlines()[-1].startswith("job seconds: ")
                   for t in texts)
        reps[job["tag"]] = cs.rank_reports(job["tag"], "".join(texts), 2)
    assert [j["tag"] for j in jobs] == [
        "dp_f32", "dp_bf16", "evaluate", "visualize", "reconstruction",
        "tp_f32", "tp_bf16", "pp2"]
    for tag, steps in (("dp_f32", 1), ("dp_bf16", cs.J_STEPS),
                       ("tp_f32", 1), ("tp_bf16", cs.L_STEPS)):
        a, b = reps[tag]
        assert a["loss"] == b["loss"] and len(a["loss"]) == steps, tag
        assert np.isfinite(a["loss"]).all(), tag
        assert a["card"] is None and b["card"] is None
    assert os.path.isfile(os.path.join(run, "dp.pth"))
    assert (reps["tp_f32"][0]["replicated_digest"]
            == reps["tp_f32"][1]["replicated_digest"])
    assert [r["model_rank"] for r in reps["tp_f32"]] == [0, 1]
    # frames 0, 3, 6 (2 + 1) and 0, 4 (1 + 1)
    assert [r["frames"] for r in reps["evaluate"]] == [2, 1]
    assert [r["frames"] for r in reps["reconstruction"]] == [1, 1]
    assert [r["stage"] for r in reps["pp2"]] == [0, 1]
    net, tok, pe, _ = _tiny_pp_model(cs)
    with torch.no_grad():
        want = net(tok, pe)
    for r in range(2):
        got = torch.load(tmp_path / "pp2" / f"pp_{r}.pt", weights_only=False)
        assert float((got["y"] - want).abs().max()) <= cs.L_PP_ATOL


def _tiny_pp_model(cs):
    """Phase l2's seeded TransHE at the worker's tiny size, on the CPU."""
    import tests._torch_multicard_worker as W

    saved = cs.L_PP
    cs.L_PP = dict(saved, **W.TINY_PP)
    try:
        return cs.pp_model(torch.device("cpu"))
    finally:
        cs.L_PP = saved
