"""Single-process units of the port's data-parallel machinery, with a faked
rank and world size where it takes one (as tests/test_frame_shard.py does
for the JAX package): frame and process sharding, the positioned gather,
the mesh's refusal of a mesh_axis_data that is not the world size, the
local-rank device choice, the evaluator's summarize(write=False), and the
BatchNorm group's scope.  tests/test_torch_parallel.py runs the 2-rank
paths."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from transhuman_tpu.cli.run import _frame_shard
from transhuman_tpu_torch.cli import common
from transhuman_tpu_torch.cli import train as train_cli
from transhuman_tpu_torch.evals.evaluator import (
    Evaluator,
    merge_across_processes,
)
from transhuman_tpu_torch.models.layers import BatchStatNorm, pooled_norms
from transhuman_tpu_torch.parallel import mesh as pm


def test_frame_shard_in_one_process_is_the_identity():
    idx, pos = pm.frame_shard(np.array([5, 9, 2]))
    np.testing.assert_array_equal(idx, [5, 9, 2])
    np.testing.assert_array_equal(pos, [0, 1, 2])


@pytest.mark.parametrize("rank,size", [(0, 3), (1, 3), (2, 3), (1, 2),
                                       (3, 4)])
def test_frame_shard_strides_as_the_jax_cli(monkeypatch, rank, size):
    """Rank r of n takes frames r, r + n, ... with their positions, as
    the JAX CLI's _frame_shard gives process r of n."""
    import jax

    frames = np.arange(100, 107)
    got = pm.frame_shard(frames, pm.DataMesh(rank, size))
    monkeypatch.setattr(jax, "process_count", lambda: size)
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    want = _frame_shard(frames)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_frame_shard_covers_every_frame_once():
    seen = []
    for r in range(4):
        idx, pos = pm.frame_shard(np.arange(11), pm.DataMesh(r, 4))
        np.testing.assert_array_equal(idx, pos)
        seen.extend(pos.tolist())
    assert sorted(seen) == list(range(11))


def test_process_shard_pads_a_tiny_dataset_by_cycling():
    """8 ranks over 3 items: one valid item each, every item taken."""
    got = []
    for r in range(8):
        s = pm.process_shard(3, mesh=pm.DataMesh(r, 8))
        assert s.shape == (1,) and 0 <= int(s[0]) < 3
        got.append(int(s[0]))
    assert set(got) == {0, 1, 2}


def test_process_shard_is_contiguous_and_shuffles_alike_on_every_rank():
    shards = [pm.process_shard(10, np.random.default_rng(5),
                               pm.DataMesh(r, 3)) for r in range(3)]
    assert [len(s) for s in shards] == [4, 4, 4]
    order = np.random.default_rng(5).permutation(10)
    np.testing.assert_array_equal(np.concatenate(shards),
                                  np.resize(order, 12))


def test_gather_positioned_in_one_process_sorts_by_position():
    assert pm.gather_positioned([3.0, 1.0, 2.0], [2, 0, 1]) == [1.0, 2.0,
                                                               3.0]
    assert pm.gather_positioned([], []) == []


def test_merge_positioned_orders_unequal_rank_shares():
    """Rank 0 held frames 0 and 2, rank 1 frame 1 (an empty rank adds
    nothing); a values/positions length mismatch is an error."""
    assert pm.merge_positioned([[0.5, 2.5], [1.5], []],
                               [[0, 2], [1], []]) == [0.5, 1.5, 2.5]
    with pytest.raises(ValueError, match="2 values vs 1 positions"):
        pm.merge_positioned([[1.0, 2.0]], [[0]])


def test_summarize_write_false_touches_nothing(tmp_path):
    d = tmp_path / "results"
    ev = Evaluator(str(d), save_images=False)
    ev.mse, ev.psnr, ev.ssim, ev.ssim_dr1 = [0.1], [10.0], [0.5], [0.4]
    out = ev.summarize(write=False)
    assert out["psnr"] == 10.0 and not d.exists()
    assert merge_across_processes(ev, [0], pm.DataMesh()) is ev


def test_init_distributed_without_torchrun_does_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert pm.init_distributed("gloo") is False
    assert not dist.is_initialized()
    mesh = pm.make_mesh()
    assert (mesh.rank, mesh.size, mesh.distributed) == (0, 1, False)
    pm.barrier(mesh)  # nothing to wait for


def test_make_mesh_refuses_a_data_axis_other_than_the_world(monkeypatch):
    """mesh_axis_data 0 means every rank; the world size is accepted; any
    other value is refused naming both (one process drives one card)."""
    assert pm.make_mesh(0).size == pm.make_mesh(1).size == 1
    with pytest.raises(ValueError, match=r"mesh_axis_data=2 .* 1 process"):
        pm.make_mesh(2)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(dist, "get_world_size", lambda: 4)
    monkeypatch.setattr(dist, "group", type("G", (), {"WORLD": "world"}))
    mesh = pm.make_mesh(4)
    assert (mesh.rank, mesh.size, mesh.group) == (1, 4, "world")
    assert pm.make_mesh(0).size == 4
    with pytest.raises(ValueError, match=r"mesh_axis_data=2 .* 4 process"):
        pm.make_mesh(2)


def test_train_entry_point_refuses_mesh_axis_data_in_one_process(tmp_path):
    with pytest.raises(ValueError, match="mesh_axis_data=2"):
        train_cli.main(["--device", "cpu", "--steps", "1", "dataset",
                        "synthetic", "mesh_axis_data", "2",
                        "trained_model_dir", str(tmp_path / "tm"),
                        "record_dir", str(tmp_path / "rec")])


@pytest.fixture
def two_local_ranks_one_card(monkeypatch):
    """Local rank 1 of 2 under torchrun, on a host with one card."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    return chosen


def test_more_local_ranks_than_cards_is_refused_without_gloo(
        two_local_ranks_one_card):
    with pytest.raises(SystemExit, match="2 local ranks but 1 CUDA card"):
        common.configure_device("cuda", "nccl")
    assert two_local_ranks_one_card == []


def test_gloo_shares_the_cards_round_robin_and_says_so(
        two_local_ranks_one_card, capsys):
    dev = common.configure_device("cuda", "gloo")
    assert dev == torch.device("cuda", 0)
    assert two_local_ranks_one_card == [dev]
    assert "shared round-robin over gloo" in capsys.readouterr().out


def test_each_local_rank_takes_its_own_card(monkeypatch):
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    assert common.configure_device("cuda") == torch.device("cuda", 2)
    # the CPU is the CPU whatever torchrun set
    assert common.configure_device("cpu") == torch.device("cpu")


def test_dist_backend_flag_defaults_to_nccl():
    args, _ = common.parse_args([])
    assert args.dist_backend == "nccl"
    assert common.parse_args(["--dist_backend", "gloo"])[0].dist_backend \
        == "gloo"
    with pytest.raises(SystemExit):
        common.parse_args(["--dist_backend", "mpi"])


def test_norms_pool_only_inside_pooled_norms():
    """The group reaches every BatchStatNorm inside the block and leaves
    with it, also when the block raises; a norm without one computes the
    local statistics."""
    net = torch.nn.Sequential(BatchStatNorm(3), torch.nn.Sequential(
        BatchStatNorm(3)))
    with pooled_norms(net, "g"):
        assert [m.group for m in net.modules()
                if isinstance(m, BatchStatNorm)] == ["g", "g"]
    with pytest.raises(RuntimeError):
        with pooled_norms(net, "g"):
            raise RuntimeError
    assert all(getattr(m, "group", None) is None for m in net.modules())
    x = torch.randn(4, 3, 5, 5)
    y = net[0](x)
    want = (x - x.mean((0, 2, 3), keepdim=True)) / torch.sqrt(
        x.var((0, 2, 3), unbiased=False, keepdim=True) + 1e-5)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
