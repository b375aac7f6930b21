"""The train entry point with ``mesh_axis_rays`` > 1 under torchrun, on 2
gloo ranks on the CPU (tests/_torch_parallel_worker.py through
tests/test_torch_parallel.py's ``run_ranks``): training never reads the
key, as in the JAX package, so its step equals the R = 1 step bit for bit;
``--test`` splits each of the rank's frames over R devices (R entries of
``cpu`` here) and writes the metrics and val stats of one process at
R = 1."""

import json

import numpy as np
import pytest
import torch

from tests._torch_parallel_worker import THREADS
from tests.test_torch_parallel import EVAL_OPTS, run_ranks
from transhuman_tpu_torch.cli import train as train_cli


def _opts(d):
    return [*EVAL_OPTS, "patch.size", "6",
            "patch.N_patches", "2", "ep_iter", "1", "train.epoch", "1",
            "trained_model_dir", str(d / "tm"), "record_dir", str(d / "rec"),
            "result_dir", str(d / "res")]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """R -> (its directory, each rank's train_<rank>.json) of the train
    entry point over 2 gloo ranks at mesh_axis_rays R, one step saved to
    --out, then its --test pass at the same R."""
    runs = {}

    def run(r):
        if r not in runs:
            d = tmp_path_factory.mktemp(f"rays{r}")
            opts = [*_opts(d), "mesh_axis_rays", str(r)]
            (d / "argv.json").write_text(json.dumps(
                ["--device", "cpu", "--out", str(d / "out.pth"), *opts,
                 "mesh_axis_data", "2"]))
            (d / "test_argv.json").write_text(json.dumps(
                ["--device", "cpu", "--test", *opts]))
            run_ranks("train", d, 2)
            runs[r] = (d, [json.loads((d / f"train_{k}.json").read_text())
                           for k in range(2)])
        return runs[r]

    return run


def test_train_step_at_mesh_axis_rays_2_equals_r1_bit_for_bit(two_ranks):
    (d1, one), (d2, two) = two_ranks(1), two_ranks(2)
    for k in range(2):
        assert [r["loss"] for r in two[k]["records"]] == [
            r["loss"] for r in one[k]["records"]], k
        assert two[k]["taken"] == one[k]["taken"]
    w1 = torch.load(d1 / "out.pth", weights_only=False)["net"]
    w2 = torch.load(d2 / "out.pth", weights_only=False)["net"]
    assert sorted(w1) == sorted(w2) and len(w1) > 0
    for name, v in w1.items():
        assert torch.equal(torch.as_tensor(w2[name]), torch.as_tensor(v)), (
            name)


def test_validation_over_two_ranks_of_two_ray_shares_equals_one_process(
        two_ranks, tmp_path):
    """--test at mesh_axis_rays 2 on 2 ranks ([cpu, cpu] each) against one
    process at R = 1 on the same checkpoint: the evaluator's per-frame
    metrics, its summary and the val stats within 1e-9."""
    d2, two = two_ranks(2)
    assert two[0]["summary"] == two[1]["summary"]
    opts = [*_opts(d2), "result_dir", str(tmp_path / "res")]
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)  # the ranks' count: the same sums
    try:
        val, summary = train_cli.main(["--device", "cpu", "--test", *opts,
                                       "mesh_axis_rays", "1"])
    finally:
        torch.set_num_threads(threads)
    assert val.keys() == two[0]["val"].keys() and "img_loss" in val
    for k, v in val.items():
        assert abs(two[0]["val"][k] - v) <= 1e-9, k
    for k, v in summary.items():
        if isinstance(v, float):
            assert abs(two[0]["summary"][k] - v) <= 1e-9, k
    for name in ("mse", "psnr", "ssim"):
        want = np.load(tmp_path / "res" / "epoch_-1" / "debug" /
                       f"{name}.npy")
        got = np.load(d2 / "res" / "epoch_-1" / "debug" / f"{name}.npy")
        assert got.shape == want.shape and want.size == 3, name
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9,
                                   err_msg=name)
