"""The train profile summary (transhuman_tpu_torch/train/profile.py) on a
hand-made trace, and the train entry point's profile window on the CPU."""

import json
import os

import pytest
import torch

from transhuman_tpu_torch.cli import train as train_cli
from transhuman_tpu_torch.train.profile import (
    format_summary,
    load_trace,
    summarize_trace,
)


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _trace():
    """One step of 100 us: forward launches two kernels that overlap on the
    device (one nested in the other), backward one K3 kernel from another
    host thread, optimizer a memset; a copy is launched before the step."""
    return {"traceEvents": [
        _x("user_annotation", "train_step.forward", 0, 40),
        _x("user_annotation", "train_step.backward", 40, 50),
        _x("user_annotation", "train_step.optimizer", 90, 10),
        _x("cuda_runtime", "cudaMemcpyAsync", -5, 1, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 10, 1, corr=3),
        _x("cuda_driver", "cuLaunchKernel", 50, 1, corr=4),
        _x("cuda_runtime", "cudaMemsetAsync", 95, 1, corr=5),
        _x("gpu_memcpy", "Memcpy HtoD", 0, 4, corr=1),
        _x("kernel", "ampere_sgemm_128x64_nn", 10, 20, corr=2),
        _x("kernel", "vectorized_elementwise_kernel", 15, 10, corr=3),
        _x("kernel", "dfeat_scatter_kernel", 55, 6, corr=4),
        _x("gpu_memset", "Memset (Device)", 96, 2, corr=5),
        _x("cpu_op", "aten::mm", 5, 3),
    ]}


def test_summary_unions_overlaps_and_splits_phases():
    s = summarize_trace(_trace(), wall_ms=0.1, steps=1)
    # busy: [10, 30) + [55, 61) + [96, 98) = 28 us; the sum counts the
    # nested kernel again (38 us); the copy launched before the step is
    # left out of both
    assert s["busy_ms"] == pytest.approx(0.028)
    assert s["event_sum_ms"] == pytest.approx(0.038)
    assert s["outside_ms"] == pytest.approx(0.004)
    assert s["idle_share"] == pytest.approx(1 - 0.028 / 0.1)
    assert s["phases"] == pytest.approx(
        {"forward": 0.020, "backward": 0.006, "optimizer": 0.002})
    assert s["groups"] == pytest.approx({
        "GEMM": 0.020, "elementwise, reductions, other": 0.010,
        "K3 dfeat_scatter": 0.006, "memcpy / memset": 0.002})
    assert list(s["groups"])[0] == "GEMM"  # largest first
    assert "K3 dfeat_scatter" in format_summary(s)


def test_summary_per_step_and_without_device_events():
    tr = _trace()
    s2 = summarize_trace(tr, wall_ms=0.2, steps=2)
    assert s2["busy_ms"] == pytest.approx(0.014)
    assert s2["wall_ms"] == pytest.approx(0.1)
    cpu_only = {"traceEvents": [e for e in tr["traceEvents"]
                                if e["cat"] in ("user_annotation", "cpu_op")]}
    s0 = summarize_trace(cpu_only, wall_ms=0.1, steps=1)
    assert s0["busy_ms"] == 0.0 and s0["idle_share"] == 1.0
    assert s0["groups"] == {}


def test_train_cli_writes_the_profile_window(tmp_path):
    """A tiny CPU run: the window is the last 4 of 6 steps (steps 5-8 in a
    run that long), and the trace holds the three phase ranges of each."""
    out = str(tmp_path / "prof")
    _, records = train_cli.main([
        "--device", "cpu", "--steps", "6", "--out", str(tmp_path / "t.pth"), "H", "32", "W",
        "32", "num_class", "20", "vit_depth", "1", "N_samples", "4",
        "patch.size", "4", "patch.N_patches", "1", "profile_dir", out,
        "dataset", "synthetic", "trained_model_dir", str(tmp_path / "tm"),
        "record_dir", str(tmp_path / "rec")])
    assert len(records) == 6
    with open(os.path.join(out, "summary.json")) as f:
        s = json.load(f)
    assert s["steps"] == 4 and s["first_step"] == 2
    assert s["busy_ms"] == 0.0  # the CPU run launches no device work
    assert s["wall_ms"] == pytest.approx(
        sum(r["step_s"] for r in records[2:]) * 1e3 / 4)
    names = [e["name"] for e in load_trace(
        os.path.join(out, "train_trace.json.gz"))["traceEvents"]
        if e.get("cat") == "user_annotation"]
    for phase in ("forward", "backward", "optimizer"):
        assert names.count(f"train_step.{phase}") == 4


def test_profile_render_needs_a_card(monkeypatch):
    """The render profiler times and traces the card only: without one it
    stops before building anything; its summary takes its own host range."""
    from transhuman_tpu_torch.tools import profile_render

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA card"):
        profile_render.main(["--compute_dtype", "bfloat16"])
    s = summarize_trace(_trace(), wall_ms=0.1, steps=1,
                        phases=("train_step.forward",))
    assert set(s["phases"]) == {"forward"}
