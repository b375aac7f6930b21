"""The K3 split tool's reading of a train step trace
(transhuman_tpu_torch/tools/k3_split.py::k3_in_trace), on a hand-made
trace: K3's device ms, and the card's idle time inside and just after each
call."""

import gzip
import json

import pytest

from transhuman_tpu_torch.tools.k3_split import k3_in_trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _write(tmp_path, ev):
    path = tmp_path / "trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": ev}, f)
    return str(path)


def test_a_float32_route_call_spans_from_its_sort(tmp_path):
    """Two steps of a call as the float32 form's route makes it: a sort
    (two kernels), elementwise passes and a fill, then K3's three kernels;
    an earlier sort that is not K3's is left out."""
    ev = []
    for t in (0, 1000):
        ev += [
            _x("user_annotation", "train_step.forward", t, 400),
            _x("kernel", "cub::DeviceRadixSortOnesweepKernel", t + 10, 5),
            _x("kernel", "gemm_kernel", t + 50, 20),
            _x("kernel", "DeviceRadixSortHistogramKernel", t + 100, 4),
            _x("kernel", "DeviceRadixSortOnesweepKernel", t + 104, 6),
            _x("kernel", "vectorized_elementwise_kernel", t + 115, 5),
            _x("kernel", "FillFunctor", t + 125, 3),
            _x("kernel", "void (anonymous namespace)::segments_kernel(...)",
               t + 130, 10),
            _x("kernel", "segment_sums_kernel", t + 140, 20),
            _x("kernel", "touched_rows_kernel<true>", t + 160, 10),
            _x("kernel", "gemm_kernel", t + 180, 30),
        ]
    r = k3_in_trace(_write(tmp_path, ev))
    assert r["steps"] == 2 and len(r["calls"]) == 2
    call = r["calls"][0]
    assert call["kernel_ms"] == pytest.approx(0.040)
    # from the sort's start (100) to the last kernel's end (170): busy 4 +
    # 6 + 5 + 3 + 40, idle 12
    assert call["span_ms"] == pytest.approx(0.070)
    assert call["idle_inside_ms"] == pytest.approx(0.012)
    assert call["idle_after_ms"] == pytest.approx(0.010)
    assert r["k3_kernel_ms_per_step"] == pytest.approx(0.040)


def test_a_bf16_call_spans_from_its_keys_kernel(tmp_path):
    """A call as the bf16 form makes it: its keys kernel, the sort (with a
    fill between), a memset, then its three kernels: one call, from the
    keys kernel to the last."""
    ev = [
        _x("user_annotation", "train_step.forward", 0, 400),
        _x("kernel", "DeviceRadixSortOnesweepKernel", 10, 5),
        _x("kernel", "dfeat_scatter_bf16_keys_kernel", 100, 4),
        _x("kernel", "FillFunctor", 106, 2),
        _x("kernel", "DeviceRadixSortOnesweepKernel", 110, 6),
        _x("gpu_memset", "Memset (Device)", 120, 2),
        _x("kernel", "dfeat_scatter_bf16_runs_kernel", 124, 6),
        _x("kernel", "dfeat_scatter_bf16_long_kernel", 130, 20),
        _x("kernel", "dfeat_scatter_bf16_texels_kernel<true>", 150, 30),
        _x("kernel", "gemm_kernel", 185, 30),
    ]
    r = k3_in_trace(_write(tmp_path, ev))
    assert len(r["calls"]) == 1
    call = r["calls"][0]
    assert call["kernel_ms"] == pytest.approx(0.060)
    # 100 to 180: busy 4 + 2 + 6 + 2 + 56, idle 10
    assert call["span_ms"] == pytest.approx(0.080)
    assert call["idle_inside_ms"] == pytest.approx(0.010)
    assert call["idle_after_ms"] == pytest.approx(0.005)
