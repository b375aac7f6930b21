"""The port's profiling hooks (utils/profiling.py) against the JAX
package's (transhuman_tpu/utils/profiling.py), on the CPU: Stopwatch
counts and totals and its summary line, the sink's readback, ``annotate``
as a named range in a torch.profiler trace, ``device_trace``'s chrome
trace."""

import json
import time

import torch

from transhuman_tpu.utils import profiling as jprof
from transhuman_tpu_torch.utils import profiling as prof


def test_stopwatch_counts_and_totals():
    sw = prof.Stopwatch()
    for _ in range(2):
        with sw("render") as sink:
            time.sleep(0.01)
            sink.append(torch.ones(3) * 2)
    with sw("host"):
        pass
    assert sw.counts == {"render": 2, "host": 1}
    assert sw.totals["render"] >= 0.02
    assert 0 <= sw.totals["host"] < sw.totals["render"]
    # the summary line is the JAX Stopwatch's for the same totals
    js = jprof.Stopwatch()
    js.totals, js.counts = dict(sw.totals), dict(sw.counts)
    assert sw.summary() == js.summary()
    assert sw.summary().startswith("host: ")


def test_readback_finds_the_first_tensor_of_a_nest():
    """The sink's last entry may be a nest of outputs (as a step's (state,
    stats)); the readback finds its first tensor, and skips what holds
    none."""
    sw = prof.Stopwatch()
    with sw("nest") as sink:
        sink.append(({"note": "no tensor"}, [None, {"loss": torch.zeros(())}]))
    with sw("empty") as sink:
        sink.append(torch.zeros(0))
    with sw("none") as sink:
        sink.append({"k": 1})
    assert prof._first_tensor(({"a": 1}, [torch.ones(2)])).shape == (2,)
    assert prof._first_tensor([1, "x"]) is None
    assert sw.counts == {"nest": 1, "empty": 1, "none": 1}


def test_annotate_names_a_range_in_the_trace():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with prof.annotate("thp.render_span"):
            torch.ones(8).sum()
    names = {e.key for e in p.key_averages()}
    assert "thp.render_span" in names


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with prof.device_trace(str(tmp_path / "tr")) as sink:
        with prof.annotate("thp.traced_block"):
            sink.append(torch.ones(4) + 1)
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "thp.traced_block" in names
