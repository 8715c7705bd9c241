"""``eval/trace_summary.py``: the port's summariser of ``torch.profiler``
Chrome traces (the JAX module reads XPlane protobufs; its tests are
``tests/test_analysis_tools.py``).

A hand-written trace (two files, one nested in a subdirectory) gives exact
totals: device kernels are taken when any exist, else every event;
``plane_filter`` selects by category; ``ProfilerStep#N`` markers, instant
and flow events are skipped; rows come most time first, at most ``top``.
A real CPU trace of a CNN-LSTM forward (written by
``tensorboard_trace_handler``) sums each op's count as the profiler's own
``key_averages`` counts it. An empty directory raises
``FileNotFoundError``.
"""

import json

import pytest
import torch

from quadtree_mpnnlstm_tpu_torch.eval import trace_summary as ts
from quadtree_mpnnlstm_tpu_torch.models.cnnlstm import CNNLSTMSeq2Seq


def _event(name, cat, dur, ph="X"):
    return {"ph": ph, "cat": cat, "name": name, "pid": 0, "tid": 0, "ts": 0.0, "dur": dur}


def _write(path, events, wrapped=True):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events} if wrapped else events))


@pytest.fixture
def trace_dir(tmp_path):
    _write(tmp_path / "host.1.pt.trace.json", [
        _event("ProfilerStep#0", "user_annotation", 900.0),
        _event("aten::mm", "cpu_op", 10.0),
        _event("aten::mm", "cpu_op", 5.5),
        _event("void apply_kernel<float>(ApplyParams<float>)", "kernel", 3.25),
        _event("segment_sum_kernel", "kernel", 1.0),
        {"ph": "s", "cat": "ac2g", "name": "launch", "id": 1, "pid": 0, "tid": 0, "ts": 0.0},
        {"ph": "i", "cat": "cpu_instant_event", "name": "mark", "pid": 0, "tid": 0, "ts": 0.0},
    ])
    _write(tmp_path / "sub" / "host.2.pt.trace.json", [
        _event("void apply_kernel<float>(ApplyParams<float>)", "kernel", 2.75),
        _event("ProfilerStep#1", "gpu_user_annotation", 800.0),
        _event("cudaLaunchKernel", "cuda_runtime", 0.5),
    ], wrapped=False)
    (tmp_path / "notes.json").write_text("{}")  # not a trace
    return tmp_path


def test_hand_written_trace_totals(trace_dir, capsys):
    rows = ts.summarize_trace(str(trace_dir))
    assert rows == [
        ts.OpRow("void apply_kernel<float>(ApplyParams<float>)", 6.0e-3, 2, "kernel"),
        ts.OpRow("segment_sum_kernel", 1.0e-3, 1, "kernel"),
    ]
    host = ts.summarize_trace(str(trace_dir), plane_filter="cpu_op")
    assert host == [ts.OpRow("aten::mm", 15.5e-3, 2, "cpu_op")]
    runtime = ts.summarize_trace(str(trace_dir), top=1, plane_filter="cuda")
    assert runtime == [ts.OpRow("cudaLaunchKernel", 0.5e-3, 1, "cuda_runtime")]
    assert ts.summarize_trace(str(trace_dir), top=1) == rows[:1]
    ts.print_trace_summary(str(trace_dir), top=2)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 3 and "x2" in out[1] and "apply_kernel" in out[1]


def test_host_events_when_no_kernels(tmp_path):
    _write(tmp_path / "a.pt.trace.json", [_event("aten::add", "cpu_op", 2.0),
                                          _event("aten::add", "cpu_op", 2.0),
                                          _event("fwd", "python_function", 7.0),
                                          _event("ProfilerStep#3", "user_annotation", 99.0)])
    rows = ts.summarize_trace(str(tmp_path))
    assert rows == [ts.OpRow("fwd", 7e-3, 1, "python_function"),
                    ts.OpRow("aten::add", 4e-3, 2, "cpu_op")]


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="pt.trace.json"):
        ts.summarize_trace(str(tmp_path))


def test_real_cpu_trace_counts(tmp_path):
    """A CNN-LSTM forward under ``torch.profiler`` on the CPU: the summary
    holds the host ops, each counted as ``key_averages`` counts it."""
    model = CNNLSTMSeq2Seq(1, 4, input_timesteps=2, output_timesteps=2).eval()
    x = torch.rand((1, 2, 8, 8, 1), generator=torch.Generator().manual_seed(0))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(tmp_path))) as prof:
        with torch.no_grad():
            model(x)
    assert len(list(tmp_path.glob("*.pt.trace.json"))) == 1
    rows = {r.name: r for r in ts.summarize_trace(str(tmp_path), top=10**6)}
    averages = {e.key: e.count for e in prof.key_averages()}
    for op in ("aten::conv2d", "aten::lstm", "aten::sigmoid"):
        assert rows[op].count == averages[op] > 0 and rows[op].plane == "cpu_op"
        assert rows[op].total_ms > 0
