"""Trace summariser: the top ops of a ``torch.profiler`` trace by
accumulated duration.

Counterpart of ``quadtree_mpnnlstm_tpu/eval/trace_summary.py``, rebuilt on
what ``torch.profiler`` writes: the Chrome-trace JSON files
(``*.pt.trace.json``) of ``torch.profiler.tensorboard_trace_handler(trace_dir)``
or of ``prof.export_chrome_trace(path)`` into ``trace_dir``. The JAX
module reads ``jax.profiler``'s XPlane protobufs; that reader and its proto
import (``_import_xplane_pb2``) have no torch counterpart and are not
ported.

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            on_trace_ready=torch.profiler.tensorboard_trace_handler("/tmp/trace")):
        step(...)
    for row in summarize_trace("/tmp/trace"):
        print(row)
"""

from __future__ import annotations

import collections
import glob
import json
import os
import re
from typing import List, NamedTuple, Optional

# the profiler's per-step markers, skipped as the JAX module skips its
# numeric step names
_STEP_MARKER = re.compile(r"^ProfilerStep#\d+$")


class OpRow(NamedTuple):
    name: str
    total_ms: float
    count: int
    plane: str  # the event category (``kernel``, ``cpu_op``, ...)


def _find_traces(trace_dir: str) -> List[str]:
    return sorted(glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"), recursive=True))


def _complete_events(path: str):
    with open(path) as fh:
        trace = json.load(fh)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def summarize_trace(trace_dir: str, top: int = 25,
                    plane_filter: Optional[str] = None) -> List[OpRow]:
    """Event durations summed by name over every trace under
    ``trace_dir``, most time first, at most ``top`` rows.

    ``plane_filter`` selects events whose category holds it as a
    substring (e.g. ``"kernel"``, ``"cpu_op"``); None takes the device
    kernels (category ``kernel``) when the traces hold any, else every
    event. The profiler's ``ProfilerStep#N`` markers are skipped.
    Durations are accumulated per name: events on several streams or
    threads overlap, so the column can exceed wall-clock time; use it to
    rank, not to add. Raises ``FileNotFoundError`` when the directory
    holds no trace."""
    files = _find_traces(trace_dir)
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json under {trace_dir}")
    events = [e for f in files for e in _complete_events(f)]
    if plane_filter is not None:
        events = [e for e in events if plane_filter in str(e.get("cat", ""))]
    else:
        kernels = [e for e in events if e.get("cat") == "kernel"]
        events = kernels or events

    totals = collections.Counter()
    counts = collections.Counter()
    plane_of = {}
    for e in events:
        name = str(e.get("name", ""))
        if _STEP_MARKER.match(name):
            continue
        totals[name] += float(e["dur"])  # microseconds
        counts[name] += 1
        plane_of.setdefault(name, str(e.get("cat", "")))
    return [OpRow(name, us / 1e3, counts[name], plane_of[name])
            for name, us in totals.most_common(top)]


def print_trace_summary(trace_dir: str, top: int = 25, **kw) -> None:
    rows = summarize_trace(trace_dir, top=top, **kw)
    print(f"top {len(rows)} ops by accumulated time ({trace_dir}):")
    for r in rows:
        print(f"{r.total_ms:10.2f} ms  x{r.count:<7} {r.name[:100]}")
