"""Experiment sweep runner.

Counterpart of ``quadtree_mpnnlstm_tpu/parallel/sweep.py``, whose default
script is the port's ``cli/ice_exp.py``. Replaces the reference's SLURM
array jobs (ref submit_ice_test.sh:4-10, one independent process per
forecast month) with a local runner: sequential on one card, or one
subprocess per entry when several cards are available. Results land in
per-experiment directories exactly like the SLURM flow; failures are
isolated per entry."""

from __future__ import annotations

import subprocess
import sys
from typing import Dict, List, Sequence

DEFAULT_MONTHS = (6, 7, 8, 9, 11, 12)  # ref submit_ice_test.sh:4


def sweep_commands(
    months: Sequence[int] = DEFAULT_MONTHS,
    exp: int = 0,
    script: str = "quadtree_mpnnlstm_tpu_torch.cli.ice_exp",
    extra_args: Sequence[str] = (),
) -> List[List[str]]:
    return [
        [sys.executable, "-m", script, "-m", str(m), "-e", str(exp),
         *extra_args]
        for m in months
    ]


def run_sweep(
    months: Sequence[int] = DEFAULT_MONTHS,
    exp: int = 0,
    script: str = "quadtree_mpnnlstm_tpu_torch.cli.ice_exp",
    extra_args: Sequence[str] = (),
    parallel: bool = False,
) -> Dict[int, int]:
    """Run one job per month; returns month → exit code."""
    cmds = sweep_commands(months, exp, script, extra_args)
    results: Dict[int, int] = {}
    if parallel:
        procs = {m: subprocess.Popen(c) for m, c in zip(months, cmds)}
        for m, p in procs.items():
            results[m] = p.wait()
    else:
        for m, c in zip(months, cmds):
            results[m] = subprocess.call(c)
    failed = {m: rc for m, rc in results.items() if rc != 0}
    if failed:
        print(f"sweep finished with failures: {failed}")
    return results


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--months", type=int, nargs="+", default=list(DEFAULT_MONTHS))
    p.add_argument("-e", "--exp", type=int, default=0)
    p.add_argument("--script", default="quadtree_mpnnlstm_tpu_torch.cli.ice_exp")
    p.add_argument("--parallel", action="store_true")
    p.add_argument("rest", nargs="*")
    a = p.parse_args()
    run_sweep(a.months, a.exp, a.script, a.rest, a.parallel)
