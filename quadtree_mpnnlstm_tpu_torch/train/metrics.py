"""Training scalars: a JSONL file per run, and TensorBoard on request
(``tensorboard=True``, when torch's ``SummaryWriter`` can be imported; its
import can take many seconds).

Counterpart of ``quadtree_mpnnlstm_tpu/train/metrics.py``. Each run writes
``<run_dir>/<name>_<timestamp>/scalars.jsonl``, one
``{"tag", "value", "step"}`` object a line.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, run_dir: str = "runs", name: str = "experiment",
                 tensorboard: bool = False):
        stamp = time.strftime("%Y%m%d_%H_%M_%S")
        self.dir = os.path.join(run_dir, f"{name}_{stamp}")
        os.makedirs(self.dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.dir, "scalars.jsonl"), "a")
        self._tb = None
        if tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(self.dir)
            except ImportError:
                pass

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n"
        )
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
