"""Array helpers (own copy of ``quadtree_mpnnlstm_tpu/utils/normalize.py``)."""

from __future__ import annotations

import numpy as np


def normalize(arr: np.ndarray) -> np.ndarray:
    """Min-max of each leading index over the axes (0, 2, 3, 4)."""
    lo = np.min(arr, (0, 2, 3, 4))[:, None, None, None]
    hi = np.max(arr, (0, 2, 3, 4))[:, None, None, None]
    return (arr - lo) / (hi - lo)


def gen_x_y(arr, input_ts: int = 1, batch_size: int = 8, num_vars: int = 4):
    """Sliding-window (x, y) batches: x (batch, input_ts, pixels, num_vars)
    and y (batch, pixels, 1), the next frame's first variable; a window
    moves one step a sample, and the last batch that would reach the end
    of ``arr`` is not yielded."""
    i = 0
    while i + batch_size + input_ts < arr.shape[0]:
        xs, ys = [], []
        for _ in range(batch_size):
            xs.append(arr[i:i + input_ts].reshape(input_ts, -1, num_vars))
            ys.append(arr[i + input_ts:i + input_ts + 1].reshape(-1, num_vars))
            i += 1
        yield np.array(xs), np.array(ys)[:, :, :1]
