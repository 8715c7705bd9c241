"""Mesh drawing: the cells' outlines on a matplotlib axis.

Own copy of ``quadtree_mpnnlstm_tpu/eval/plotting.py``; the caller
imports matplotlib.
"""

from __future__ import annotations

import numpy as np


def plot_contours(ax, labels: np.ndarray, color: str = "k", lw: float = 0.5):
    """Draw the boundaries between the labels of a (rows, cols) label image
    (one node id a pixel) onto ``ax``: every vertical and horizontal
    change of label at once."""
    labels = np.asarray(labels)
    vdiff = labels[:, :-1] != labels[:, 1:]
    for i, j in zip(*np.nonzero(vdiff)):
        ax.plot([j + 0.5, j + 0.5], [i - 0.5, i + 0.5], c=color, lw=lw)
    hdiff = labels[:-1, :] != labels[1:, :]
    for i, j in zip(*np.nonzero(hdiff)):
        ax.plot([j - 0.5, j + 0.5], [i + 0.5, i + 0.5], c=color, lw=lw)
