"""Positional-encoding channels: (col/cols, row/rows) appended to images."""

from __future__ import annotations

import torch


def positional_channels(rows: int, cols: int, dtype=torch.float32, device=None):
    """(rows, cols, 2) with channel 0 = col/cols, channel 1 = row/rows."""
    ii = (torch.arange(cols, dtype=dtype, device=device)[None, :] / cols).expand(rows, cols)
    jj = (torch.arange(rows, dtype=dtype, device=device)[:, None] / rows).expand(rows, cols)
    return torch.stack([ii, jj], dim=-1)


def add_positional_encoding(x: torch.Tensor) -> torch.Tensor:
    """Append (x_pos, y_pos) channels to (..., rows, cols, c)."""
    if x.ndim < 3:
        raise ValueError(f"expected (..., rows, cols, c); got {tuple(x.shape)}")
    rows, cols = x.shape[-3], x.shape[-2]
    pos = positional_channels(rows, cols, dtype=x.dtype, device=x.device)
    pos = pos.expand(x.shape[:-1] + (2,))
    return torch.cat([x, pos], dim=-1)
