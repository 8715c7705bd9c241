"""Masked losses, MSE or BCE over the unmasked pixels.

Counterpart of ``quadtree_mpnnlstm_tpu/train/losses.py``. The JAX package
evaluates a loss per sample under ``vmap``; here each loss reduces over
the trailing (T, rows, cols, 1) axes, so a batch (B, T, rows, cols, 1)
gives one loss per sample and a single sample a scalar.
"""

from __future__ import annotations

from typing import Optional

import torch

_SAMPLE_AXES = (-4, -3, -2, -1)


def _weights(y: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-pixel weights broadcastable to y (..., rows, cols, 1); mask is
    (rows, cols) bool, True = invalid pixel."""
    if mask is None:
        return torch.ones(y.shape[-3:-1] + (1,), dtype=y.dtype, device=y.device)
    return (~mask.bool()).to(y.dtype)[..., None]


def masked_mse(
    y_hat: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    w = _weights(y, mask)
    num = (((y_hat - y) ** 2) * w).sum(dim=_SAMPLE_AXES)
    den = w.expand(y.shape).sum(dim=_SAMPLE_AXES)
    return num / den


def masked_bce(
    y_hat: torch.Tensor,
    y: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-7,
) -> torch.Tensor:
    w = _weights(y, mask)
    p = y_hat.clamp(eps, 1.0 - eps)
    ll = y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p)
    return -(ll * w).sum(dim=_SAMPLE_AXES) / w.expand(y.shape).sum(dim=_SAMPLE_AXES)


LOSSES = {"MSE": masked_mse, "BCE": masked_bce}
