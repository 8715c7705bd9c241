"""Parameter counting."""

from __future__ import annotations

from torch import nn


def get_n_params(model: nn.Module) -> int:
    """Total number of scalars in ``model``'s parameters."""
    return sum(p.numel() for p in model.parameters())
