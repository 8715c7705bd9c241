"""The random draws of a training step, and their view under data
parallelism.

Every dropout keep and scheduled-sampling coin of the models is drawn
here, with the batch as its leading axis. Outside :func:`batch_shard` a
draw is ``torch.rand(shape)`` from the caller's generator. Inside
``batch_shard(rank, world)``, which the data-parallel step
(``train/predictor.py``) holds around a rank's forward and backward, a
draw for the shard's B rows draws the global batch's world·B rows and
keeps the rank's rows ``[rank·B, (rank+1)·B)``. So every rank's generator
advances as one device's does on the global batch, a rank's masks and
coins are the ones one device draws for the same samples, and no two
ranks share a mask (the JAX package splits per-sample keys of the global
batch before it shards, ``train/predictor.py:479-481``). The edge list's
hash keys by the global sample index (:func:`sample_offset`).

The setting is process-wide, not a context variable: a remat replay
draws inside autograd's backward, which runs on another thread. One
process is one rank.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence, Tuple

import torch

_SHARD: Optional[Tuple[int, int]] = None  # (rank, world) inside batch_shard


@contextlib.contextmanager
def batch_shard(rank: int, world: int):
    """Draw as rank ``rank`` of ``world`` equal shards of the global batch."""
    global _SHARD
    prev, _SHARD = _SHARD, (rank, world)
    try:
        yield
    finally:
        _SHARD = prev


def uniform(shape: Sequence[int], generator: torch.Generator, device) -> torch.Tensor:
    """Uniform [0, 1) values of ``shape`` (batch axis first) from
    ``generator``; inside :func:`batch_shard` the rank's rows of the global
    batch's draw."""
    shape = tuple(shape)
    if _SHARD is None:
        return torch.rand(shape, generator=generator, device=device)
    rank, world = _SHARD
    b = shape[0]
    full = torch.rand((world * b, *shape[1:]), generator=generator, device=device)
    return full[rank * b:(rank + 1) * b]


def sample_offset(b: int) -> int:
    """The global index of a shard's first sample, for a shard of ``b``."""
    return 0 if _SHARD is None else _SHARD[0] * b
