"""Masked segment sums over padded, per-sample index lists."""

from __future__ import annotations

import torch


def segment_sum_nodes(
    values: torch.Tensor, ids: torch.Tensor, n_max: int
) -> torch.Tensor:
    """Sum ``values`` (B, L, ...) into ``n_max`` node rows per sample by
    ``ids`` (B, L).

    Ids outside ``[0, n_max)`` (the sentinel ``n_max`` among them) are
    dropped, as JAX's ``segment_sum`` drops them (torch's indexing would
    raise instead): each lands in a scratch row of its own past ``n_max``
    that is sliced off. One row per dropped entry, not one shared discard
    row, because the accumulating ``index_put_`` below sums each row's
    entries serially, and padded edge lists are mostly sentinels.
    ``index_put_(accumulate=True)`` sums in a fixed order (sort-based on
    CUDA); ``index_add_`` uses float atomics there, whose order changes
    from run to run and, amplified through a rollout, moves frames by
    ~1e-4.
    """
    b, length = ids.shape
    rest = values.shape[2:]
    width = n_max + length
    scratch = n_max + torch.arange(length, device=ids.device, dtype=ids.dtype)
    slot = torch.where((ids >= 0) & (ids < n_max), ids, scratch)
    slot = slot + torch.arange(b, device=ids.device, dtype=ids.dtype)[:, None] * width
    out = values.new_zeros((b * width,) + rest)
    out.index_put_((slot.reshape(-1),), values.reshape((b * length,) + rest), accumulate=True)
    return out.view((b, width) + rest)[:, :n_max]
