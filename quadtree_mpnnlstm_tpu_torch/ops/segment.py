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


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, ids, n_max: int):
        ctx.save_for_backward(ids)
        ctx.n_max = n_max
        b, length = ids.shape
        rest = values.shape[2:]
        idx = ids.clamp(0, n_max - 1).reshape((b, length) + (1,) * len(rest))
        out = torch.gather(values, 1, idx.expand((b, length) + rest))
        inside = ((ids >= 0) & (ids < n_max)).reshape(idx.shape)
        return torch.where(inside, out, 0.0)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return segment_sum_nodes(g, ids, ctx.n_max), None, None


def gather_nodes(values: torch.Tensor, ids: torch.Tensor, n_max: int) -> torch.Tensor:
    """``values[b, ids[b, l]]`` for values (B, n_max, ...) and ids (B, L);
    ids outside ``[0, n_max)`` read zeros.

    The adjoint of :func:`segment_sum_nodes`, and its backward is that sum:
    ``torch.gather``'s own backward scatters with float atomics on CUDA,
    whose order changes from run to run.
    """
    return _GatherNodes.apply(values, ids, n_max)
