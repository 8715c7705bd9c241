"""Masked segment primitives over padded, per-sample index lists.

Counterpart of ``quadtree_mpnnlstm_tpu/ops/segment.py``: message
aggregation is a masked segment sum over a fixed-capacity edge list, and
attention normalisation a masked, guarded edge softmax. Node tensors are
(B, n_max, ...), edge tensors (B, e_max, ...); the sentinel id ``n_max``
marks a padded slot and is dropped.

Every segment sum on a CUDA tensor runs on the segment-sum kernel K7
(``ops/segment_sum.py``): :func:`segment_sum_nodes` (edge aggregation,
the pixel→node pooling, node counts, degrees) and the backward of every
gather (:func:`gather_nodes`, behind :func:`gather_src`, :func:`gather_dst`
and ``unflatten``); it launches K7 or raises. A CPU tensor runs the plain
version. The edge softmax's segment max and sum stay plain on both
devices, as the JAX package does not route them, and so do the gathers of
the attention kernels' plain references (``routed=False``). Every sum runs
in a fixed order, so a training step on the card is bit-reproducible.

With a degree cap (``GraphConfig.max_degree``, the JAX package's
``ops/csr.py`` backend) the graph-aware dispatchers keep the JAX
package's CSR semantics over the graph's capped id vectors
(``graph/build.py`` ``degree_cap``): :func:`aggregate_to_dst` sums each
destination's first ``max_degree`` edges and its backward gathers the
cotangent to every edge, truncated ones included (``csr_segment_sum``);
:func:`gather_src`'s backward sums each source's first ``max_degree``
edges in source-sorted order (``gather_src_csr``), :func:`gather_dst`'s
each destination's (``gather_dst_csr``); :func:`edge_softmax_graph`
takes the segment max (fill −1e30) and sum over the capped edges, so a
truncated edge keeps a non-zero α while its message is dropped. K7 sums
over the capped views as over any view, in entry order.
"""

from __future__ import annotations

from typing import Optional

import torch

from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import (
    SegmentView,
    gather_rows_plain,
    segment_sum,
    segment_sum_plain,
)

_NEG_BIG = -1e30


def segment_sum_nodes(
    values: torch.Tensor, ids: torch.Tensor, n_max: int,
    view: Optional[SegmentView] = None,
) -> torch.Tensor:
    """Sum ``values`` (B, L, ...) into ``n_max`` node rows per sample by
    ``ids`` (B, L); ids outside ``[0, n_max)`` are dropped. K7 on a CUDA
    tensor (``view``: the ids' CSR view, when the caller has it), the plain
    version on a CPU one."""
    return segment_sum(values, ids, n_max, view)


class _GatherNodes(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values, ids, n_max: int, view, routed: bool, sum_ids=None):
        ctx.save_for_backward(ids if sum_ids is None else sum_ids)
        ctx.n_max, ctx.view, ctx.routed = n_max, view, routed
        return gather_rows_plain(values, ids, n_max)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        if ctx.routed:
            dx = segment_sum(g, ids, ctx.n_max, ctx.view)
        else:
            dx = segment_sum_plain(g, ids, ctx.n_max)
        return dx, None, None, None, None, None


def gather_nodes(values: torch.Tensor, ids: torch.Tensor, n_max: int,
                 view: Optional[SegmentView] = None, routed: bool = True,
                 sum_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``values[b, ids[b, l]]`` for values (B, n_max, ...) and ids (B, L);
    ids outside ``[0, n_max)`` read zeros.

    The adjoint of :func:`segment_sum_nodes`, and its backward is that sum
    in a fixed order: :func:`segment_sum_nodes` itself (``view``: the CSR
    view of the ids it sums by), or with ``routed`` False the plain version
    on either device (the plain references keep their backward plain). The
    backward sums by ``sum_ids`` when given (a capped id vector), else by
    ``ids``. ``torch.gather``'s own backward scatters with float atomics on
    CUDA, whose order changes from run to run.
    """
    return _GatherNodes.apply(values, ids, n_max, view, routed, sum_ids)


class _PlainCappedSum(torch.autograd.Function):
    """The plain segment sum over capped ids whose backward gathers the
    cotangent by the full ids (``csr_segment_sum`` of the JAX package
    where it stays off the kernels: the capped edge softmax)."""

    @staticmethod
    def forward(ctx, values, ids, full_ids, n_max: int):
        ctx.save_for_backward(full_ids)
        ctx.n_max = n_max
        return segment_sum_plain(values, ids, n_max)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (full_ids,) = ctx.saved_tensors
        return gather_rows_plain(g, full_ids, ctx.n_max), None, None, None


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with 0 where den == 0."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def edge_softmax(logits: torch.Tensor, edge_dst: torch.Tensor, edge_valid: torch.Tensor,
                 n_max: int) -> torch.Tensor:
    """Masked softmax of per-edge logits (B, E, H) over each destination's
    incoming edges. Invalid lanes get exactly 0; empty destinations and
    padded lanes produce no NaN (the ``-1e30`` guard). The maximum is
    detached; the segment max and sum are plain on both devices."""
    b, e, h = logits.shape
    valid = edge_valid[..., None]
    logits = torch.where(valid, logits, _NEG_BIG)
    idx = edge_dst.clamp(0, n_max)[..., None].expand(b, e, h)  # sentinels: bucket n_max
    with torch.no_grad():
        seg_max = logits.new_full((b, n_max + 1, h), float("-inf")).scatter_reduce(
            1, idx, logits, "amax")
        seg_max = seg_max.clamp_min(_NEG_BIG)
    ex = torch.where(valid, torch.exp(logits - torch.gather(seg_max, 1, idx)), 0.0)
    denom = segment_sum_plain(ex, edge_dst, n_max)
    return safe_div(ex, gather_nodes(denom, edge_dst, n_max, routed=False))


# --------------------------------------------------------------------------
# Graph-aware dispatchers over the graph's edge list and its CSR views.
# --------------------------------------------------------------------------


def aggregate_to_dst(messages: torch.Tensor, graph) -> torch.Tensor:
    """Sum per-edge messages (B, E, ...) at destination nodes over the
    graph's dst-sorted edge list; padded slots carry the sentinel and are
    dropped (their messages need not be zero). With a degree cap, each
    destination's first ``max_degree`` edges, and the backward gathers to
    every edge."""
    if graph.max_degree > 0:
        return segment_sum(messages, graph.edge_dst_cap, graph.n_max, graph.dst_cap_view,
                           grad_ids=graph.edge_dst)
    return segment_sum_nodes(messages, graph.edge_dst, graph.n_max, graph.dst_view)


def gather_src(x: torch.Tensor, graph) -> torch.Tensor:
    """``x[edge_src]`` (B, E, ...) with a fixed-order backward (with a
    degree cap: over each source's first ``max_degree`` edges)."""
    if graph.max_degree > 0:
        return gather_nodes(x, graph.edge_src, graph.n_max, graph.src_cap_view,
                            sum_ids=graph.edge_src_cap)
    return gather_nodes(x, graph.edge_src, graph.n_max, graph.src_view)


def gather_dst(x: torch.Tensor, graph) -> torch.Tensor:
    """``x[edge_dst]`` (B, E, ...) with a fixed-order backward (with a
    degree cap: over each destination's first ``max_degree`` edges)."""
    if graph.max_degree > 0:
        return gather_nodes(x, graph.edge_dst, graph.n_max, graph.dst_cap_view,
                            sum_ids=graph.edge_dst_cap)
    return gather_nodes(x, graph.edge_dst, graph.n_max, graph.dst_view)


def edge_softmax_graph(logits: torch.Tensor, graph) -> torch.Tensor:
    """:func:`edge_softmax` over the graph's edge list; with a degree cap
    the JAX package's CSR edge softmax: the segment max (detached, fill
    −1e30) and sum over each destination's first ``max_degree`` edges, the
    sum's backward to every edge and the denominator's gather through
    :func:`gather_dst`; a truncated edge keeps its α. Plain on both
    devices, as :func:`edge_softmax`."""
    n = graph.n_max
    if graph.max_degree == 0:
        return edge_softmax(logits, graph.edge_dst, graph.edge_valid, n)
    b, e, h = logits.shape
    valid = graph.edge_valid[..., None]
    logits = torch.where(valid, logits, _NEG_BIG)
    with torch.no_grad():
        cap_idx = graph.edge_dst_cap.clamp(0, n)[..., None].expand(b, e, h)
        seg_max = logits.new_full((b, n + 1, h), _NEG_BIG).scatter_reduce(
            1, cap_idx, logits, "amax")
    idx = graph.edge_dst.clamp(0, n)[..., None].expand(b, e, h)
    ex = torch.where(valid, torch.exp(logits - torch.gather(seg_max, 1, idx)), 0.0)
    denom = _PlainCappedSum.apply(ex, graph.edge_dst_cap, graph.edge_dst, n)
    return safe_div(ex, gather_nodes(denom, graph.edge_dst, n, routed=False,
                                     sum_ids=graph.edge_dst_cap))
