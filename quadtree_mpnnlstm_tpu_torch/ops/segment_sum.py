"""Segment sum: one CUDA kernel (``csrc/segment.cu``, K7) and its plain
PyTorch version.

Counterpart of ``quadtree_mpnnlstm_tpu/ops/pallas_segment.py``. For values
(B, L, F) and ids (B, L), one mesh per sample::

    out[b, n] = Σ_{e: ids[b, e] = n} values[b, e]      (n in [0, n_out))

Ids outside ``[0, n_out)`` (the sentinel ``n_out`` among them) are dropped.
Both versions sum each bucket's entries in ascending entry order, starting
from 0, as the accumulating ``index_put_`` does on the card, so there the
kernel and its plain version agree bit for bit. bf16 values are summed in
f32 and each output rounded once, by the kernel and by the plain version
(the JAX package's Pallas kernel rounds at every 512-entry tile).

The kernel reads the ids through a CSR view (:func:`segment_view`): a
stable order of the entries by bucket and each bucket's entry range. It is
built with integer ops once per id vector; the graphs carry the views of
their fixed id vectors (``GraphTensors.pixel_view``, ``dst_view``,
``src_view``), and a call without one builds its own. ``edge_dst`` is
sorted by construction, so its view needs only the offsets. Its launch
geometry is :func:`segment_plan`'s, from F, the dtype, the view's kind,
the row count and the values' alignment (no degree is read on the host).

Dispatch is by device: a CUDA tensor launches the kernel, and raises if it
cannot be built or launched; a CPU tensor runs the plain version. Each
kernel launch adds one to :data:`LAUNCHES` (a bf16 launch to
:data:`LAUNCHES_BF16`). :class:`SegmentSum` is
differentiable in the values on both devices; its backward is the row
gather ``d_values[b, e] = g[b, ids[b, e]]`` (0 for a dropped id), which is
no Pallas kernel in the JAX package either.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quadtree_mpnnlstm_tpu_torch.ops import spmm

# kernel launches since the last reset_launch_counts(): the f32 kernel's
# and the bf16 kernel's
LAUNCHES = {"segment_sum": 0}
LAUNCHES_BF16 = dict(LAUNCHES)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for k in counts:
            counts[k] = 0


class SegmentView(NamedTuple):
    """The CSR view of an id vector (B, L) over ``n_out`` buckets."""

    order: Optional[torch.Tensor]  # (B·L,) int32 entries by bucket, or None: in order
    offsets: torch.Tensor          # (B, n_out + 1) int32 entry ranges, global over B·L


def segment_view(ids: torch.Tensor, n_out: int, sorted_ids: bool = False) -> SegmentView:
    """The CSR view of ``ids`` (B, L): entries of bucket n of sample b are
    ``order[offsets[b, n]:offsets[b, n + 1]]`` in ascending entry order (a
    stable sort). With ``sorted_ids`` the caller promises ascending ids per
    sample, the dropped ones last (the builders' ``edge_dst``), and the
    order is the identity."""
    b, length = ids.shape
    key = torch.where((ids >= 0) & (ids < n_out), ids, n_out)
    order = None
    if not sorted_ids:
        key, perm = torch.sort(key, dim=1, stable=True)
        base = torch.arange(b, device=ids.device)[:, None] * length
        order = (perm + base).to(torch.int32).reshape(-1)
    bounds = torch.arange(n_out + 1, dtype=key.dtype, device=ids.device)
    bounds = bounds.expand(b, n_out + 1).contiguous()
    offsets = torch.searchsorted(key.contiguous(), bounds)
    offsets = offsets + torch.arange(b, device=ids.device)[:, None] * length
    return SegmentView(order, offsets.to(torch.int32))


# ------------------------------------------------------- plain version


def segment_sum_plain(values: torch.Tensor, ids: torch.Tensor, n_out: int) -> torch.Tensor:
    """K7's function in plain PyTorch: ``values`` (B, L, ...) summed into
    ``n_out`` rows per sample by ``ids`` (B, L).

    Dropped ids (outside ``[0, n_out)``, as JAX's ``segment_sum`` drops
    them; torch's indexing would raise instead) each land in a scratch row
    of their own past ``n_out`` that is sliced off. One row per dropped
    entry, not one shared discard row, because the accumulating
    ``index_put_`` below sums each row's entries serially, and padded edge
    lists are mostly sentinels. bf16 values are summed in f32 (an
    accumulating ``index_put_`` on bf16 would round at every add) and the
    result rounded once to their dtype. On CUDA ``index_put_(accumulate=True)``
    sorts the ids stably and sums each bucket in ascending entry order (a
    warp reduction only at F = 1 with 32 or more entries in a bucket);
    ``index_add_`` uses float atomics there, whose order changes from run
    to run and, amplified through a rollout, moves frames by ~1e-4. On the
    CPU it adds serially, in entry order, unless several threads share a
    large input: then with atomics, unless deterministic algorithms are on.
    """
    b, length = ids.shape
    rest = values.shape[2:]
    width = n_out + length
    scratch = n_out + torch.arange(length, device=ids.device, dtype=ids.dtype)
    slot = torch.where((ids >= 0) & (ids < n_out), ids, scratch)
    slot = slot + torch.arange(b, device=ids.device, dtype=ids.dtype)[:, None] * width
    acc = torch.float32 if values.dtype == torch.bfloat16 else values.dtype
    out = values.new_zeros((b * width,) + rest, dtype=acc)
    out.index_put_((slot.reshape(-1),), values.reshape((b * length,) + rest).to(acc),
                   accumulate=True)
    return out.view((b, width) + rest)[:, :n_out].to(values.dtype)


def gather_rows_plain(g: torch.Tensor, ids: torch.Tensor, n_out: int) -> torch.Tensor:
    """The adjoint of the segment sum: ``g[b, ids[b, e]]`` for g (B, n_out,
    F), 0 for a dropped id."""
    lead = ids.shape + (1,) * (g.ndim - 2)
    idx = ids.clamp(0, n_out - 1).reshape(lead).expand(ids.shape + g.shape[2:])
    inside = ((ids >= 0) & (ids < n_out)).reshape(lead)
    return torch.where(inside, torch.gather(g, 1, idx), 0.0)


# ------------------------------------------------------- launch plan

# csrc/segment.cu's limits on a plan (the kernel refuses any other)
SPANS_MAX_F = 16      # kSpanMaxF: the spans layout's widest F
SPANS_MAX_N = 8192    # kSpanMaxN: its most rows a sample (their offsets are staged)
SPAN_PAIRS = 4096     # kSpanCap: a span's entries times F, at most
SPAN_LOADS = 2048     # kSpanThreads · kSpanLoads: a CTA's round of value loads
LANES_PER_LANE = 8    # kPerLane: features a lane of the lanes layout keeps a pass


class SegmentPlan(NamedTuple):
    """K7's launch geometry (``csrc/segment.cu``), as the kernel takes it."""

    route: str  # "spans" (F ≤ 16) or "lanes"
    vec: int    # values a load: spans up to 16 bytes; lanes 8 (bf16) or 1
    span: int   # spans: CSR positions a CTA owns the rows of; lanes: 0
    lanes: int  # lanes: lanes a row; spans: 0


def segment_plan(f: int, itemsize: int, n_out: int, sorted_ids: bool,
                 align: int = 16) -> SegmentPlan:
    """K7's layout for F features of ``itemsize`` bytes (4: f32, 2: bf16)
    over ``n_out`` rows a sample, ids read through a sorted view (no order)
    or not, values (and output) at addresses that are multiples of
    ``align`` (a power of two, at most 16).

    The spans layout takes F ≤ 16 over an unsorted view of at most
    ``SPANS_MAX_N`` rows a sample: a quadtree's pixel→node views, whose
    rows hold 1-64 pixels in an order that depends on the image. Each CTA
    owns the non-empty rows whose entries start in its ``span`` CSR
    positions of a sample, so the work is spread by entries, not rows, on
    any mesh. Its loads take ``vec`` values (the widest power of two of at
    most 16 bytes that divides F and the alignment); ``span`` is the
    largest power of two, at most 1024, whose value loads fit one round of
    ``SPAN_LOADS`` and whose (row, feature) pairs fit ``SPAN_PAIRS``. The
    kernel finds its rows in the offsets on the card; the plan reads no
    degree.

    Every other sum takes the lanes layout: ``lanes`` lanes a row (F, or
    F / 8 with 16-byte bf16 loads, rounded up to a power of two, at most
    32), which walk its entries. Its rows are node degrees (sorted edge
    lists, the degree sums), the pixelwise mesh's rows (one a pixel, at
    most 4 entries), where it runs near the launch floor, or wide (F > 16)
    rows that already give a warp 32 lanes of loads."""
    if f <= SPANS_MAX_F and not sorted_ids and n_out <= SPANS_MAX_N:
        vec = 16 // itemsize
        while f % vec or align % (vec * itemsize):
            vec //= 2
        span = 1024
        while span * (f // vec) > SPAN_LOADS or span * f > SPAN_PAIRS:
            span //= 2
        return SegmentPlan("spans", vec, span, 0)
    vec = LANES_PER_LANE if itemsize == 2 and f % LANES_PER_LANE == 0 and align >= 16 else 1
    width = f // vec
    lanes = (32 if width >= 32 else 16 if width > 8 else 8 if width > 4 else 4 if width > 2
             else width)
    return SegmentPlan("lanes", vec, 0, lanes)


def _alignment(*tensors: torch.Tensor) -> int:
    """The largest power of two, at most 16, that divides every address."""
    align = 16
    for t in tensors:
        while t.data_ptr() % align:
            align //= 2
    return align


# ------------------------------------------------------- CUDA kernel


def _segment_sum_cuda(values: torch.Tensor, ids: torch.Tensor, n_out: int,
                      view: SegmentView) -> torch.Tensor:
    """Launch K7 (``qtm_segment_sum``, or ``_bf16`` for bf16 values) on
    values (B, L, F) in :func:`segment_plan`'s layout; the kernel reads the
    ids (B, L) through their CSR ``view`` alone. The output takes the
    values' dtype."""
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    b, length, f = values.shape
    if values.dtype not in spmm.KERNEL_DTYPES:
        raise TypeError(f"segment_sum takes float32 or bfloat16 values, not {values.dtype}")
    spmm._check(values, "values", values.dtype, (b, length, f))
    if tuple(ids.shape) != (b, length):
        raise ValueError(f"ids must be {(b, length)}, got {tuple(ids.shape)}")
    spmm._check(view.offsets, "offsets", torch.int32, (b, n_out + 1))
    if view.order is not None:
        spmm._check(view.order, "order", torch.int32, (b * length,))
    if b * length >= 2**31:
        raise ValueError(f"segment_sum takes fewer than 2**31 entries, got {b * length}")
    out = torch.empty((b, n_out, f), dtype=values.dtype, device=values.device)
    plan = segment_plan(f, values.element_size(), n_out, view.order is None,
                        _alignment(values, out))
    order = None if view.order is None else view.order.data_ptr()
    entry = "qtm_segment_sum" + spmm.KERNEL_DTYPES[values.dtype]
    err = getattr(load_library("segment.cu"), entry)(
        spmm._ptr(values), order, spmm._ptr(view.offsets), spmm._ptr(out), b, length, n_out,
        f, int(plan.route == "spans"), plan.vec, plan.span, plan.lanes, spmm._stream())
    spmm._raise_on(err, "segment_sum")
    (LAUNCHES_BF16 if values.dtype == torch.bfloat16 else LAUNCHES)["segment_sum"] += 1
    return out


# ------------------------------------------------------- dispatch


class SegmentSum(torch.autograd.Function):
    """K7 on a CUDA tensor, the plain version on a CPU one; the backward
    is the row gather on both. Takes and returns the caller's trailing
    feature axes, so its node is the output's own."""

    @staticmethod
    def forward(ctx, values, ids, n_out: int, view: Optional[SegmentView]):
        ctx.save_for_backward(ids)
        ctx.n_out = n_out
        if not values.is_cuda:
            return segment_sum_plain(values, ids, n_out)
        if view is None:
            view = segment_view(ids, n_out)
        b, length = ids.shape
        flat = values.reshape(b, length, -1).contiguous()
        return _segment_sum_cuda(flat, ids, n_out, view).reshape((b, n_out) + values.shape[2:])

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        return gather_rows_plain(g, ids, ctx.n_out), None, None, None


def segment_sum(values: torch.Tensor, ids: torch.Tensor, n_out: int,
                view: Optional[SegmentView] = None) -> torch.Tensor:
    """K7: ``values`` (B, L, ...) summed into (B, n_out, ...) by ``ids`` (B,
    L); ids outside ``[0, n_out)`` are dropped.

    Replaces ``segment_sum_pallas`` (``_kernel``, its VJP a row gather) of
    ``quadtree_mpnnlstm_tpu/ops/pallas_segment.py``. ``view`` is the ids'
    :func:`segment_view`, built here when None. Differentiable in
    ``values``.
    """
    return SegmentSum.apply(values, ids, n_out, view)
