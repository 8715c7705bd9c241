"""Stencil attention on the pixel grid: two CUDA kernels
(``csrc/grid_attn.cu``) and their plain PyTorch versions.

Counterpart of ``quadtree_mpnnlstm_tpu/ops/pallas_grid_attn.py``. On the
identity-mapped pixelwise mesh (``aggregation="grid"``) pixel (r, c)
receives one edge from each of D = 4 (or 8) static directions (dr, dc),
from the pixel (r − dr, c − dc) when that lies on the grid and both ends
are valid; every edge of direction i carries the same edge term ``e_dir[i]
= grid_attr[i] · Wₑ``. For every pixel p and head h (``scale = 1/√d``):

    logit_i = scale · q[p]_h · (k[src_i]_h + e_dir[i]_h)
    α       = softmax over the valid directions (an empty softmax gives 0)
    out[p]_h = Σ_i α_i · keep[i, p, h] · (v[src_i]_h + e_dir[i]_h)

``keep`` holds the dropout keep-scale of every (direction, pixel, head), or
is None for no dropout. q, k, v carry a leading batch axis (B, P, heads·d)
and one launch serves the batch; ``valid`` (P,) is shared by every sample,
as the graph build's mask is.

Dispatch is by device: a CUDA tensor launches the kernel, and raises if it
cannot be built or launched or if the shape is one it does not take (a
head wider than :data:`MAX_D`); a CPU tensor runs the plain version. Any
heads·d runs in one launch of each kernel: a CTA takes one feature group
of whole heads, and heads are independent. There is no fall back: the JAX
package's VMEM and vmap gates are TPU limits. Each kernel launch adds one
to :data:`LAUNCHES` (a bf16 launch to :data:`LAUNCHES_BF16`).

q, k, v, ``e_dir`` and ``valid`` (and the cotangent) are float32 or
bfloat16, all in one dtype; ``keep`` stays float32. In bf16 both kernels
and their plain versions widen the operands to f32, compute in f32 in the
f32 order and round each output (out, dq, dk, dv) to bf16 once;
``de_dir`` is summed in f32 and then cast, as the JAX package's kernels
do (its dk/dv halos are f32 until their combine).

The forward (K5) takes the layout of :func:`fwd_plan`, by shape: row
bands of column strips at d 32 (:func:`fwd_walks`), each k, v and q row
staged once a band in its storage type while the row before it computes;
or pixel tiles staged in f32 at every other d (the port's paths: d 1).

:class:`GridAttnApply` makes the aggregation differentiable in q, k, v and
``e_dir`` on both devices: its backward (K6) walks row bands of column
strips (:func:`bwd_plan`), computes each pixel's α once, writes dq, dk and
dv (dk and dv gathered at the opposite offsets) and one ``de_dir`` partial
a CTA, which the last CTA of each feature group sums in a fixed order, so
a training step is bit-reproducible. ``valid`` and ``keep`` get no gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from quadtree_mpnnlstm_tpu_torch.ops import spmm
from quadtree_mpnnlstm_tpu_torch.ops.grid import neighbor_valid, shift_in, shifts_for

# kernel launches since the last reset_launch_counts(), by wrapper name:
# the f32 kernels' and the bf16 kernels'
LAUNCHES = {"grid_attn_apply": 0, "grid_attn_apply_bwd": 0}
LAUNCHES_BF16 = dict(LAUNCHES)

# the widest head the kernels take (csrc/grid_attn.cu kMaxD); heads·d is
# not bounded: a launch takes every feature group
MAX_D = 256
# K5's pixel tile (rows, cols) by the larger of the lanes a pixel takes
# (heads of a group × lanes a head) and an eighth of the group's width: the
# largest value each tile serves, so that a CTA has work for its 256
# threads and its shared memory stays small.
FWD_TILES = ((1, (8, 32)), (2, (8, 16)), (4, (8, 8)), (8, (4, 8)), (16, (4, 4)), (32, (2, 4)))
# K5's row walk (csrc/grid_attn.cu): rows in flight beyond the rows in use
# (kFwdStages), ring slots of k/v and q rows, and the threads a strip
# is sized for
FWD_STAGES = 1
FWD_KV_SLOTS, FWD_Q_SLOTS = FWD_STAGES + 3, FWD_STAGES + 1
FWD_THREADS = 128
# K6 (csrc/grid_attn.cu): rows in flight beyond the rows in use (kStages),
# ring slots of k/v, q/g/keep and (dlogit, used) rows, and the threads a
# strip is sized for
BWD_STAGES = 2
BWD_KV_SLOTS, BWD_QG_SLOTS, BWD_DL_SLOTS = BWD_STAGES + 4, BWD_STAGES + 3, 3
BWD_THREADS = 128
# a K5 or K6 CTA's threads at most (kThreads) and a walk's registers a
# thread at most (``__launch_bounds__(256, 2)``); the card the walks are
# sized for: an H100's multiprocessors and the shared memory of one and of
# one CTA
MAX_THREADS, KERNEL_REGS = 256, 128
SMS, SM_SMEM, SMEM_LIMIT = 132, 228 * 1024, 227 * 1024

_NEG_BIG = -1e30


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for k in counts:
            counts[k] = 0


class GridAttnDims(NamedTuple):
    """Static geometry of one aggregation."""

    rows: int
    cols: int
    heads: int
    d: int
    ndirs: int  # 4 or 8 (edges_at_corners)


# ------------------------------------------------------- plain versions


def _scale(d: int) -> float:
    """1/√d rounded to f32, the factor both K5 and its plain version use."""
    return float(np.float32(1.0 / math.sqrt(d)))


def _head_sum(prod: torch.Tensor, d: int) -> torch.Tensor:
    """Sum the last axis (a head's d features) in K5's order: a pairwise
    tree over adjacent features when d divides 32 (the kernel's xor
    butterfly), else in feature order."""
    if 32 % d == 0:
        while prod.shape[-1] > 1:
            prod = prod[..., 0::2] + prod[..., 1::2]
        return prod[..., 0]
    out = prod[..., 0]
    for x in range(1, d):
        out = out + prod[..., x]
    return out


def grid_alpha(q, k, e_dir, valid, dims: GridAttnDims) -> torch.Tensor:
    """The stencil softmax α (B, D, rows, cols, heads) in f32: per pixel
    and head, over the valid directions (0 where none is), with K5's sums
    in K5's order. q, k: (B, P, heads·d); e_dir: (D, heads·d); valid:
    (P,). Differentiable; the max is detached."""
    rows, cols, heads, d, ndirs = dims
    b = q.shape[0]
    q, k, e_dir = (x.float() for x in (q, k, e_dir))
    shifts = shifts_for(ndirs == 8)
    qg, kg = (x.reshape(b, rows, cols, heads, d) for x in (q, k))
    e = e_dir.reshape(ndirs, 1, 1, 1, heads, d)
    valid2d = (valid != 0).reshape(1, rows, cols)
    nbv = torch.stack([neighbor_valid(valid2d, dr, dc) for dr, dc in shifts], dim=1)[..., None]
    logits = torch.stack([_head_sum(qg * (shift_in(kg, dr, dc) + e[i]), d)
                          for i, (dr, dc) in enumerate(shifts)], dim=1)
    logits = torch.where(nbv, logits * _scale(d), _NEG_BIG)  # (B, D, rows, cols, heads)
    mx = logits.amax(dim=1, keepdim=True).clamp_min(_NEG_BIG).detach()
    ex = torch.where(nbv, torch.exp(logits - mx), 0.0)
    den = ex[:, 0]
    for i in range(1, ndirs):
        den = den + ex[:, i]
    den = den[:, None]
    return torch.where(den != 0, ex / torch.where(den != 0, den, 1.0), 0.0)


def grid_attn_plain(q, k, v, e_dir, valid, keep: Optional[torch.Tensor],
                    dims: GridAttnDims) -> torch.Tensor:
    """K5's function in plain PyTorch: the shift/where/softmax chain of the
    JAX package's grid branch (``models/conv.py``), with a detached max.
    Keeps D shifted copies of k and v. Every sum runs in the kernel's order
    (heads as :func:`_head_sum`, directions in order), so that on the card
    the two agree bit for bit. q, k, v: (B, P, heads·d); e_dir:
    (D, heads·d); valid: (P,); keep: (B, D, P, heads) or None. bf16
    operands are widened to f32 and the output is rounded to q's dtype
    once, as the kernel rounds it."""
    rows, cols, heads, d, ndirs = dims
    b = q.shape[0]
    dtype = q.dtype
    q, k, v, e_dir = (x.float() for x in (q, k, v, e_dir))
    shifts = shifts_for(ndirs == 8)
    vg = v.reshape(b, rows, cols, heads, d)
    e = e_dir.reshape(ndirs, 1, 1, 1, heads, d)
    alpha = grid_alpha(q, k, e_dir, valid, dims)
    used = alpha if keep is None else alpha * keep.reshape(alpha.shape)
    out = None
    for i, (dr, dc) in enumerate(shifts):
        term = used[:, i, ..., None] * (shift_in(vg, dr, dc) + e[i])
        out = term if out is None else out + term
    return out.reshape(b, rows * cols, heads * d).to(dtype)


def grid_attn_bwd_plain(q, k, v, e_dir, valid, keep, dims: GridAttnDims, g):
    """K6's function in plain PyTorch: autograd through
    :func:`grid_attn_plain`, recomputed from the saved inputs. Returns
    (dq, dk, dv, de_dir), each in its input's dtype (bf16: the f32 gradient
    rounded once)."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v, e_dir)]
        out = grid_attn_plain(*leaves, valid, keep, dims)
        return torch.autograd.grad(out, leaves, g)


# ------------------------------------------------------- CUDA kernels


def _launch_args(q, k, v, e_dir, valid, keep, dims: GridAttnDims):
    """Check the operands of both kernels: q, k, v, e_dir and valid in one
    dtype, float32 or bfloat16, keep float32. Returns (lib, pointers, ints,
    the entry points' suffix)."""
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    rows, cols, heads, d, ndirs = dims
    b = q.shape[0]
    p, h = rows * cols, heads * d
    if heads < 1 or not 1 <= d <= MAX_D or ndirs not in (4, 8):
        raise ValueError(f"grid attention kernels take heads ≥ 1, 1 ≤ d ≤ {MAX_D} and D in "
                         f"(4, 8); got heads={heads}, d={d}, D={ndirs}")
    if q.dtype not in spmm.KERNEL_DTYPES:
        raise TypeError(f"grid attention kernels take float32 or bfloat16 q, not {q.dtype}")
    check = spmm._check
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        check(x, name, q.dtype, (b, p, h))
    check(e_dir, "e_dir", q.dtype, (ndirs, h))
    check(valid, "valid", q.dtype, (p,))
    if keep is not None:
        check(keep, "keep", torch.float32, (b, ndirs, p, heads))
    ptrs = [spmm._ptr(x) for x in (q, k, v, e_dir, valid)]
    ptrs.append(ctypes.c_void_p(None if keep is None else keep.data_ptr()))
    return (load_library("grid_attn.cu"), ptrs, (b, rows, cols, heads, d, ndirs),
            spmm.KERNEL_DTYPES[q.dtype])


def fwd_lanes(d: int):
    """K5's tile lane split of a head's d features: (run, lanes). Each of
    ``lanes`` lanes sums ``run`` contiguous features as a pairwise tree and
    an xor butterfly over the lanes finishes the tree, which is
    :func:`_head_sum`'s order when d divides 32; else one lane sums all d
    in order (csrc/grid_attn.cu ``fwd_run``)."""
    if 32 % d == 0:
        run = min(d, 8)
        return run, d // run
    return d, 1


def fwd_smem_bytes(dims: GridAttnDims, hpg: int, tr: int, tc: int) -> int:
    """Shared memory of one K5 tile CTA (csrc/grid_attn.cu
    ``fwd_smem_floats``): k and v on the tile's one-pixel halo and q on the
    tile, in f32 rows of the padded stride (bf16 rows are widened as they
    are staged, so a tile's bytes are the same in both dtypes), the group's
    edge terms, the halo's validity and the tile's keep values."""
    gw = hpg * dims.d
    vec4 = 32 % dims.d == 0 and dims.d >= 4  # float4 runs: a stride of 4 mod 8, else odd
    s = gw
    while s % 8 != 4 if vec4 else s % 2 != 1:
        s += 1
    n1, nt = (tr + 2) * (tc + 2), tr * tc
    return 4 * (2 * n1 * s + nt * s + dims.ndirs * gw + n1 + dims.ndirs * nt * hpg)


def walk_smem_bytes(ndirs: int, hpg: int, d: int, itemsize: int, strip: int, band: int) -> int:
    """Shared memory of one K5 row-walk CTA (csrc/grid_attn.cu
    ``walk_layout``): the k and v rings (rows of strip + 2 pixels) and the
    q ring (strip pixels) in the storage type, so a bf16 CTA takes half an
    f32 one's rows; the group's edge terms (f32), the band's validity with
    its halo and its rows' flags; each region 16-byte aligned (the keep
    values go to registers a row ahead)."""
    def up16(x):
        return -(-x // 16) * 16

    row = hpg * d
    at = up16(2 * FWD_KV_SLOTS * (strip + 2) * row * itemsize)
    at += up16(FWD_Q_SLOTS * strip * row * itemsize) + up16(4 * ndirs * row)
    return at + up16((band + 2) * (strip + 2)) + up16(band)


class FwdPlan(NamedTuple):
    """K5's launch: row bands (``walk``) or pixel tiles. A CTA takes
    ``strip`` columns and ``band`` rows of the grid (a tile's, for tiles)
    and one feature group of ``hpg`` whole heads, ``run`` features a thread
    (a lane, for tiles), with ``threads`` threads and ``smem`` bytes of
    shared memory; ``strips`` × ``bands`` CTAs a group and sample."""

    walk: bool
    hpg: int
    run: int
    strip: int
    band: int
    strips: int
    bands: int
    threads: int
    smem: int


def fwd_walks(d: int) -> bool:
    """Whether K5 takes row bands at head width d: at d 32, the width of
    every head on the port's grid paths but the 1-feature head convs. A
    1-feature head keeps the tiles, and so does every other d. That choice
    at d 1 is inferred from K6, whose walk lost to its tiles at H 1 (a
    chain of dependent round trips at a few features a pixel); no K5 walk
    at d 1 was built or timed."""
    return d == 32


def _band_for(rows: int, threads: int, smem_of, base: int) -> int:
    """Rows a band, so that the launch's CTAs (``base`` a band), as many as
    the card holds at once at that CTA's threads, registers and shared
    memory (one wave), each walk one band; ``smem_of(band)`` is a CTA's
    shared memory."""
    band = rows
    for _ in range(2):  # the shared memory depends on the band a little
        slots = max(1, min(2048 // threads, 65536 // (threads * KERNEL_REGS),
                           SM_SMEM // (smem_of(band) + 1024), 32))
        band = max(2, -(-rows // max(1, SMS * slots // base)))
    return -(-rows // -(-rows // band))


@functools.lru_cache(maxsize=None)
def fwd_plan(dims: GridAttnDims, itemsize: int = 4, batch: int = 1) -> FwdPlan:
    """K5's CTA geometry for a ``batch``-sample launch in f32 (``itemsize``
    4) or bf16 (2). A group packs whole heads up to 32 features (one head
    when d > 32), as K6's does. Where :func:`fwd_walks`, the strip is as
    wide as :data:`FWD_THREADS` threads (one a column and run of 8 f32 or
    16 bf16 features), evened over the columns, and the bands fill one wave
    of the card as :func:`bwd_plan`'s do; else the tile follows
    :data:`FWD_TILES`."""
    rows, cols, heads, d, ndirs = dims
    hpg = min(heads, max(1, 32 // d))
    groups = -(-heads // hpg)
    if not fwd_walks(d):
        run, lanes = fwd_lanes(d)
        key = max(hpg * lanes, -(-hpg * d // 8))
        tr, tc = next(tile for width, tile in FWD_TILES if key <= width)
        return FwdPlan(False, hpg, run, tc, tr, -(-cols // tc), -(-rows // tr), MAX_THREADS,
                       fwd_smem_bytes(dims, hpg, tr, tc))
    run = 32 // itemsize  # two 16-byte chunks a thread: 4 f32 or 2 bf16 lanes a head
    runs = hpg * d // run
    strips = -(-cols // min(cols, max(1, FWD_THREADS // runs)))
    strip = -(-cols // strips)
    threads = -(-strip * runs // 32) * 32
    band = _band_for(rows, threads,
                     lambda bh: walk_smem_bytes(ndirs, hpg, d, itemsize, strip, bh),
                     strips * groups * batch)
    return FwdPlan(True, hpg, run, strip, band, strips, -(-rows // band), threads,
                   walk_smem_bytes(ndirs, hpg, d, itemsize, strip, band))


def _grid_attn_fwd_cuda(q, k, v, e_dir, valid, keep, dims: GridAttnDims) -> torch.Tensor:
    """Launch K5 (``qtm_grid_attn_fwd``, or ``_bf16`` for bf16 operands):
    one CTA per (strip × band of pixels, or pixel tile, feature group,
    sample) by :func:`fwd_plan`."""
    lib, ptrs, ints, suffix = _launch_args(q, k, v, e_dir, valid, keep, dims)
    out = torch.empty_like(q)
    plan = fwd_plan(dims, q.element_size(), q.shape[0])
    err = getattr(lib, "qtm_grid_attn_fwd" + suffix)(
        *ptrs, spmm._ptr(out), *ints, int(plan.walk), plan.hpg, plan.strip, plan.band,
        plan.threads, ctypes.c_float(_scale(dims.d)), spmm._stream())
    spmm._raise_on(err, "grid_attn_apply")
    (LAUNCHES_BF16 if suffix else LAUNCHES)["grid_attn_apply"] += 1
    return out


class BwdPlan(NamedTuple):
    """K6's launch: a CTA takes ``strip`` columns and ``band`` rows of the
    grid and one feature group of ``hpg`` whole heads, ``run`` features a
    thread, with ``threads`` threads and ``smem`` bytes of shared memory;
    ``strips`` × ``bands`` CTAs a group and sample."""

    hpg: int
    run: int
    strip: int
    band: int
    strips: int
    bands: int
    threads: int
    smem: int


def bwd_run(d: int, itemsize: int) -> int:
    """K6's features a thread: a 16-byte run (4 f32 or 8 bf16 features)
    where d takes whole runs and a power of two of them (≤ 32) a head; else
    1. Unaligned operands keep the run (and so the order of sums), read and
    written a value at a time."""
    run = 16 // itemsize
    lanes = d // run
    return run if d % run == 0 and lanes & (lanes - 1) == 0 and lanes <= 32 else 1


def bwd_smem_bytes(ndirs: int, hpg: int, d: int, run: int, itemsize: int, strip: int,
                   band: int) -> int:
    """Shared memory of one K6 CTA (csrc/grid_attn.cu ``bwd_layout``): the
    k/v rings (rows of strip + 4 pixels) and q/g rings (strip + 2) in the
    storage type, whose room the de reduction (strip × D × group width,
    f32) reuses; the keep ring, the group's edge terms, the (dlogit, used)
    ring, the band's validity and its row flags, the de sum's chunks; each
    region 16-byte aligned."""
    def up16(x):
        return -(-x // 16) * 16

    gw = hpg * d
    stride = (gw | 1 if run == 1 and itemsize == 4 else gw) * itemsize
    at = up16(2 * BWD_KV_SLOTS * (strip + 4) * stride)
    at = max(at + up16(2 * BWD_QG_SLOTS * (strip + 2) * stride), up16(4 * strip * ndirs * gw))
    at += up16(4 * BWD_QG_SLOTS * ndirs * (strip + 2) * hpg) + up16(4 * ndirs * gw)
    at += up16(8 * BWD_DL_SLOTS * (strip + 2) * hpg * ndirs)
    at += up16((band + 4) * (strip + 4)) + up16(2 * (band + 4))
    return at + 4 * MAX_THREADS + 16


def _bwd_threads(strip: int, hpg: int, d: int, run: int) -> int:
    """Threads of a K6 CTA: one a (column, run) of a row, side columns
    included (the copies and the softmax), whole warps, at most 256."""
    return min(MAX_THREADS, -(-(strip + 2) * (hpg * d // run) // 32) * 32)


@functools.lru_cache(maxsize=None)
def bwd_plan(dims: GridAttnDims, itemsize: int = 4, batch: int = 1) -> BwdPlan:
    """K6's CTA geometry for a ``batch``-sample launch in f32 (``itemsize``
    4) or bf16 (2). A group packs whole heads up to 32 features (one head
    when d > 32). The strip is as wide as 128 threads (one a column and
    run, side columns included) and the shared memory allow, evened over
    the columns: a multiprocessor then holds four CTAs (its registers, at
    128 a thread). The bands split the rows so that the launch's CTAs, as
    many as the card holds at once at that CTA's threads, registers and
    shared memory (one wave), each walk one band: few band edges, whose
    rows are staged and whose softmax is computed twice, and no second
    wave's tail."""
    rows, cols, heads, d, ndirs = dims
    hpg = min(heads, max(1, 32 // d))
    runs = hpg * d // bwd_run(d, itemsize)
    run = hpg * d // runs
    strip = min(cols, max(1, BWD_THREADS // runs - 2))
    while strip > 1 and bwd_smem_bytes(ndirs, hpg, d, run, itemsize, strip, rows) > SMEM_LIMIT:
        strip -= 1
    strips = -(-cols // strip)
    strip = -(-cols // strips)
    threads = _bwd_threads(strip, hpg, d, run)
    band = _band_for(rows, threads,
                     lambda bh: bwd_smem_bytes(ndirs, hpg, d, run, itemsize, strip, bh),
                     strips * -(-heads // hpg) * batch)
    bands = -(-rows // band)
    return BwdPlan(hpg, run, strip, band, strips, bands, threads,
                   bwd_smem_bytes(ndirs, hpg, d, run, itemsize, strip, band))


_DONE = {}  # device -> int32 counters, one a K6 feature group, zero at rest


def _done_counters(device, groups: int) -> torch.Tensor:
    """K6's counters of finished CTAs, one a feature group: zero, and left
    zero by each launch's last CTA of the group (csrc/grid_attn.cu)."""
    buf = _DONE.get(device)
    if buf is None or buf.numel() < groups:
        buf = _DONE[device] = torch.zeros(max(groups, 1024), dtype=torch.int32, device=device)
    return buf


def _grid_attn_bwd_cuda(q, k, v, e_dir, valid, keep, dims: GridAttnDims, g):
    """Launch K6 (``qtm_grid_attn_bwd``, or ``_bf16`` for bf16 operands):
    one CTA per (strip × band of pixels, feature group, sample) by
    :func:`bwd_plan`, at any heads·d; the kernel writes dq, dk, dv and one
    f32 ``de_dir`` partial a CTA, and the last CTA of each feature group
    sums the group's partials in a fixed order and rounds them once.
    Returns (dq, dk, dv, de_dir) in q's dtype."""
    lib, ptrs, ints, suffix = _launch_args(q, k, v, e_dir, valid, keep, dims)
    spmm._check(g, "g", q.dtype, tuple(q.shape))
    b, _, h = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    plan = bwd_plan(dims, q.element_size(), b)
    de_part = torch.empty((b, plan.strips * plan.bands, dims.ndirs, h), dtype=torch.float32,
                          device=q.device)
    de = torch.empty((dims.ndirs, h), dtype=q.dtype, device=q.device)
    err = getattr(lib, "qtm_grid_attn_bwd" + suffix)(
        *ptrs, spmm._ptr(g), spmm._ptr(dq), spmm._ptr(dk), spmm._ptr(dv), spmm._ptr(de_part),
        spmm._ptr(de), spmm._ptr(_done_counters(q.device, -(-dims.heads // plan.hpg))),
        *ints, plan.hpg, plan.run, plan.strip, plan.band, plan.threads,
        ctypes.c_float(_scale(dims.d)), spmm._stream())
    spmm._raise_on(err, "grid_attn_apply_bwd")
    (LAUNCHES_BF16 if suffix else LAUNCHES)["grid_attn_apply_bwd"] += 1
    return dq, dk, dv, de


# ------------------------------------------------------- dispatch


class GridAttnApply(torch.autograd.Function):
    """K5 forward with the K6 backward. Each direction launches its kernel
    on a CUDA tensor and runs its plain version on a CPU tensor. Only
    q, k, v, e_dir (and valid, keep) are saved, not α, which K6
    recomputes; valid and keep get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, e_dir, valid, keep, dims):
        q, k, v, e_dir = (x.contiguous() for x in (q, k, v, e_dir))
        ctx.save_for_backward(q, k, v, e_dir, valid, keep)
        ctx.dims = dims
        if q.is_cuda:
            return _grid_attn_fwd_cuda(q, k, v, e_dir, valid, keep, dims)
        return grid_attn_plain(q, k, v, e_dir, valid, keep, dims)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, e_dir, valid, keep = ctx.saved_tensors
        args = (q, k, v, e_dir, valid, keep, ctx.dims, g.contiguous())
        if g.is_cuda:
            dq, dk, dv, de = _grid_attn_bwd_cuda(*args)
        else:
            dq, dk, dv, de = grid_attn_bwd_plain(*args)
        return dq, dk, dv, de, None, None, None


def grid_attn_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, e_dir: torch.Tensor,
                    valid: torch.Tensor, keep: Optional[torch.Tensor],
                    dims: GridAttnDims) -> torch.Tensor:
    """K5: stencil attention over the pixel grid.

    Replaces ``grid_attn_apply`` (``_fwd_kernel`` forward, ``_bwd_rule`` /
    ``_bwd_kernel`` backward) of
    ``quadtree_mpnnlstm_tpu/ops/pallas_grid_attn.py``. q, k, v: (B,
    rows·cols, heads·d) f32 or bf16; e_dir: (D, heads·d) and valid:
    (rows·cols,) in q's dtype; keep: (B, D, rows·cols, heads) f32 keep-scale
    planes, or None for no dropout. Returns (B, rows·cols, heads·d) in q's
    dtype; differentiable in q, k, v and e_dir.
    """
    return GridAttnApply.apply(q, k, v, e_dir, valid, keep, dims)
