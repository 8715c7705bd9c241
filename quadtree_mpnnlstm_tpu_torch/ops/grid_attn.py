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
head wider than :data:`MAX_H`); a CPU tensor runs the plain version. Above
:data:`MAX_H` features the kernels run once per group of whole heads
(``ops/attn.py`` :func:`head_groups`), each on its heads' columns and keep
planes; heads are independent, so the groups' outputs side by side are
the call's. There is no fall back: the JAX package's VMEM and vmap gates
are TPU limits. Each kernel launch, each group's too, adds one to
:data:`LAUNCHES` (a bf16 launch to :data:`LAUNCHES_BF16`).

q, k, v, ``e_dir`` and ``valid`` (and the cotangent) are float32 or
bfloat16, all in one dtype; ``keep`` stays float32. In bf16 both kernels
and their plain versions widen the operands to f32, compute in f32 in the
f32 order and round each output (out, dq, dk, dv) to bf16 once;
``de_dir`` is summed in f32 and then cast, as the JAX package's kernels
do (its dk/dv halos are f32 until their combine).

:class:`GridAttnApply` makes the aggregation differentiable in q, k, v and
``e_dir`` on both devices: its backward (K6) recomputes α per pixel tile
and writes dq, dk and dv (dk and dv gathered at the opposite offsets from
the tile's ring) and one ``de_dir`` partial a tile, summed in a fixed
order, so a training step is bit-reproducible. ``valid`` and ``keep`` get
no gradient.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from quadtree_mpnnlstm_tpu_torch.ops import spmm
from quadtree_mpnnlstm_tpu_torch.ops.attn import head_groups
from quadtree_mpnnlstm_tpu_torch.ops.grid import neighbor_valid, shift_in, shifts_for

# kernel launches since the last reset_launch_counts(), by wrapper name:
# the f32 kernels' and the bf16 kernels'
LAUNCHES = {"grid_attn_apply": 0, "grid_attn_apply_bwd": 0}
LAUNCHES_BF16 = dict(LAUNCHES)

# features per pixel the kernels take (csrc/grid_attn.cu kMaxH)
MAX_H = 256
# K5's pixel tile (rows, cols) by the larger of the lanes a pixel takes
# (heads of a group × lanes a head) and an eighth of the group's width: the
# largest value each tile serves, so that a CTA has work for its 256
# threads and its shared memory stays small.
FWD_TILES = ((1, (8, 32)), (2, (8, 16)), (4, (8, 8)), (8, (4, 8)), (16, (4, 4)), (32, (2, 4)))
# K6's pixel tile (rows, cols) by the width of a CTA's feature group: the
# largest group width each tile serves. Smaller groups take larger tiles, so
# that a CTA has work for its 256 threads and its ring costs less.
BWD_TILES = ((2, (8, 32)), (8, (16, 16)), (16, (8, 16)), (32, (8, 8)), (64, (4, 8)),
             (128, (4, 4)), (256, (2, 4)))

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
    if not 1 <= h <= MAX_H or ndirs not in (4, 8):
        raise ValueError(f"grid attention kernels take 1 ≤ heads·d ≤ {MAX_H} and D in (4, 8); "
                         f"got heads·d={h}, D={ndirs}")
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
    """K5's lane split of a head's d features: (run, lanes). Each of
    ``lanes`` lanes sums ``run`` contiguous features as a pairwise tree and
    an xor butterfly over the lanes finishes the tree, which is
    :func:`_head_sum`'s order when d divides 32; else one lane sums all d
    in order (csrc/grid_attn.cu ``fwd_run``)."""
    if 32 % d == 0:
        run = min(d, 8)
        return run, d // run
    return d, 1


def fwd_smem_bytes(dims: GridAttnDims, hpg: int, tr: int, tc: int) -> int:
    """Shared memory of one K5 CTA (csrc/grid_attn.cu ``fwd_smem_floats``):
    k and v on the tile's one-pixel halo and q on the tile, in f32 rows of
    the padded stride (bf16 rows are widened as they are staged, so the
    bytes are the same in both dtypes), the group's edge terms, the halo's
    validity and the tile's keep values."""
    gw = hpg * dims.d
    vec4 = 32 % dims.d == 0 and dims.d >= 4  # float4 runs: a stride of 4 mod 8, else odd
    s = gw
    while s % 8 != 4 if vec4 else s % 2 != 1:
        s += 1
    n1, nt = (tr + 2) * (tc + 2), tr * tc
    return 4 * (2 * n1 * s + nt * s + dims.ndirs * gw + n1 + dims.ndirs * nt * hpg)


@functools.lru_cache(maxsize=None)
def fwd_plan(dims: GridAttnDims):
    """K5's CTA geometry: (heads a feature group, tile rows, tile cols,
    tiles a sample). A group packs whole heads up to 32 features (one head
    when d > 32), as K6's does; the tile follows :data:`FWD_TILES`."""
    hpg = min(dims.heads, max(1, 32 // dims.d))
    key = max(hpg * fwd_lanes(dims.d)[1], -(-hpg * dims.d // 8))
    tr, tc = next(tile for width, tile in FWD_TILES if key <= width)
    return hpg, tr, tc, -(-dims.rows // tr) * -(-dims.cols // tc)


def _grid_attn_fwd_cuda(q, k, v, e_dir, valid, keep, dims: GridAttnDims) -> torch.Tensor:
    """Launch K5 (``qtm_grid_attn_fwd``, or ``_bf16`` for bf16 operands):
    one CTA per pixel tile, feature group and sample (:func:`fwd_plan`)."""
    lib, ptrs, ints, suffix = _launch_args(q, k, v, e_dir, valid, keep, dims)
    out = torch.empty_like(q)
    hpg, tr, tc, _ = fwd_plan(dims)
    err = getattr(lib, "qtm_grid_attn_fwd" + suffix)(
        *ptrs, spmm._ptr(out), *ints, hpg, tr, tc, ctypes.c_float(_scale(dims.d)),
        spmm._stream())
    spmm._raise_on(err, "grid_attn_apply")
    (LAUNCHES_BF16 if suffix else LAUNCHES)["grid_attn_apply"] += 1
    return out


def bwd_plan(dims: GridAttnDims):
    """K6's CTA geometry: (heads a feature group, tile rows, tile cols,
    tiles a sample). A group packs whole heads up to 32 features (one head
    when d > 32)."""
    hpg = min(dims.heads, max(1, 32 // dims.d))
    tr, tc = next(tile for width, tile in BWD_TILES if hpg * dims.d <= width)
    return hpg, tr, tc, -(-dims.rows // tr) * -(-dims.cols // tc)


def _grid_attn_bwd_cuda(q, k, v, e_dir, valid, keep, dims: GridAttnDims, g):
    """Launch K6 (``qtm_grid_attn_bwd``, or ``_bf16`` for bf16 operands:
    one CTA per pixel tile, feature group and sample, which writes dq, dk,
    dv and one f32 ``de_dir`` partial) and sum the partials in a fixed
    order. Returns (dq, dk, dv, de_dir) in q's dtype."""
    lib, ptrs, ints, suffix = _launch_args(q, k, v, e_dir, valid, keep, dims)
    spmm._check(g, "g", q.dtype, tuple(q.shape))
    b, _, h = q.shape
    hpg, tr, tc, tiles = bwd_plan(dims)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    de_part = torch.empty((b, tiles, dims.ndirs, h), dtype=torch.float32, device=q.device)
    err = getattr(lib, "qtm_grid_attn_bwd" + suffix)(
        *ptrs, spmm._ptr(g), spmm._ptr(dq), spmm._ptr(dk), spmm._ptr(dv), spmm._ptr(de_part),
        *ints, hpg, tr, tc, ctypes.c_float(_scale(dims.d)), spmm._stream())
    spmm._raise_on(err, "grid_attn_apply_bwd")
    (LAUNCHES_BF16 if suffix else LAUNCHES)["grid_attn_apply_bwd"] += 1
    return dq, dk, dv, de_part.sum(dim=(0, 1)).to(e_dir.dtype)


# ------------------------------------------------------- head groups


def _group_keep(keep: Optional[torch.Tensor], h0: int, h1: int) -> Optional[torch.Tensor]:
    return None if keep is None else keep[..., h0:h1].contiguous()


def grid_fwd_by_groups(fwd, q, k, v, e_dir, valid, keep, dims: GridAttnDims,
                       limit: int = MAX_H) -> torch.Tensor:
    """``fwd`` (K5's launcher, or the plain version) on the fewest groups of
    whole heads of at most ``limit`` features (``ops/attn.py``
    :func:`head_groups`), each on its heads' columns of q, k, v and
    ``e_dir`` and its keep planes; the outputs side by side. One group is
    the one call, with the operands as given."""
    groups = head_groups(dims.heads, dims.d, limit)
    if len(groups) == 1:
        return fwd(q, k, v, e_dir, valid, keep, dims)
    d = dims.d
    return torch.cat([fwd(*(x[..., h0 * d:h1 * d].contiguous() for x in (q, k, v, e_dir)),
                          valid, _group_keep(keep, h0, h1), dims._replace(heads=h1 - h0))
                      for h0, h1 in groups], dim=-1)


def grid_bwd_by_groups(bwd, q, k, v, e_dir, valid, keep, dims: GridAttnDims, g,
                       limit: int = MAX_H):
    """``bwd`` (K6's launcher, or the plain version) by the head groups of
    :func:`grid_fwd_by_groups`, on each group's columns of the cotangent
    too; dq, dk, dv and ``de_dir`` are the groups' side by side."""
    groups = head_groups(dims.heads, dims.d, limit)
    if len(groups) == 1:
        return bwd(q, k, v, e_dir, valid, keep, dims, g)
    d = dims.d
    parts = [bwd(*(x[..., h0 * d:h1 * d].contiguous() for x in (q, k, v, e_dir)), valid,
                 _group_keep(keep, h0, h1), dims._replace(heads=h1 - h0),
                 g[..., h0 * d:h1 * d].contiguous())
             for h0, h1 in groups]
    return tuple(torch.cat(grads, dim=-1) for grads in zip(*parts))


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
            return grid_fwd_by_groups(_grid_attn_fwd_cuda, q, k, v, e_dir, valid, keep, dims)
        return grid_attn_plain(q, k, v, e_dir, valid, keep, dims)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, e_dir, valid, keep = ctx.saved_tensors
        args = (q, k, v, e_dir, valid, keep, ctx.dims, g.contiguous())
        if g.is_cuda:
            dq, dk, dv, de = grid_bwd_by_groups(_grid_attn_bwd_cuda, *args)
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
