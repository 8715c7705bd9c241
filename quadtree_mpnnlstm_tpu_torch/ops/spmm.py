"""Â·z over per-tile dense Â blocks: window metadata, two CUDA kernels
(``csrc/spmm.cu``) and their plain PyTorch versions.

Counterpart of ``quadtree_mpnnlstm_tpu/ops/pallas_spmm.py``. Edges are
sorted by destination and node ids are raster-ordered quadtree anchors, so
the edges of a 128-node destination tile are one contiguous window of the
edge list and their sources one contiguous window of node rows. At mesh
build each tile's window is packed (:func:`spmm_tile_meta`) and densified
once into an (NT, SW) block of Â (:func:`spmm_build_blocks`, kernel K1);
every ``Â z`` of that mesh is then one small dense product per live tile
(:func:`spmm_apply`, kernel K2):

    out[t·NT : (t+1)·NT] = blocks[t] @ z[s0[t] : s0[t] + SW]

Everything carries a leading batch axis: each sample has its own mesh, and
one launch serves the whole batch (the JAX package vmaps the
``pallas_call`` instead). A shared mesh (``TrainConfig.shared_mesh``) has
blocks of batch 1 for a z of batch B: K1 builds them once, K2/K2b read
each Â row once for the B·F columns of the batch folded into the
features (z and out in place, no copy), and :func:`apply_plain` reads
them for every sample. Window overflow (a tile with more than EB edges,
or a source span wider than SW) is counted into the graph's ``overflow``.

Dispatch is by device: a CUDA tensor launches the kernel (and raises if it
cannot be built or launched); a CPU tensor runs the plain version. Each
kernel launch adds one to :data:`LAUNCHES` (a bf16 launch to
:data:`LAUNCHES_BF16`). Both kernels have a float32 and a bfloat16 path,
as the JAX package's take the compute dtype: K1 stores the blocks in
``block_dtype`` (each entry its f32 coefficient sum, rounded once), and K2
multiplies bf16 z by bf16 blocks with an f32 accumulator and returns z's
dtype. The plain versions compute in f32 and round once.

``spmm_apply`` is differentiable in z through :class:`SpmmApply`, whose
backward (K2b) launches the same kernel on the cotangent: Â is symmetric
(both directions of every edge are materialised with the same weight), so
``Âᵀ g = Â g``, as in the JAX package's VJP. Â itself carries no
gradient: the blocks are built from detached windows.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

# kernel launches since the last reset_launch_counts(), by wrapper name:
# the f32 kernels' and the bf16 kernels'
LAUNCHES = {"spmm_build_blocks": 0, "spmm_apply": 0, "spmm_apply_bwd": 0}
LAUNCHES_BF16 = dict(LAUNCHES)


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for k in counts:
            counts[k] = 0


def _count(name: str, dtype: torch.dtype) -> None:
    (LAUNCHES_BF16 if dtype == torch.bfloat16 else LAUNCHES)[name] += 1


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _s0_bound(np_: int, sw: int) -> int:
    """Largest source-window start, rounded up to 16 like the JAX package
    (its TPU kernel needs 16-aligned starts; kept so the metadata stays
    bit-identical)."""
    return _round_up(max(np_ - sw, 0), 16)


class SpmmWindows(NamedTuple):
    """Per-node-tile packed edge windows."""

    s0: torch.Tensor       # (B, T) int32 source-window start (16-aligned)
    src_rel: torch.Tensor  # (B, T, EB) int32 src − s0[t]; −1 = no edge
    dst_rel: torch.Tensor  # (B, T, EB) int32 dst − t·NT; −1 = no edge
    coeff: torch.Tensor    # (B, T, EB) f32 Â coefficient per slot


class SpmmBlocks(NamedTuple):
    """Dense per-tile Â blocks of a batch of meshes.

    ``blocks[b, t]`` is the (NT, SW) slice of sample b's Â, rows
    [t·NT, (t+1)·NT), columns [s0[b, t], s0[b, t] + SW). Tiles at or past
    ``live[b] = ⌈n_nodes/NT⌉`` hold only padding nodes: their blocks are
    zero and both kernels skip them.
    """

    s0: torch.Tensor      # (B, T) int32
    blocks: torch.Tensor  # (B, T, NT, SW) f32 or bf16 (the compute dtype)
    live: torch.Tensor    # (B,) int32 live-tile count


# ---------------------------------------------------------------- metadata


def window_geometry(edge_src, edge_dst, n_max, nt, eb, sw):
    """Per-node-tile edge-window geometry (batched ``window_geometry`` of
    the JAX package, bit-identical).

    Args:
      edge_src, edge_dst: (B, E) int64, dst-sorted, sentinel ``n_max``.

    Returns a dict with ``s0`` (B, T), ``src_rel``/``dst_rel`` (B, T, EB)
    window-relative ids (−1 = dead slot), ``in_tile`` (B, T, EB),
    ``flat_idx`` (B, T·EB) edge-list indices of the slots, and ``overflow``
    (B,) counted window misses.
    """
    b, e = edge_dst.shape
    dev = edge_dst.device
    np_ = _round_up(n_max, nt)
    t = np_ // nt
    bases = torch.arange(t + 1, device=dev, dtype=torch.int64) * nt
    bounds = torch.searchsorted(edge_dst.contiguous(), bases.expand(b, t + 1).contiguous())
    starts, ends = bounds[:, :-1], bounds[:, 1:]
    e0 = starts.clamp(0, max(e - 1, 0))

    idx = (e0[..., None] + torch.arange(eb, device=dev)).clamp_max(e - 1)  # (B, T, EB)
    flat = idx.reshape(b, -1)
    src_w = torch.gather(edge_src, 1, flat).reshape(b, t, eb)
    dst_w = torch.gather(edge_dst, 1, flat).reshape(b, t, eb)

    in_tile = (
        (dst_w >= bases[:-1, None])
        & (dst_w < bases[1:, None])
        & (idx < ends[..., None])
    )
    real = in_tile & (src_w < n_max)
    big = 2**30
    src_min = torch.where(real, src_w, big).amin(dim=2)
    src_max = torch.where(real, src_w, -1).amax(dim=2)
    s0 = (torch.where(src_min == big, 0, src_min) & ~15).clamp(0, _s0_bound(np_, sw))

    src_rel = torch.where(real, src_w - s0[..., None], -1)
    dst_rel = torch.where(in_tile, dst_w - bases[:-1, None], -1)

    edge_overflow = (ends - e0 - eb).clamp_min(0).sum(dim=1)
    src_overflow = ((src_max + 1 - (s0 + sw)).clamp_min(0) * (src_max >= 0)).sum(dim=1)
    return dict(
        s0=s0,
        src_rel=src_rel,
        dst_rel=dst_rel,
        in_tile=in_tile,
        flat_idx=flat,
        overflow=edge_overflow + src_overflow,
    )


def spmm_tile_meta(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    coeff: torch.Tensor,
    n_max: int,
    nt: int,
    eb: int,
    sw: int,
) -> Tuple[SpmmWindows, torch.Tensor]:
    """Pack per-tile edge windows; returns (windows, overflow (B,))."""
    geo = window_geometry(edge_src, edge_dst, n_max, nt, eb, sw)
    cf_w = torch.gather(coeff.float(), 1, geo["flat_idx"]).reshape(geo["src_rel"].shape)
    cf_w = torch.where(geo["in_tile"], cf_w, 0.0)
    windows = SpmmWindows(
        s0=geo["s0"].int(),
        src_rel=geo["src_rel"].int(),
        dst_rel=geo["dst_rel"].int(),
        coeff=cf_w,
    )
    return windows, geo["overflow"]


def live_tiles(n_nodes: torch.Tensor, n_tiles: int, nt: int) -> torch.Tensor:
    """(B,) int32 ⌈n_nodes/NT⌉, clipped to the tile count."""
    n = n_nodes.clamp(0, n_tiles * nt)
    return torch.div(n + nt - 1, nt, rounding_mode="floor").int()


# ------------------------------------------------------- plain versions


def build_blocks_plain(src_rel, dst_rel, coeff, live, nt: int, sw: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K1's function in plain PyTorch: zeros, then ``index_put_`` with
    accumulation of every slot whose source and destination fall inside
    the window, on live tiles only, in f32; the blocks are returned in
    ``dtype`` (one rounding)."""
    b, t, eb = src_rel.shape
    blocks = torch.zeros((b, t, nt, sw), dtype=torch.float32, device=src_rel.device)
    tile = torch.arange(t, device=src_rel.device)[None, :, None]
    ok = (
        (src_rel >= 0) & (src_rel < sw) & (dst_rel >= 0) & (dst_rel < nt)
        & (tile < live[:, None, None])
    )
    bi, ti, ei = torch.nonzero(ok, as_tuple=True)
    blocks.index_put_(
        (bi, ti, dst_rel[bi, ti, ei].long(), src_rel[bi, ti, ei].long()),
        coeff[bi, ti, ei],
        accumulate=True,
    )
    return blocks.to(dtype)


def apply_plain(z, s0, blocks, live, n_max: int, nt: int, sw: int) -> torch.Tensor:
    """K2's function in plain PyTorch: gather each tile's source window of
    ``z`` (rows at or past ``n_max`` read as zero), one batched product,
    dead tiles zeroed. The blocks are cast to z's dtype, as the JAX
    package casts them; the product runs in f32 and the result is
    returned in z's dtype (bf16: one rounding). Blocks of batch 1 (a
    shared mesh) serve every sample of z."""
    b, f = z.shape[0], z.shape[-1]
    if s0.shape[0] != b:
        s0, blocks, live = (x.expand((b,) + x.shape[1:]) for x in (s0, blocks, live))
    t = s0.shape[1]
    dtype = z.dtype
    blocks = blocks.to(dtype).float()
    z = z.float()
    rows = s0.long()[..., None] + torch.arange(sw, device=z.device)  # (B, T, SW)
    inside = rows < n_max
    rows = rows.clamp_max(n_max - 1).reshape(b, t * sw, 1).expand(b, t * sw, f)
    zwin = torch.gather(z, 1, rows).reshape(b, t, sw, f) * inside[..., None]
    out = torch.bmm(blocks.reshape(b * t, nt, sw), zwin.reshape(b * t, sw, f))
    alive = torch.arange(t, device=z.device)[None, :] < live[:, None]
    out = out.reshape(b, t, nt, f) * alive[..., None, None]
    return out.reshape(b, t * nt, f)[:, :n_max].to(dtype)


# ------------------------------------------------------- CUDA kernels


# the storage types of the compute dtype that the kernels (K1–K7) take, with
# the suffix of their C entry points
KERNEL_DTYPES = {torch.float32: "", torch.bfloat16: "_bf16"}


def _check(x: torch.Tensor, name: str, dtype, shape) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {err}")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _ptr(x: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(x.data_ptr())


def _build_blocks_cuda(src_rel, dst_rel, coeff, live, nt: int, sw: int,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch K1 (``qtm_spmm_build_blocks``, or ``_bf16`` for bf16 blocks):
    one CTA per (sample, tile)."""
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"spmm_build_blocks stores float32 or bfloat16 blocks, not {dtype}")
    lib = load_library()
    b, t, eb = src_rel.shape
    for x, name, dt in ((src_rel, "src_rel", torch.int32), (dst_rel, "dst_rel", torch.int32),
                        (coeff, "coeff", torch.float32)):
        _check(x, name, dt, (b, t, eb))
    _check(live, "live", torch.int32, (b,))
    blocks = torch.empty((b, t, nt, sw), dtype=dtype, device=src_rel.device)
    if b * t == 0:
        return blocks
    err = getattr(lib, "qtm_spmm_build_blocks" + KERNEL_DTYPES[dtype])(
        _ptr(src_rel), _ptr(dst_rel), _ptr(coeff), _ptr(live), _ptr(blocks),
        b, t, eb, nt, sw, _stream(),
    )
    _raise_on(err, "spmm_build_blocks")
    _count("spmm_build_blocks", dtype)
    return blocks


# K2's geometry (csrc/spmm.cu): threads and warps a CTA, the bytes of Â
# rows a CTA stages at most, the list entries of its pool, and where the
# staged rows start in its shared memory (after the mbarrier, 32 rows'
# counts and offsets and the pool), up to a CTA's 227 KiB
APPLY_THREADS, APPLY_WARPS, APPLY_STAGE_BYTES, APPLY_POOL = 256, 8, 32 * 1024, 512
APPLY_STAGE_AT = _round_up(16 + 8 * 32 + 8 * APPLY_POOL, 128)
APPLY_MAX_SMEM = 227 * 1024


class ApplyPlan(NamedTuple):
    """K2's work on one tile's (NT, SW) block and the columns it feeds."""

    rows_per_unit: int  # R: a CTA (a unit) takes rows [R i, R i + R) of a tile
    slabs: int          # units a tile and mesh
    samples_per_unit: int  # samples whose F columns a unit computes: B on a shared mesh, else 1
    row_stride: int     # a staged row's length: SW rounded up to whole 16-byte vectors
    col_chunks: tuple   # ((c0, c1), ...): a row's columns as one warp compacts them, in order
    vz: int             # consecutive output columns a thread keeps (one load of z)
    per_row: int        # a row's vectors of vz columns, on consecutive threads
    smem_bytes: int     # dynamic shared memory a CTA


@functools.lru_cache(maxsize=None)
def apply_plan(nt: int, sw: int, f: int, itemsize: int = 4, fold: int = 1,
               align: int = 16) -> ApplyPlan:
    """K2's plan for ``itemsize``-byte elements (4: f32, 2: bf16) and
    ``fold`` samples a unit (the batch on a shared mesh, whose B·F columns,
    column j = (sample j // F, feature j % F), one unit computes; 1 on a
    mesh a sample), with z and out aligned to ``align`` bytes. A thread
    keeps ``vz`` consecutive columns of one row: the widest load (up to 16
    bytes) that divides F and the alignment and still spreads a row over
    8 threads, else one column. A unit takes up to 8 rows (a warp a row
    when they are compacted, 32 16-byte vectors at a time, in ascending
    column order), no more than ``APPLY_STAGE_BYTES`` of them and no more
    than its 256 threads walk at once."""
    vec = 16 // itemsize
    stride = _round_up(sw, vec)
    width = fold * f
    vz = next((v for v in (8, 4, 2) if v * itemsize <= min(16, align) and f % v == 0
               and width // v >= 8), 1)
    per_row = width // vz
    rows = max(1, min(APPLY_WARPS, nt, APPLY_STAGE_BYTES // (stride * itemsize),
                      APPLY_THREADS // per_row))
    return ApplyPlan(rows, -(-nt // rows), fold, stride,
                     tuple((c, min(c + 32 * vec, sw)) for c in range(0, sw, 32 * vec)),
                     vz, per_row, APPLY_STAGE_AT + rows * stride * itemsize)


def check_meta_batch(meta_b: int, b: int) -> None:
    """Raise unless a launch's mesh metadata has batch ``b`` (a mesh a
    sample) or 1 (one mesh for the batch, read with a batch stride of 0)."""
    if meta_b not in (1, b):
        raise ValueError(f"mesh metadata of batch {meta_b} cannot serve a batch of {b}")


def _alignment(*xs: torch.Tensor) -> int:
    """The largest power of two up to 16 that divides every address."""
    a = 16
    while any(x.data_ptr() % a for x in xs):
        a //= 2
    return a


def _apply_operands(z, s0, blocks, live, n_max: int, nt: int, sw: int):
    """Check K2's operands; returns (B, metadata batch, tiles, F, the
    output allocated)."""
    if z.dtype not in KERNEL_DTYPES:
        raise TypeError(f"spmm_apply takes float32 or bfloat16 z, not {z.dtype}")
    b, f = z.shape[0], z.shape[-1]
    bm, t = s0.shape
    check_meta_batch(bm, b)
    _check(z, "z", z.dtype, (b, n_max, f))
    _check(s0, "s0", torch.int32, (bm, t))
    _check(blocks, "blocks", z.dtype, (bm, t, nt, sw))
    _check(live, "live", torch.int32, (bm,))
    return b, bm, t, f, torch.empty((b, n_max, f), dtype=z.dtype, device=z.device)


def _launch_apply(z, s0, blocks, live, n_max: int, nt: int, sw: int, counter: str):
    """Launch ``qtm_spmm_apply`` (``_bf16`` for bf16 z) by :func:`apply_plan`:
    a CTA a slab of rows of a tile, of one sample or, on a shared mesh
    (blocks of batch 1), of the batch folded into the columns; count it
    under ``counter``. The blocks must be in z's dtype."""
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    b, bm, t, f, out = _apply_operands(z, s0, blocks, live, n_max, nt, sw)
    if b * t * f == 0:
        return out
    plan = apply_plan(nt, sw, f, z.element_size(), b if bm == 1 else 1, _alignment(z, out))
    if plan.smem_bytes > APPLY_MAX_SMEM:
        raise ValueError(f"spmm_apply stages whole Â rows: SW {sw} needs {plan.smem_bytes} "
                         f"bytes of shared memory a CTA, above {APPLY_MAX_SMEM}")
    err = getattr(load_library(), "qtm_spmm_apply" + KERNEL_DTYPES[z.dtype])(
        _ptr(z), _ptr(blocks), _ptr(s0), _ptr(live), _ptr(out),
        b, bm, t, nt, sw, n_max, f, plan.rows_per_unit, plan.vz, _stream(),
    )
    _raise_on(err, counter)
    _count(counter, z.dtype)
    return out


def _apply_rowwarp_cuda(z, s0, blocks, live, n_max: int, nt: int, sw: int) -> torch.Tensor:
    """The earlier row-a-warp K2 (``csrc/spmm_rowwarp.cu``): the yardstick
    that the staged kernel is timed against and held to bit for bit. No
    path of the port launches it, and it counts no launch."""
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    b, bm, t, f, out = _apply_operands(z, s0, blocks, live, n_max, nt, sw)
    if b * t * f == 0:
        return out
    fpl = next((x for x in (1, 2, 4) if f <= 32 * x), 8)  # output features a lane
    err = getattr(load_library("spmm_rowwarp.cu"),
                  "qtm_spmm_apply_rowwarp" + KERNEL_DTYPES[z.dtype])(
        _ptr(z), _ptr(blocks), _ptr(s0), _ptr(live), _ptr(out),
        b, bm, t, nt, sw, n_max, f, fpl, _stream(),
    )
    _raise_on(err, "spmm_apply_rowwarp")
    return out


def _apply_cuda(z, s0, blocks, live, n_max: int, nt: int, sw: int) -> torch.Tensor:
    """K2: ``Â z``."""
    return _launch_apply(z, s0, blocks, live, n_max, nt, sw, "spmm_apply")


def _apply_bwd_cuda(g, s0, blocks, live, n_max: int, nt: int, sw: int) -> torch.Tensor:
    """K2b: ``Âᵀ g = Â g``, the same kernel on the cotangent."""
    return _launch_apply(g, s0, blocks, live, n_max, nt, sw, "spmm_apply_bwd")


# ------------------------------------------------------- dispatch


def spmm_build_blocks(
    windows: SpmmWindows, nt: int, sw: int, n_nodes: torch.Tensor,
    block_dtype: torch.dtype = torch.float32,
) -> SpmmBlocks:
    """K1: densify each tile's edge window into an (NT, SW) Â block.

    Replaces ``spmm_build_blocks``/``_build_kernel`` of
    ``quadtree_mpnnlstm_tpu/ops/pallas_spmm.py``. ``n_nodes`` (B,) bounds
    the live-tile count. Entries are exact coefficient sums in f32, stored
    in ``block_dtype`` (the compute dtype, as the JAX package's
    ``block_dtype=data.dtype``). Â is not differentiable: windows and node
    counts are detached on both paths, as the JAX package stop-gradients
    them.
    """
    windows = SpmmWindows(*(w.detach() for w in windows))
    t = windows.src_rel.shape[1]
    live = live_tiles(n_nodes.detach(), t, nt)
    args = (windows.src_rel, windows.dst_rel, windows.coeff, live, nt, sw, block_dtype)
    if windows.src_rel.is_cuda:
        blocks = _build_blocks_cuda(*args)
    else:
        blocks = build_blocks_plain(*args)
    return SpmmBlocks(s0=windows.s0, blocks=blocks, live=live)


class SpmmApply(torch.autograd.Function):
    """``Â z`` with the backward ``Â g`` (K2b). Each direction launches its
    kernel on a CUDA tensor and runs :func:`apply_plain` on a CPU tensor.
    No gradient reaches the blocks, as the JAX VJP returns None for them."""

    @staticmethod
    def forward(ctx, z, s0, blocks, live, n_max: int, nt: int, sw: int):
        ctx.save_for_backward(s0, blocks, live)
        ctx.geometry = (n_max, nt, sw)
        apply = _apply_cuda if z.is_cuda else apply_plain
        return apply(z.contiguous(), s0, blocks, live, n_max, nt, sw)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        s0, blocks, live = ctx.saved_tensors
        apply = _apply_bwd_cuda if g.is_cuda else apply_plain
        dz = apply(g.contiguous(), s0, blocks, live, *ctx.geometry)
        return dz, None, None, None, None, None, None


def spmm_apply(z: torch.Tensor, meta: SpmmBlocks, n_max: int, nt: int, sw: int) -> torch.Tensor:
    """K2: ``out[b, n] = Σ_{e: dst_e = n} coeff_e · z[b, src_e]``, i.e. ``Â z``
    for every sample, from the blocks of :func:`spmm_build_blocks`.

    Replaces ``spmm_apply`` (``_spmm_impl``/``_apply_kernel`` forward,
    ``_spmm_bwd`` backward) of ``quadtree_mpnnlstm_tpu/ops/pallas_spmm.py``.
    z: (B, n_max, F) f32 or bf16, returned in z's dtype; differentiable in
    z.
    """
    return SpmmApply.apply(z, meta.s0, meta.blocks, meta.live, n_max, nt, sw)
