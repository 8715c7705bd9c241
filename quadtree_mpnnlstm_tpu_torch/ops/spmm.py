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
``pallas_call`` instead). Window overflow (a tile with more than EB edges,
or a source span wider than SW) is counted into the graph's ``overflow``.

Dispatch is by device: a CUDA tensor launches the kernel (and raises if it
cannot be built or launched); a CPU tensor runs the plain version. Each
kernel launch adds one to :data:`LAUNCHES`.

``spmm_apply`` is differentiable in z through :class:`SpmmApply`, whose
backward (K2b) launches the same kernel on the cotangent: Â is symmetric
(both directions of every edge are materialised with the same weight), so
``Âᵀ g = Â g``, as in the JAX package's VJP. Â itself carries no
gradient: the blocks are built from detached windows.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

# kernel launches since the last reset_launch_counts(), by wrapper name
LAUNCHES = {"spmm_build_blocks": 0, "spmm_apply": 0, "spmm_apply_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    blocks: torch.Tensor  # (B, T, NT, SW) f32
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


def build_blocks_plain(src_rel, dst_rel, coeff, live, nt: int, sw: int) -> torch.Tensor:
    """K1's function in plain PyTorch: zeros, then ``index_put_`` with
    accumulation of every slot whose source and destination fall inside
    the window, on live tiles only."""
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
    return blocks


def apply_plain(z, s0, blocks, live, n_max: int, nt: int, sw: int) -> torch.Tensor:
    """K2's function in plain PyTorch: gather each tile's source window of
    ``z`` (rows at or past ``n_max`` read as zero), one batched product,
    dead tiles zeroed."""
    b, t = s0.shape
    f = z.shape[-1]
    rows = s0.long()[..., None] + torch.arange(sw, device=z.device)  # (B, T, SW)
    inside = rows < n_max
    rows = rows.clamp_max(n_max - 1).reshape(b, t * sw, 1).expand(b, t * sw, f)
    zwin = torch.gather(z, 1, rows).reshape(b, t, sw, f) * inside[..., None]
    out = torch.bmm(blocks.reshape(b * t, nt, sw), zwin.reshape(b * t, sw, f))
    alive = torch.arange(t, device=z.device)[None, :] < live[:, None]
    out = out.reshape(b, t, nt, f) * alive[..., None, None]
    return out.reshape(b, t * nt, f)[:, :n_max]


# ------------------------------------------------------- CUDA kernels


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


def _build_blocks_cuda(src_rel, dst_rel, coeff, live, nt: int, sw: int) -> torch.Tensor:
    """Launch K1 (``qtm_spmm_build_blocks``): one CTA per (sample, tile)."""
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    b, t, eb = src_rel.shape
    for x, name, dt in ((src_rel, "src_rel", torch.int32), (dst_rel, "dst_rel", torch.int32),
                        (coeff, "coeff", torch.float32)):
        _check(x, name, dt, (b, t, eb))
    _check(live, "live", torch.int32, (b,))
    blocks = torch.empty((b, t, nt, sw), dtype=torch.float32, device=src_rel.device)
    if b * t == 0:
        return blocks
    err = lib.qtm_spmm_build_blocks(
        _ptr(src_rel), _ptr(dst_rel), _ptr(coeff), _ptr(live), _ptr(blocks),
        b, t, eb, nt, sw, _stream(),
    )
    _raise_on(err, "spmm_build_blocks")
    LAUNCHES["spmm_build_blocks"] += 1
    return blocks


def _launch_apply(z, s0, blocks, live, n_max: int, nt: int, sw: int, counter: str):
    """Launch ``qtm_spmm_apply`` (one CTA per (sample, tile, 64-row slab,
    32-column chunk of F)) and count it under ``counter``."""
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    b, t = s0.shape
    f = z.shape[-1]
    _check(z, "z", torch.float32, (b, n_max, f))
    _check(s0, "s0", torch.int32, (b, t))
    _check(blocks, "blocks", torch.float32, (b, t, nt, sw))
    _check(live, "live", torch.int32, (b,))
    out = torch.empty((b, n_max, f), dtype=torch.float32, device=z.device)
    if b * t * f == 0:
        return out
    err = lib.qtm_spmm_apply(
        _ptr(z), _ptr(blocks), _ptr(s0), _ptr(live), _ptr(out),
        b, t, nt, sw, n_max, f, _stream(),
    )
    _raise_on(err, counter)
    LAUNCHES[counter] += 1
    return out


def _apply_cuda(z, s0, blocks, live, n_max: int, nt: int, sw: int) -> torch.Tensor:
    """K2: ``Â z``."""
    return _launch_apply(z, s0, blocks, live, n_max, nt, sw, "spmm_apply")


def _apply_bwd_cuda(g, s0, blocks, live, n_max: int, nt: int, sw: int) -> torch.Tensor:
    """K2b: ``Âᵀ g = Â g``, the same kernel on the cotangent."""
    return _launch_apply(g, s0, blocks, live, n_max, nt, sw, "spmm_apply_bwd")


# ------------------------------------------------------- dispatch


def spmm_build_blocks(
    windows: SpmmWindows, nt: int, sw: int, n_nodes: torch.Tensor
) -> SpmmBlocks:
    """K1: densify each tile's edge window into an (NT, SW) Â block.

    Replaces ``spmm_build_blocks``/``_build_kernel`` of
    ``quadtree_mpnnlstm_tpu/ops/pallas_spmm.py``. ``n_nodes`` (B,) bounds
    the live-tile count. Entries are exact coefficient sums. Â is not
    differentiable: windows and node counts are detached on both paths, as
    the JAX package stop-gradients them.
    """
    windows = SpmmWindows(*(w.detach() for w in windows))
    t = windows.src_rel.shape[1]
    live = live_tiles(n_nodes.detach(), t, nt)
    args = (windows.src_rel, windows.dst_rel, windows.coeff, live, nt, sw)
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
    z: (B, n_max, F) f32; differentiable in z.
    """
    return SpmmApply.apply(z, meta.s0, meta.blocks, meta.live, n_max, nt, sw)
