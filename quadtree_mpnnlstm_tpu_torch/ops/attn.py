"""Fused TransformerConv aggregation over dst-sorted edge windows: window
metadata, two CUDA kernels (``csrc/attn.cu``) and their plain PyTorch
versions.

Counterpart of ``quadtree_mpnnlstm_tpu/ops/pallas_attn.py``. The windows
are the SpMM's (:func:`~quadtree_mpnnlstm_tpu_torch.ops.spmm.window_geometry`):
the edges of a 128-node destination tile are one contiguous, dst-sorted
window of EB slots, and their sources lie in the node rows
``[s0, s0 + SW)``. Per slot the edge attributes are kept, so the edge term
``e = attr · Wₑ`` is computed where it is used. For every destination
node n and head h (with ``scale = 1/√d``):

    logit_j = scale · q[n]_h · (k[src_j]_h + e_j,h)       for the slots j of n
    α_j     = softmax over the slots of n (per head)
    out[n]_h = Σ_j α_j · keep_j,h · (v[src_j]_h + e_j,h)

Rows with no slot, and every row of a dead tile (at or past
``live = ⌈n_nodes/NT⌉``), give 0. ``keep`` holds the dropout keep-scale of
every (slot, head) window entry, or is None for no dropout.

Everything carries a leading batch axis (one mesh per sample, one launch
per batch). A shared mesh (``TrainConfig.shared_mesh``) has windows of
batch 1 for q, k, v of batch B: both kernels read them, and their slot
view, for every sample (a metadata batch stride of 0, no copy), and the
plain versions expand them. Dispatch is by device: a CUDA tensor launches the kernel (and
raises if it cannot be built or launched); a CPU tensor runs the plain
version. Above :data:`MAX_HD` features the kernels run once per group of
whole heads (:func:`head_groups`: the fewest groups that fit, each on its
heads' columns); heads are independent, so the groups' outputs side by
side are the call's. Each kernel launch, each group's too, adds one to
:data:`LAUNCHES` (a bf16 launch to :data:`LAUNCHES_BF16`). K3's launch
geometry is :func:`fwd_plan`'s, a pure function of the widths.

q, k, v and Wₑ (and the cotangent) are float32 or bfloat16, all four in
one dtype; the window attributes and ``keep`` stay float32. In bf16 both
kernels and their plain versions widen the operands to f32, compute in f32
and round each output (out, dq, dk, dv) to bf16 once; dWₑ is summed in f32
and then cast to Wₑ's dtype, as the JAX package's kernels do.

:class:`AttnApply` makes the aggregation differentiable in q, k, v and Wₑ
on both devices: its backward (K4) recomputes α (flash-style), writes dq,
two scalars per slot and head (dlogit·scale and α·keep) and per-CTA dWₑ
partials, then gathers dk and dv per source node over the source-sorted
slot view (:func:`slot_view`, built once per mesh) in a second kernel. No
sum on the card uses float atomics, so a training step is
bit-reproducible. The windows, ``keep`` and the edge attributes carry no
gradient.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from quadtree_mpnnlstm_tpu_torch.ops import spmm
from quadtree_mpnnlstm_tpu_torch.ops.segment import gather_nodes
from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import (
    SegmentView,
    segment_sum_plain,
    segment_view,
)

# kernel launches since the last reset_launch_counts(), by wrapper name:
# the f32 kernels' and the bf16 kernels'
LAUNCHES = {"attn_apply": 0, "attn_apply_bwd": 0}
LAUNCHES_BF16 = dict(LAUNCHES)

# destination rows per CTA of K4's first kernel; feature width and attribute
# columns both kernels accept (csrc/attn.cu kMaxRows, 32 lanes x 16
# features, kMaxA)
ROWS_PER_CTA = 16
MAX_HD = 512
MAX_A = 4
# K3: the compiled (run, chunk) pairs — features a lane holds, slots it
# holds in flight (csrc/attn.cu fwd_instance); warps a CTA at most
# (kFwdMaxWarps); shared memory a CTA may opt into on an H100
FWD_INSTANCES = ((1, 16), (2, 8), (4, 4), (4, 8), (8, 4), (16, 2))
FWD_MAX_WARPS = 8
SMEM_LIMIT = 227 * 1024


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, LAUNCHES_BF16):
        for k in counts:
            counts[k] = 0


class AttnMeta(NamedTuple):
    """Per-tile attention windows of a batch of meshes (constants)."""

    s0: torch.Tensor       # (B, T) int32 source-window start (16-aligned)
    src_rel: torch.Tensor  # (B, T, EB) int32 src − s0[t]; −1 = no edge
    dst_rel: torch.Tensor  # (B, T, EB) int32 dst − t·NT; −1 = no edge
    attr: torch.Tensor     # (B, T, EB, A) f32 edge attributes per slot
    live: torch.Tensor     # (B,) int32 live-tile count


class AttnDims(NamedTuple):
    """Static geometry of one aggregation."""

    n_max: int
    nt: int
    eb: int
    sw: int
    heads: int
    d: int


def attn_tile_meta(
    edge_src: torch.Tensor,
    edge_dst: torch.Tensor,
    edge_attr: torch.Tensor,
    n_max: int,
    nt: int,
    eb: int,
    sw: int,
    n_nodes: torch.Tensor,
) -> Tuple[AttnMeta, torch.Tensor]:
    """Pack per-tile attention windows (batched ``attn_tile_meta`` of the
    JAX package, bit-identical, with the attributes as (B, T, EB, A)
    instead of the TPU's transposed (T, A, EB)). Returns (meta, overflow
    (B,)). Detached: the windows are constants of the mesh."""
    edge_src, edge_dst, edge_attr = edge_src.detach(), edge_dst.detach(), edge_attr.detach()
    geo = spmm.window_geometry(edge_src, edge_dst, n_max, nt, eb, sw)
    b, t, _ = geo["src_rel"].shape
    a = edge_attr.shape[-1]
    flat = geo["flat_idx"]
    attr_w = torch.gather(edge_attr.float(), 1, flat[..., None].expand(b, flat.shape[1], a))
    attr_w = torch.where(geo["in_tile"][..., None], attr_w.reshape(b, t, eb, a), 0.0)
    meta = AttnMeta(
        s0=geo["s0"].int(),
        src_rel=geo["src_rel"].int(),
        dst_rel=geo["dst_rel"].int(),
        attr=attr_w,
        live=spmm.live_tiles(n_nodes.detach(), t, nt),
    )
    return meta, geo["overflow"]


class FwdPlan(NamedTuple):
    """K3's launch geometry (csrc/attn.cu ``attn_fwd_kernel``). An item is
    a destination row's slice of ``heads_item`` heads; a warp holds
    ``items_warp`` items at once (rows a warp when ``slices`` is 1)."""

    run: int          # contiguous features a lane holds (float4s when d % 4 == 0)
    lanes_head: int   # lanes a head: a power of two, lanes_head · run ≥ d
    heads_item: int   # heads an item
    lanes_item: int   # lanes an item: a power of two ≥ heads_item · lanes_head
    slices: int       # items a row: ⌈heads / heads_item⌉
    items_warp: int   # 32 / lanes_item
    warps: int        # warps a CTA
    rows_cta: int     # destination rows a CTA
    chunk: int        # slots a lane has in flight (FWD_INSTANCES)
    groups_sample: int  # row groups a sample (a CTA's unit): tiles × ⌈NT / rows_cta⌉
    vec_bytes: int    # bytes of one load of a lane's run where runs are vectors, else 0


def _pow2ceil(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _fwd_run(heads: int, d: int) -> int:
    """The run of contiguous features a K3 lane holds: 4 (one float4)
    where d % 4 == 0, doubled while d allows whole runs and a row's heads
    would take a whole warp (up to 8, so that a warp holds two rows: HD 128
    as 8 heads × 2 lanes × 8 features) or more than a warp (up to 16); else
    the least power of two with which a head fits 32 lanes."""
    lanes = lambda run: _pow2ceil(-(-d // run))  # noqa: E731
    if d % 4 == 0:
        run = 4
        while run < 16 and d % (2 * run) == 0 and (
                heads * lanes(run) > 32 or (run < 8 and heads * lanes(run) == 32)):
            run *= 2
        if lanes(run) <= 32:
            return run
    run = 1
    while lanes(run) > 32:
        run *= 2
    return run


@functools.lru_cache(maxsize=None)
def fwd_plan(dims: AttnDims, itemsize: int = 4) -> FwdPlan:
    """K3's CTA geometry for these widths and ``itemsize``-byte operands
    (4: f32, 2: bf16). A head takes ``lanes_head`` lanes
    of ``run`` features (d 16: 4 × 4; d 32 at 8 heads: 4 × 8; d 1: one lane),
    a row's heads share a warp where they fit (slices of heads where they do
    not), and narrow rows pack a warp (HD 128: 2 rows, HD 16: 8, HD 1: 32).
    A row group is 32 rows (64 at 32 rows a warp; fewer when a row takes
    several items), so that a 128-row live tile gives 2–4 groups; a CTA
    runs it with up to 8 warps (HD 128: 2 passes of 16 rows). The geometry
    is the same in bf16; where d % 4 == 0 a lane's run is read as vectors of
    up to 16 bytes (``vec_bytes``: f32 16; bf16 8 at run 4, 16 above)."""
    heads, d = dims.heads, dims.d
    run = _fwd_run(heads, d)
    lanes_head = _pow2ceil(-(-d // run))
    heads_item = min(heads, 32 // lanes_head)
    lanes_item = _pow2ceil(heads_item * lanes_head)
    slices = -(-heads // heads_item)
    items_warp = 32 // lanes_item
    rows = min(dims.nt, max(1, max(32, 2 * items_warp) // slices))
    warps = min(FWD_MAX_WARPS, -(-rows * slices // items_warp))
    tiles = -(-dims.n_max // dims.nt)
    # most rows have ~4 slots: a warp that holds one row takes 4 at a time
    # at run 4, one that holds several takes 8 (its rows' largest count)
    chunks = [c for r, c in FWD_INSTANCES if r == run]
    chunk = max(chunks) if items_warp > 1 else min(chunks)
    vec_bytes = min(16, run * itemsize) if run % 4 == 0 and d % run == 0 else 0
    return FwdPlan(run, lanes_head, heads_item, lanes_item, slices, items_warp, warps, rows,
                   chunk, tiles * -(-dims.nt // rows), vec_bytes)


def fwd_smem_bytes(dims: AttnDims, a: int = MAX_A) -> int:
    """Dynamic shared memory of one K3 CTA with ``a`` attribute columns
    (csrc/attn.cu ``fwd_smem_words``): its rows' first slots, the group's
    slot range and the tile's dst_rel, src_rel and attributes."""
    pad4 = lambda n: -(-n // 4) * 4  # noqa: E731
    return 4 * (pad4(fwd_plan(dims).rows_cta + 3) + 2 * pad4(dims.eb) + dims.eb * a)


def slot_nodes(meta: AttnMeta, dims: AttnDims) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dst, src) node ids (B, T·EB) int64 of every window slot, −1 where a
    slot contributes nothing: dst for dead slots, slots of dead tiles and
    slots that reach a padding row at or past ``n_max`` (whose output is
    sliced off and whose cotangent is zero); src also where the source
    falls outside the window or past ``n_max``, where the TPU kernel reads
    a zero k/v row (the slot then still carries its edge term)."""
    b, t, eb = meta.dst_rel.shape
    tile = torch.arange(t, device=meta.dst_rel.device)[None, :, None]
    dst_rel, src_rel = meta.dst_rel.long(), meta.src_rel.long()
    dst = tile * dims.nt + dst_rel
    dst_ok = (dst_rel >= 0) & (tile < meta.live[:, None, None]) & (dst < dims.n_max)
    src = meta.s0.long()[..., None] + src_rel
    src_ok = dst_ok & (src_rel >= 0) & (src_rel < dims.sw) & (src < dims.n_max)
    return (torch.where(dst_ok, dst, -1).reshape(b, t * eb),
            torch.where(src_ok, src, -1).reshape(b, t * eb))


def slot_view(meta: AttnMeta, dims: AttnDims) -> SegmentView:
    """The source-sorted view of the window slots: the CSR view
    (:func:`~quadtree_mpnnlstm_tpu_torch.ops.segment_sum.segment_view`) of
    their source nodes, without the slots :func:`slot_nodes` drops (dead,
    in a dead tile, or with a source outside the window). Integer ops in
    int32 only; the graph build makes it once per mesh on a card when a
    backward can follow."""
    b, t, eb = meta.src_rel.shape
    tile = torch.arange(t, dtype=torch.int32, device=meta.src_rel.device)[None, :, None]
    src = meta.s0[..., None] + meta.src_rel
    keep = ((meta.dst_rel >= 0) & (tile < meta.live[:, None, None])
            & (tile * dims.nt + meta.dst_rel < dims.n_max)
            & (meta.src_rel >= 0) & (meta.src_rel < dims.sw) & (src < dims.n_max))
    return segment_view(torch.where(keep, src, -1).reshape(b, t * eb), dims.n_max)


def for_batch(meta: AttnMeta, b: int) -> AttnMeta:
    """``meta`` for a batch of ``b``: as it is, or a shared mesh's windows
    (batch 1) expanded as views."""
    if meta.s0.shape[0] == b:
        return meta
    return AttnMeta(*(x.expand((b,) + x.shape[1:]) for x in meta))


def _slot_keep(keep: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, T, KH, EB) keep windows → (B, T·EB, heads); head h reads row
    min(h, KH − 1), as the TPU kernel does."""
    b, t, kh, eb = keep.shape
    rows = torch.arange(heads, device=keep.device).clamp_max(kh - 1)
    return keep[:, :, rows, :].permute(0, 1, 3, 2).reshape(b, t * eb, heads)


# ------------------------------------------------------- plain versions


def attn_plain(q, k, v, we, keep: Optional[torch.Tensor], meta: AttnMeta,
               dims: AttnDims) -> torch.Tensor:
    """K3's function in plain PyTorch, over the window slots: gather k/v at
    the sources and q at the destinations, per-head logits, a softmax per
    destination with a detached max, and fixed-order segment sums. O(slots
    · HD) memory. q, k, v: (B, n_max, heads·d); we: (A, heads·d). bf16
    operands are widened to f32 and the output is rounded to q's dtype
    once. Windows of batch 1 serve every sample."""
    n_max, heads, d = dims.n_max, dims.heads, dims.d
    b = q.shape[0]
    meta = for_batch(meta, b)
    dtype = q.dtype
    q, k, v, we = (x.float() for x in (q, k, v, we))
    dst, src = slot_nodes(meta, dims)
    slots = dst.shape[1]
    attr = meta.attr.reshape(b, slots, -1)
    e = (attr @ we).reshape(b, slots, heads, d)
    kj = gather_nodes(k, src, n_max, routed=False).reshape(b, slots, heads, d) + e
    vj = gather_nodes(v, src, n_max, routed=False).reshape(b, slots, heads, d) + e
    qi = gather_nodes(q, dst, n_max, routed=False).reshape(b, slots, heads, d)
    logits = (qi * kj).sum(-1) * (1.0 / float(d) ** 0.5)  # (B, slots, heads)

    valid = (dst >= 0)[..., None]
    with torch.no_grad():
        idx = dst.clamp_min(0)[..., None].expand(b, slots, heads)
        mx = torch.full((b, n_max, heads), float("-inf"), device=q.device)
        mx = mx.scatter_reduce(1, idx, torch.where(valid, logits, float("-inf")), "amax")
        mx = torch.gather(mx, 1, idx)
    ex = torch.exp(torch.where(valid, logits - mx, float("-inf")))
    den = gather_nodes(segment_sum_plain(ex, dst, n_max), dst, n_max, routed=False)
    alpha = ex / den.clamp_min(1e-30)
    if keep is not None:
        alpha = alpha * _slot_keep(keep, heads)
    out = segment_sum_plain(alpha[..., None] * vj, dst, n_max)  # (B, n_max, heads, d)
    return out.reshape(b, n_max, heads * d).to(dtype)


def attn_bwd_plain(q, k, v, we, keep, meta: AttnMeta, dims: AttnDims, g, view=None):
    """K4's function in plain PyTorch: autograd through :func:`attn_plain`,
    recomputed from the saved inputs. Returns (dq, dk, dv, dwe), each in
    its input's dtype (bf16: the f32 gradient rounded once). ``view`` (the
    kernel's slot view) is not needed here."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v, we)]
        return torch.autograd.grad(attn_plain(*leaves, keep, meta, dims), leaves, g)


def attn_bwd_slots_plain(q, k, v, we, keep, meta: AttnMeta, dims: AttnDims, g):
    """K4's first kernel in plain PyTorch, written out: dq (in q's dtype),
    the per-slot scalars dlog = dlogit·scale and used = α·keep (B, T·EB,
    heads, f32; 0 where a slot contributes nothing) and dWₑ (summed in f32,
    in we's dtype). With :func:`attn_combine_plain` it gives
    :func:`attn_bwd_plain`'s function."""
    n_max, heads, d = dims.n_max, dims.heads, dims.d
    b = q.shape[0]
    meta = for_batch(meta, b)
    dtype, we_dtype = q.dtype, we.dtype
    q, k, v, we, g = (x.float() for x in (q, k, v, we, g))
    scale = 1.0 / float(d) ** 0.5
    dst, src = slot_nodes(meta, dims)
    slots = dst.shape[1]
    attr = meta.attr.reshape(b, slots, -1)
    e = (attr @ we).reshape(b, slots, heads, d)
    kj = gather_nodes(k, src, n_max, routed=False).reshape(b, slots, heads, d) + e
    vj = gather_nodes(v, src, n_max, routed=False).reshape(b, slots, heads, d) + e
    qi = gather_nodes(q, dst, n_max, routed=False).reshape(b, slots, heads, d)
    gi = gather_nodes(g, dst, n_max, routed=False).reshape(b, slots, heads, d)
    logits = (qi * kj).sum(-1) * scale
    valid = (dst >= 0)[..., None]
    idx = dst.clamp_min(0)[..., None].expand(b, slots, heads)
    mx = torch.full((b, n_max, heads), float("-inf"), device=q.device)
    mx = torch.gather(mx.scatter_reduce(1, idx, torch.where(valid, logits, float("-inf")),
                                        "amax"), 1, idx)
    ex = torch.exp(torch.where(valid, logits - mx, float("-inf")))
    den = gather_nodes(segment_sum_plain(ex, dst, n_max), dst, n_max, routed=False)
    alpha = ex / den.clamp_min(1e-30)
    kp = torch.ones_like(alpha) if keep is None else _slot_keep(keep, heads)
    dalpha = kp * (gi * vj).sum(-1)
    rowdot = gather_nodes(segment_sum_plain(alpha * dalpha, dst, n_max), dst, n_max,
                          routed=False)
    dlog = torch.where(valid, alpha * (dalpha - rowdot) * scale, 0.0)
    used = torch.where(valid, alpha * kp, 0.0)
    dq = segment_sum_plain((dlog[..., None] * kj).reshape(b, slots, heads * d), dst, n_max)
    per_slot = (dlog[..., None] * qi + used[..., None] * gi).reshape(b, slots, heads * d)
    dwe = torch.einsum("bsa,bsf->af", attr, per_slot)
    return dq.to(dtype), dlog, used, dwe.to(we_dtype)


def attn_combine_plain(dlog, used, q, g, meta: AttnMeta, dims: AttnDims):
    """K4's second kernel in plain PyTorch: dk[s] = Σ_j dlog_j·q[dst_j] and
    dv[s] = Σ_j used_j·g[dst_j] over the slots j whose source is s, by the
    sort-based plain segment sum, in f32. Returns (dk, dv) in q's dtype."""
    n_max, heads, d = dims.n_max, dims.heads, dims.d
    b = q.shape[0]
    meta = for_batch(meta, b)
    dtype = q.dtype
    q, g = q.float(), g.float()
    dst, src = slot_nodes(meta, dims)
    slots = dst.shape[1]
    qi = gather_nodes(q, dst, n_max, routed=False).reshape(b, slots, heads, d)
    gi = gather_nodes(g, dst, n_max, routed=False).reshape(b, slots, heads, d)
    dk = segment_sum_plain((dlog[..., None] * qi).reshape(b, slots, heads * d), src, n_max)
    dv = segment_sum_plain((used[..., None] * gi).reshape(b, slots, heads * d), src, n_max)
    return dk.to(dtype), dv.to(dtype)


# ------------------------------------------------------- CUDA kernels


def _launch_args(q, k, v, we, keep, meta: AttnMeta, dims: AttnDims):
    """Check the operands of both kernels: q, k, v and we in one dtype,
    float32 or bfloat16, the windows and keep float32; windows of batch 1
    (a shared mesh) serve every sample. Returns (lib, pointers, ints, the
    entry points' suffix)."""
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    n_max, nt, eb, sw, heads, d = dims
    b = q.shape[0]
    bm, t = meta.s0.shape
    spmm.check_meta_batch(bm, b)
    a = meta.attr.shape[-1]
    hd = heads * d
    if not 1 <= hd <= MAX_HD or not 1 <= a <= MAX_A:
        raise ValueError(f"attention kernels take 1 ≤ heads·d ≤ {MAX_HD} and 1 ≤ A ≤ {MAX_A}; "
                         f"got heads·d={hd}, A={a}")
    if q.dtype not in spmm.KERNEL_DTYPES:
        raise TypeError(f"attention kernels take float32 or bfloat16 q, not {q.dtype}")
    check = spmm._check
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        check(x, name, q.dtype, (b, n_max, hd))
    check(we, "we", q.dtype, (a, hd))
    check(meta.s0, "s0", torch.int32, (bm, t))
    check(meta.src_rel, "src_rel", torch.int32, (bm, t, eb))
    check(meta.dst_rel, "dst_rel", torch.int32, (bm, t, eb))
    check(meta.attr, "attr", torch.float32, (bm, t, eb, a))
    check(meta.live, "live", torch.int32, (bm,))
    kh = 0
    if keep is not None:
        if keep.dim() != 4 or not 1 <= keep.shape[2] <= heads:
            raise ValueError(f"keep must be (B, T, KH, EB) with 1 ≤ KH ≤ {heads}, "
                             f"got {tuple(keep.shape)}")
        kh = keep.shape[2]
        check(keep, "keep", torch.float32, (b, t, kh, eb))
    ptrs = [spmm._ptr(x) for x in (q, k, v, we)]
    ptrs.append(ctypes.c_void_p(None if keep is None else keep.data_ptr()))
    ptrs += [spmm._ptr(x) for x in meta]
    ints = (b, bm, t, eb, nt, sw, n_max, heads, d, a, kh)
    return load_library("attn.cu"), ptrs, ints, spmm.KERNEL_DTYPES[q.dtype]


def _scale(d: int) -> ctypes.c_float:
    return ctypes.c_float(1.0 / float(d) ** 0.5)


FWD_GEOMETRY = ("ctas", "groups", "block", "smem", "run", "chunk", "vec", "vec_win")


def _attn_fwd_cuda(q, k, v, we, keep, meta: AttnMeta, dims: AttnDims,
                   plan: Optional[FwdPlan] = None, geometry: Optional[dict] = None
                   ) -> torch.Tensor:
    """Launch K3 (``qtm_attn_fwd``, or ``_bf16`` for bf16 operands) with
    ``plan`` (default :func:`fwd_plan`): as many CTAs as the card holds at
    once (at most one per row group), each walking row groups of (sample,
    tile, rows). When ``geometry`` is a dict it receives what the kernel
    launched (:data:`FWD_GEOMETRY`: CTAs, row groups, threads a CTA, shared
    bytes, run, chunk, and whether rows were read as vectors and windows
    moved 16 bytes a copy)."""
    lib, ptrs, ints, suffix = _launch_args(q, k, v, we, keep, meta, dims)
    plan = fwd_plan(dims, q.element_size()) if plan is None else plan
    if fwd_smem_bytes(dims, meta.attr.shape[-1]) > SMEM_LIMIT:
        raise ValueError(f"attn_apply: EB={dims.eb} needs more shared memory than a CTA has")
    out = torch.empty_like(q)
    launched = (ctypes.c_int * len(FWD_GEOMETRY))()
    err = getattr(lib, "qtm_attn_fwd" + suffix)(
        *ptrs, spmm._ptr(out), *ints, plan.run, plan.lanes_head, plan.heads_item,
        plan.lanes_item, plan.slices, plan.warps, plan.rows_cta, plan.chunk, _scale(dims.d),
        spmm._stream(), launched)
    spmm._raise_on(err, "attn_apply")
    (LAUNCHES_BF16 if suffix else LAUNCHES)["attn_apply"] += 1
    if geometry is not None:
        geometry.update(zip(FWD_GEOMETRY, launched))
    return out


def _attn_bwd_cuda(q, k, v, we, keep, meta: AttnMeta, dims: AttnDims, g, view=None):
    """Launch K4 (``qtm_attn_bwd``, or ``_bf16`` for bf16 operands: the
    per-destination kernel, which writes dq, the per-slot scalars and the
    per-CTA dWₑ partials, then the per-source kernel, which gathers dk and
    dv over ``view``, the slots' :func:`slot_view`, built here when None)
    and sum the f32 dWₑ partials in a fixed order. Returns (dq, dk, dv, dwe)
    in q's dtype."""
    lib, ptrs, ints, suffix = _launch_args(q, k, v, we, keep, meta, dims)
    spmm._check(g, "g", q.dtype, tuple(q.shape))
    bm, t, eb = meta.dst_rel.shape
    b = q.shape[0]
    a, hd = we.shape
    if view is None:
        view = slot_view(meta, dims)
    spmm._check(view.order, "view order", torch.int32, (bm * t * eb,))
    spmm._check(view.offsets, "view offsets", torch.int32, (bm, dims.n_max + 1))
    groups = -(-dims.nt // ROWS_PER_CTA)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    scalars = torch.empty((2, b, t * eb, dims.heads), dtype=torch.float32, device=q.device)
    dwe_part = torch.empty((b, t * groups, a, hd), dtype=torch.float32, device=q.device)
    err = getattr(lib, "qtm_attn_bwd" + suffix)(
        *ptrs, spmm._ptr(g), spmm._ptr(view.order), spmm._ptr(view.offsets), spmm._ptr(dq),
        spmm._ptr(dk), spmm._ptr(dv), spmm._ptr(scalars[0]), spmm._ptr(scalars[1]),
        spmm._ptr(dwe_part), *ints, ROWS_PER_CTA, _scale(dims.d), spmm._stream())
    spmm._raise_on(err, "attn_apply_bwd")
    (LAUNCHES_BF16 if suffix else LAUNCHES)["attn_apply_bwd"] += 1
    return dq, dk, dv, dwe_part.sum(dim=(0, 1)).to(we.dtype)


# ------------------------------------------------------- head groups


def head_groups(heads: int, d: int, limit: int) -> Tuple[Tuple[int, int], ...]:
    """The fewest groups of whole heads whose width (heads · d) is at most
    ``limit``, as even as the count allows, as (first head, end) pairs in
    head order: one group, (0, heads), where heads·d fits. A head wider
    than ``limit`` raises."""
    if not 1 <= d <= limit:
        raise ValueError(f"a head of d={d} features is wider than the kernels' {limit}")
    n = -(-heads // (limit // d))
    size, extra = divmod(heads, n)
    ends = [(i + 1) * size + min(i + 1, extra) for i in range(n)]
    return tuple(zip([0] + ends[:-1], ends))


def _group(x: Optional[torch.Tensor], h0: int, h1: int, d: int) -> Optional[torch.Tensor]:
    """Columns [h0·d, h1·d) of x's last axis, contiguous."""
    return None if x is None else x[..., h0 * d:h1 * d].contiguous()


def _group_keep(keep: Optional[torch.Tensor], h0: int, h1: int) -> Optional[torch.Tensor]:
    """The keep windows (B, T, KH, EB) of heads [h0, h1): shared when KH =
    1, else the rows those heads read (:func:`_slot_keep`)."""
    if keep is None or keep.shape[2] == 1:
        return keep
    rows = torch.arange(h0, h1, device=keep.device).clamp_max(keep.shape[2] - 1)
    return keep[:, :, rows].contiguous()


def attn_fwd_by_groups(fwd, q, k, v, we, keep, meta: AttnMeta, dims: AttnDims,
                       limit: int = MAX_HD) -> torch.Tensor:
    """``fwd`` (K3's launcher, or a plain version) on the fewest groups of
    whole heads of at most ``limit`` features (:func:`head_groups`), each
    on its heads' columns of q, k, v and Wₑ and its keep rows; the outputs
    side by side. Heads are independent, so this is the one call's
    result. One group is the one call, with the operands as given."""
    groups = head_groups(dims.heads, dims.d, limit)
    if len(groups) == 1:
        return fwd(q, k, v, we, keep, meta, dims)
    d = dims.d
    return torch.cat([fwd(*(_group(x, h0, h1, d) for x in (q, k, v, we)),
                          _group_keep(keep, h0, h1), meta, dims._replace(heads=h1 - h0))
                      for h0, h1 in groups], dim=-1)


def attn_bwd_by_groups(bwd, q, k, v, we, keep, meta: AttnMeta, dims: AttnDims, g,
                       view: Optional[SegmentView] = None, limit: int = MAX_HD):
    """``bwd`` (K4's launcher, or a plain version) by the head groups of
    :func:`attn_fwd_by_groups`, on each group's columns of the cotangent
    too; dq, dk, dv and dWₑ are the groups' side by side. The slot view
    does not depend on the heads: it is built once for all groups."""
    groups = head_groups(dims.heads, dims.d, limit)
    if len(groups) == 1:
        return bwd(q, k, v, we, keep, meta, dims, g, view)
    if view is None and q.is_cuda:
        view = slot_view(meta, dims)
    d = dims.d
    parts = [bwd(*(_group(x, h0, h1, d) for x in (q, k, v, we)), _group_keep(keep, h0, h1),
                 meta, dims._replace(heads=h1 - h0), _group(g, h0, h1, d), view)
             for h0, h1 in groups]
    return tuple(torch.cat(grads, dim=-1) for grads in zip(*parts))


# ------------------------------------------------------- dispatch


class AttnApply(torch.autograd.Function):
    """K3 forward with the K4 backward. Each direction launches its kernel
    on a CUDA tensor and runs its plain version on a CPU tensor. Only
    q, k, v and Wₑ are saved (not α, which K4 recomputes); keep, the
    windows and the slot view get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, we, keep, s0, src_rel, dst_rel, attr, live, order, offsets, dims):
        q, k, v, we = (x.contiguous() for x in (q, k, v, we))
        ctx.save_for_backward(q, k, v, we, keep, s0, src_rel, dst_rel, attr, live, order,
                              offsets)
        ctx.dims = dims
        meta = AttnMeta(s0, src_rel, dst_rel, attr, live)
        if q.is_cuda:
            return attn_fwd_by_groups(_attn_fwd_cuda, q, k, v, we, keep, meta, dims)
        return attn_plain(q, k, v, we, keep, meta, dims)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, we, keep, *meta, order, offsets = ctx.saved_tensors
        view = None if offsets is None else SegmentView(order, offsets)
        args = (q, k, v, we, keep, AttnMeta(*meta), ctx.dims, g.contiguous(), view)
        if g.is_cuda:
            dq, dk, dv, dwe = attn_bwd_by_groups(_attn_bwd_cuda, *args)
        else:
            dq, dk, dv, dwe = attn_bwd_plain(*args)
        return (dq, dk, dv, dwe) + (None,) * 9


def attn_apply(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, we: torch.Tensor,
               keep: Optional[torch.Tensor], meta: AttnMeta, dims: AttnDims,
               view: Optional[SegmentView] = None) -> torch.Tensor:
    """K3: fused TransformerConv aggregation over the windows of ``meta``.

    Replaces ``attn_apply`` (``_attn_impl``/``_fwd_kernel`` forward,
    ``_attn_bwd``/``_bwd_kernel`` backward) of
    ``quadtree_mpnnlstm_tpu/ops/pallas_attn.py``. q, k, v: (B, n_max,
    heads·d) f32 or bf16; we: (A, heads·d) in q's dtype; keep: (B, T, KH,
    EB) f32 keep-scale windows, or None for no dropout; ``view``: the
    windows' :func:`slot_view` (the graph's ``slot_view``), which the
    card's backward builds when None. ``meta`` (and ``view``) hold B
    meshes, or one that every sample rides. Returns (B, n_max, heads·d)
    in q's dtype; differentiable in q, k, v and we.
    """
    order, offsets = (None, None) if view is None else view
    return AttnApply.apply(q, k, v, we, keep, *meta, order, offsets, dims)
