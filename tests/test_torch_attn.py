"""PyTorch port vs JAX package: attention window metadata (bit-identical,
window overflow included) and the fused attention aggregation with its
gradients (q, k, v, Wₑ). The Pallas kernels run in interpret mode on the
CPU; the port runs its plain versions (``attn_plain`` forward, autograd
through it backward), which tests/test_torch_kernels_cuda.py and
chip_smoke.py hold the CUDA kernels against on the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.ops import pallas_attn as jattn
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.ops import attn as tattn
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (32, 32)
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _frame(seed, noise):
    """A blob plus noise: refined near the blob."""
    rng = np.random.default_rng(seed)
    r = np.arange(SHAPE[0])[:, None]
    c = np.arange(SHAPE[1])[None, :]
    cy, cx = rng.uniform(0, SHAPE[0]), rng.uniform(0, SHAPE[1])
    blob = np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (SHAPE[0] / 5) ** 2))
    return (blob + noise * rng.random(SHAPE)).astype(np.float32)


def _jax_graphs(n_max, e_max, thresh, seeds, noise):
    """JAX meshes of one frame each, and their edge lists stacked as numpy."""
    cfg = JGraphConfig(image_shape=SHAPE, max_grid_size=8, thresh=thresh, n_max=n_max,
                       e_max=e_max)
    graphs = [j_image_to_graph(j_posenc(jnp.asarray(_frame(s, noise)[None, :, :, None])), cfg)[0]
              for s in seeds]
    stack = lambda name: np.stack([np.asarray(getattr(g, name)) for g in graphs])  # noqa: E731
    return graphs, stack("edge_src"), stack("edge_dst"), stack("edge_attr"), stack("n_nodes")


def _port_meta(src, dst, attr, n_nodes, n_max, nt, eb, sw):
    return tattn.attn_tile_meta(torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
                                torch.from_numpy(attr), n_max, nt, eb, sw,
                                torch.from_numpy(n_nodes).long())


@pytest.mark.parametrize("n_max,thresh,nt,eb,sw,tight", [
    (512, 0.1, 128, 1024, 1024, False),
    (300, 0.3, 128, 1024, 512, False),
    (1024, 0.05, 128, 1024, 512, False),
    (512, 0.1, 64, 128, 64, True),
])
def test_attn_tile_meta_bit_identical(n_max, thresh, nt, eb, sw, tight):
    graphs, src, dst, attr, n_nodes = _jax_graphs(n_max, 8 * n_max, thresh, (0, 1), 0.02)
    meta, ovf = _port_meta(src, dst, attr, n_nodes, n_max, nt, eb, sw)
    assert meta.attr.dtype == torch.float32 and meta.s0.dtype == meta.live.dtype == torch.int32
    for b, g in enumerate(graphs):
        jm, jovf = jattn.attn_tile_meta(g.edge_src, g.edge_dst, g.edge_attr, n_max, nt, eb, sw,
                                        n_nodes=g.n_nodes)
        np.testing.assert_array_equal(meta.s0[b].numpy(), np.asarray(jm.s0)[:, 0])
        np.testing.assert_array_equal(meta.src_rel[b].numpy(), np.asarray(jm.src_rel))
        np.testing.assert_array_equal(meta.dst_rel[b].numpy(), np.asarray(jm.dst_rel))
        np.testing.assert_array_equal(meta.attr[b].numpy(),
                                      np.asarray(jm.attr_t).transpose(0, 2, 1))
        assert int(meta.live[b]) == int(np.asarray(jm.live)[0, 0])
        assert int(ovf[b]) == int(jovf)
    if tight:
        assert int(ovf.min()) > 0
    # the CUDA kernels find each row's slots as one range: the live slots of
    # every window are a prefix, sorted by destination
    dst_rel = meta.dst_rel.long()
    live = dst_rel >= 0
    assert (live[..., 1:] <= live[..., :-1]).all()
    assert ((dst_rel[..., 1:] >= dst_rel[..., :-1]) | ~live[..., 1:]).all()


# Two meshes with n_max = 300, not a multiple of NT = 128: the first has
# 253 nodes (live 2 of 3 tiles: rows 256..299 are visible rows of a dead
# tile), the second 289 (live 3: the sentinel edges' slots reach padding
# row 300 with no source, and rows 289..299 are isolated padding rows).
N_MAX, NT, EB, SW = 300, 128, 1024, 512


@pytest.fixture(scope="module")
def windows():
    graphs, src, dst, attr, n_nodes = _jax_graphs(N_MAX, 1600, 0.3, (1, 5), 0.0)
    assert n_nodes.tolist() == [253, 289]
    meta, ovf = _port_meta(src, dst, attr, n_nodes, N_MAX, NT, EB, SW)
    assert int(ovf.max()) == 0
    jmetas = [jattn.attn_tile_meta(g.edge_src, g.edge_dst, g.edge_attr, N_MAX, NT, EB, SW,
                                   n_nodes=g.n_nodes)[0] for g in graphs]
    return meta, jmetas


@pytest.mark.parametrize("heads,d", [(1, 16), (3, 8), (8, 16), (1, 1)])
@pytest.mark.parametrize("dropout", [False, True])
def test_attn_apply_and_grads_match_jax(windows, heads, d, dropout):
    """Forward ≤1e-5; gradients of <out, g> in q, k, v and Wₑ ≤1e-4 ×
    max(1, max|g_jax|). With dropout the keep windows (rate 0.1, one value
    per slot and head) come from numpy and go to both; without, the port
    takes keep=None and the JAX kernel ones."""
    meta, jmetas = windows
    b, t = meta.s0.shape
    hd = heads * d
    rng = np.random.default_rng(heads * 100 + d)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, g = mk(b, N_MAX, hd), mk(b, N_MAX, hd), mk(b, N_MAX, hd), mk(b, N_MAX, hd)
    we = mk(2, hd)
    if dropout:
        keep = ((rng.random((b, t, heads, EB)) < 0.9) / 0.9).astype(np.float32)
    dims = tattn.AttnDims(N_MAX, NT, EB, SW, heads, d)

    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, we)]
    out = tattn.attn_apply(*leaves, torch.from_numpy(keep) if dropout else None, meta, dims)
    assert type(out.grad_fn).__name__ == "AttnApplyBackward"
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))

    jdims = jattn.AttnDims(N_MAX, NT, EB, SW, heads, d)
    jwe = 0.0  # dWₑ sums over the batch
    for s, jm in enumerate(jmetas):
        jkeep = jnp.asarray(keep[s]) if dropout else jnp.ones((t, EB), jnp.float32)

        def loss(qq, kk, vv, ww, jm=jm, jkeep=jkeep, s=s):
            o = jattn.attn_apply(qq, kk, vv, ww, jkeep, jm, jdims)
            return jnp.sum(o * g[s]), o

        (_, ref), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(q[s]), jnp.asarray(k[s]), jnp.asarray(v[s]), jnp.asarray(we))
        np.testing.assert_allclose(out[s].detach().numpy(), np.asarray(ref), atol=FWD_TOL)
        for name, mine, jg in zip("qkv", grads[:3], jgrads[:3]):
            jg = np.asarray(jg)
            err = np.abs(mine[s].numpy() - jg).max()
            assert err <= GRAD_TOL * max(1.0, np.abs(jg).max()), (name, s, err)
        jwe = jwe + np.asarray(jgrads[3])
    err = np.abs(grads[3].numpy() - jwe).max()
    assert err <= GRAD_TOL * max(1.0, np.abs(jwe).max()), err
    # dead tile rows and padding rows without a slot are exactly zero
    assert not out[0, 256:].any() and not out[1, 289:].any()


def test_cpu_tensors_never_launch_kernels(windows):
    meta, _ = windows
    dims = tattn.AttnDims(N_MAX, NT, EB, SW, 1, 4)
    q = torch.zeros(2, N_MAX, 4, requires_grad=True)
    tattn.reset_launch_counts()
    out = tattn.attn_apply(q, q, q, torch.zeros(2, 4), None, meta, dims)
    out.sum().backward()
    assert tattn.LAUNCHES == {"attn_apply": 0, "attn_apply_bwd": 0}


# ---------------------------------------------------------------- K3's geometry

FWD_WIDTHS = [(1, 1), (1, 16), (8, 16), (8, 32), (3, 8), (24, 16), (64, 1), (3, 12), (5, 33),
              (2, 132), (1, 512), (24, 32), (2, 512)]


def _replay_fwd_plan(heads, d, nt, itemsize):
    """K3's launch, replayed as csrc/attn.cuh ``attn_fwd_kernel`` indexes it
    for ``itemsize``-byte operands: returns how often each (sample, row,
    feature) below n_max of two samples is written, after checking that the
    plan is one the kernel takes, that its shared memory fits at A = 4 and
    that the CTAs' walks cover every row group once."""
    b, n_max = 2, 3 * nt - 5  # a ragged last tile
    dims = tattn.AttnDims(n_max, nt, 1024, 1024, heads, d)
    p = tattn.fwd_plan(dims, itemsize)
    hd = heads * d
    pow2 = lambda x: x & (x - 1) == 0  # noqa: E731
    assert pow2(p.lanes_head) and p.lanes_head <= 32 and p.lanes_head * p.run >= d
    assert pow2(p.lanes_item) and p.lanes_item <= 32
    assert p.heads_item * p.lanes_head <= p.lanes_item and p.slices * p.heads_item >= heads
    assert p.items_warp * p.lanes_item == 32 and p.warps <= tattn.FWD_MAX_WARPS
    assert (p.run, p.chunk) in tattn.FWD_INSTANCES and 1 <= p.rows_cta <= nt
    assert tattn.fwd_smem_bytes(dims) <= tattn.SMEM_LIMIT
    groups = -(-nt // p.rows_cta)
    assert p.groups_sample == 3 * groups
    n_groups = b * p.groups_sample
    for ctas in (1, 7, n_groups):  # CTA c walks groups c + k · ctas, from the last
        walks = [range(c + (n_groups - 1 - c) // ctas * ctas, -1, -ctas) for c in range(ctas)]
        assert sorted(g for w in walks for g in w) == list(range(n_groups))
    count = np.zeros((b, n_max, hd), dtype=np.int64)
    lane = np.arange(p.warps * 32)
    warp, lane = lane // 32, lane % 32
    sub = lane % p.lanes_item
    hl, f0 = sub // p.lanes_head, (sub % p.lanes_head) * p.run
    for cta in range(n_groups):
        bt = cta // groups
        bb, t = bt % b, bt // b
        r0 = (cta % groups) * p.rows_cta
        rows = min(p.rows_cta, nt - r0, n_max - t * nt - r0)
        if rows <= 0:
            continue
        items = rows * p.slices
        for i0 in range(0, items, p.warps * p.items_warp):
            item = i0 + warp * p.items_warp + lane // p.lanes_item
            ri, h = item // p.slices, (item % p.slices) * p.heads_item + hl
            on = (item < items) & (hl < p.heads_item) & (h < heads) & (f0 < d)
            for i in range(p.run):
                f = f0 + i
                ok = on & (f < d)
                np.add.at(count, (bb, t * nt + r0 + ri[ok], (h * d + f)[ok]), 1)
    return count, p


@pytest.mark.parametrize("nt", [128, 64])
@pytest.mark.parametrize("heads,d", FWD_WIDTHS)
def test_fwd_plan_covers_every_row_and_feature_once(heads, d, nt):
    """K3's launch, replayed as csrc/attn.cuh ``attn_fwd_kernel`` indexes it
    (tile-major row groups, each CTA's walk over them, items of a row's
    heads, lanes of a head, runs of features): every (row, feature) below
    n_max of two samples is written exactly once; the plan is one the
    kernel takes and its shared memory fits at A = 4."""
    count, _ = _replay_fwd_plan(heads, d, nt, 4)
    assert (count == 1).all()


@pytest.mark.parametrize("nt", [128, 64])
@pytest.mark.parametrize("heads,d", FWD_WIDTHS)
def test_fwd_plan_bf16_covers_every_row_and_feature_once(heads, d, nt):
    """K3's bf16 plan: the f32 geometry (every (row, feature) written once),
    with a lane's run read as vectors of run × 2 bytes up to 16 (8 at run
    4, 16 at run 8 and, in two loads, 16) where f32 reads run × 4 in
    16-byte loads, and one value at a time where the run is no vector."""
    count, p = _replay_fwd_plan(heads, d, nt, 2)
    assert (count == 1).all()
    p32 = tattn.fwd_plan(tattn.AttnDims(3 * nt - 5, nt, 1024, 1024, heads, d))
    assert p._replace(vec_bytes=0) == p32._replace(vec_bytes=0)
    vector = p.run % 4 == 0 and d % p.run == 0
    assert p.vec_bytes == (min(16, 2 * p.run) if vector else 0)
    assert p32.vec_bytes == (16 if vector else 0)


def test_fwd_plan_is_valid_at_every_width():
    """Every heads·d the wrapper accepts (≤ MAX_HD, heads of d ≤ MAX_D;
    24 × 32 = 768 included) gets a plan the kernel takes, in f32 and bf16:
    a head's lanes are a power of two that fits a warp, a run of four or
    more features divides d where it is read as vectors, the row's slices
    cover its heads and its CTA's warps hold the group's items, and no
    slice leaves more lanes idle a row than one item a head would."""
    for itemsize in (4, 2):
        for d in range(1, tattn.MAX_D + 1):
            for heads in range(1, tattn.MAX_HD // d + 1):
                p = tattn.fwd_plan(tattn.AttnDims(2048, 128, 1024, 1024, heads, d), itemsize)
                assert p.lanes_head & (p.lanes_head - 1) == 0 and p.lanes_head <= 32, (heads, d)
                assert p.lanes_head * p.run >= d, (heads, d)
                assert (p.run, p.chunk) in tattn.FWD_INSTANCES, (heads, d)
                assert p.heads_item * p.lanes_head <= p.lanes_item <= 32, (heads, d)
                assert p.slices * p.heads_item >= heads and p.warps >= 1, (heads, d)
                assert p.rows_cta * p.slices <= 32 * p.warps * p.items_warp, (heads, d)
                assert p.slices * p.lanes_item <= heads * p.lanes_head * 2, (heads, d)
                if p.vec_bytes:
                    assert d % p.run == 0 and p.vec_bytes == min(16, p.run * itemsize)
    p = tattn.fwd_plan(tattn.AttnDims(16384, 128, 1024, 1024, 24, 32), 2)
    assert (p.run, p.lanes_head, p.heads_item, p.slices) == (16, 2, 16, 2)


def _k3_model(q, k, v, we, keep, meta, dims):
    """A numpy model of csrc/attn.cuh ``attn_fwd_kernel``'s arithmetic, in
    f32. Per (row, head), with scale · log2(e) folded into q (the kernel
    takes exp2 of logits in log2 units): each lane's run of
    features sums q · k in feature order, adds the edge term as
    Σ_a attr_a (q · Wₑ[a]) from its run's share of q · Wₑ[a], and an xor
    butterfly over the head's lanes (lane l adds lane l ^ o's sum, o = 1,
    2, ...) finishes the logit. The slots go in chunks of ``plan.chunk``:
    per chunk one max and one rescale of the running sum, of Σ w v and of
    Σ w attr; then the slots' weights in ascending slot order. The output
    is (Σ w v + Σ_a (Σ w attr_a) Wₑ[a]) / Σ w."""
    p = tattn.fwd_plan(dims)
    heads, d, nt, n_max = dims.heads, dims.d, dims.nt, dims.n_max
    g_, run = p.lanes_head, p.run
    s0, src_rel, dst_rel, attr, live = (x.numpy() for x in meta)
    a_cols = attr.shape[-1]
    qscale = np.float32(1.0 / np.sqrt(d)) * np.float32(1.44269504)
    feat = np.arange(g_)[:, None] * run + np.arange(run)[None, :]  # (lanes, run)
    fmask = feat < d
    featc = np.minimum(feat, d - 1)
    lanes = np.arange(g_)

    def runs(x):  # (heads·d,) -> (heads, lanes, run), zero past d
        return np.where(fmask, x.reshape(heads, d)[:, featc], np.float32(0))

    def run_sum(x, y):  # Σ_i x_i y_i over a run, in feature order
        acc = np.zeros(x.shape[:-1], np.float32)
        for i in range(run):
            acc = acc + x[..., i] * y[..., i]
        return acc

    out = np.zeros_like(q)
    w = np.stack([runs(we[a]) for a in range(a_cols)])  # (A, heads, lanes, run)
    for b in range(q.shape[0]):
        for t in range(int(live[b])):
            key = np.where(dst_rel[b, t] >= 0, dst_rel[b, t], np.iinfo(np.int32).max)
            for r in range(min(nt, n_max - t * nt)):
                lo, hi = np.searchsorted(key, r), np.searchsorted(key, r + 1)
                node = t * nt + r
                qv = runs(q[b, node]) * qscale
                qw = [run_sum(qv, w[a]) for a in range(a_cols)]  # (heads, lanes) each
                m = np.full(heads, -np.inf, np.float32)
                den = np.zeros(heads, np.float32)
                acc = np.zeros((heads, g_, run), np.float32)
                om = np.zeros((a_cols, heads), np.float32)
                for jb in range(lo, hi, p.chunk):
                    lgs, vvs, kps, ats = [], [], [], []
                    for j in range(jb, min(jb + p.chunk, hi)):
                        sr = int(src_rel[b, t, j])
                        src = int(s0[b, t]) + sr
                        ok = 0 <= sr < dims.sw and src < n_max
                        zero = np.zeros((heads, g_, run), np.float32)
                        part = run_sum(qv, runs(k[b, src]) if ok else zero)
                        for a in range(a_cols):
                            part = part + attr[b, t, j, a] * qw[a]
                        o = 1
                        while o < g_:
                            part = part + part[:, lanes ^ o]
                            o *= 2
                        lgs.append(part[:, 0])
                        vvs.append(runs(v[b, src]) if ok else zero)
                        ats.append(attr[b, t, j])
                        kps.append(np.ones(heads, np.float32) if keep is None else
                                   keep[b, t, np.minimum(np.arange(heads), keep.shape[2] - 1), j])
                    mn = np.maximum(m, np.max(lgs, axis=0))
                    corr = np.exp2(m - mn)
                    den, acc, om = den * corr, acc * corr[:, None, None], om * corr
                    for lg, vv, kp, at in zip(lgs, vvs, kps, ats):
                        pe = np.exp2(lg - mn)
                        wt = pe * kp
                        den = den + pe
                        acc = acc + wt[:, None, None] * vv
                        om = om + at[:, None] * wt
                    m = mn
                for a in range(a_cols):
                    acc = acc + om[a][:, None, None] * w[a]
                res = acc * (np.float32(1) / np.maximum(den, np.float32(1e-30)))[:, None, None]
                row = np.zeros((heads, d), np.float32)
                row[:, feat[fmask]] = res[:, fmask]
                out[b, node] = row.reshape(-1)
    return out


def _star_meta():
    """Windows (N_MAX, NT, EB, SW) of hand-made edges: node 7 receives 40
    edges (several chunks at every run), node 9 none, and the rest a ring."""
    n = np.array([200, 150])
    src, dst = [], []
    for b in range(2):
        s = list(range(20, 60)) + [i for i in range(n[b]) if i not in (7, 9)]
        t = [7] * 40 + [(i + 1) % n[b] for i in range(n[b]) if i not in (7, 9)]
        t = [9 + 1 if x == 9 else x for x in t]
        order = np.argsort(t, kind="stable")  # the graph build's edge lists are dst-sorted
        src.append([s[i] for i in order] + [N_MAX] * (400 - len(s)))
        dst.append([t[i] for i in order] + [N_MAX] * (400 - len(t)))
    src, dst = np.array(src), np.array(dst)
    attr = np.random.default_rng(3).standard_normal((2, 400, 2)).astype(np.float32)
    meta, ovf = _port_meta(src, dst, attr, n, N_MAX, NT, EB, SW)
    assert int(ovf.max()) == 0
    return meta


@pytest.mark.parametrize("mesh", ["quadtree", "star"])
@pytest.mark.parametrize("heads,d,kh", [(8, 16, 0), (8, 16, 8), (8, 16, 3), (1, 16, 1),
                                        (3, 8, 2), (1, 1, 0), (1, 1, 1), (8, 32, 0), (3, 12, 1)])
def test_fwd_chunked_online_softmax_matches_attn_plain(windows, mesh, heads, d, kh):
    """The numpy model of K3's order of sums (chunks, lane runs, the folded
    edge term, butterfly, one rescale a chunk and head) against ``attn_plain`` within 1e-6 plus
    1e-6 of each output's size (outputs reach |4|, a few f32 ulps), on the JAX
    package's meshes (rows of up to 14 slots, dead tiles, isolated padding
    rows) and on a star (one row of 40 slots); with keep windows of KH =
    heads or KH < heads, and without."""
    meta = windows[0] if mesh == "quadtree" else _star_meta()
    b, t = meta.s0.shape
    dims = tattn.AttnDims(N_MAX, NT, EB, SW, heads, d)
    dst = meta.dst_rel.numpy()
    slots = [np.bincount(dst[i, j][(dst[i, j] >= 0) & (j * NT + dst[i, j] < N_MAX)],
                         minlength=NT) for i in range(b) for j in range(int(meta.live[i]))]
    assert any((c == 0).any() for c in slots)
    assert max(int(c.max()) for c in slots) > (8 if mesh == "quadtree" else 16)
    rng = np.random.default_rng(heads * 10 + d + kh)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = (mk(b, N_MAX, heads * d) for _ in range(3))
    we = mk(meta.attr.shape[-1], heads * d)
    keep = ((rng.random((b, t, kh, EB)) < 0.9) / 0.9).astype(np.float32) if kh else None
    want = tattn.attn_plain(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                            torch.from_numpy(we), None if keep is None else torch.from_numpy(keep),
                            meta, dims).numpy()
    got = _k3_model(q, k, v, we, keep, meta, dims)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- K4's geometry

# the widths the paths launch K4 at (HD 1, 3, 16, 48, 128, 256, 384 as 24
# × 16 and 12 × 32, 512) and two whose heads take several slices
BWD_WIDTHS = [(1, 1), (3, 1), (1, 16), (3, 16), (8, 16), (8, 32), (24, 16), (12, 32),
              (16, 32), (1, 512), (5, 33), (3, 132)]


def _lane_layout(p, warps):
    """Per thread of a CTA of ``warps`` warps: warp, item within the warp,
    head within the slice, first feature within the head."""
    lane = np.arange(warps * 32)
    warp, lane = lane // 32, lane % 32
    sub = lane % p.lanes_item
    return warp, lane // p.lanes_item, sub // p.lanes_head, (sub % p.lanes_head) * p.run


def _replay_bwd_plan(heads, d, nt, itemsize, ctas):
    """K4's two kernels, replayed as csrc/attn_bwd.cuh indexes them on two
    samples of three tiles (sample 1's last tile dead) with a grid of at
    most ``ctas`` first-kernel CTAs: returns how often each (sample, row,
    feature) of dq is written, each (source row, feature) of dk/dv, and
    each dWₑ column by a CTA's reduction, after checking that the plan is
    one the kernels take and that its shared memory fits at A = 4."""
    b, n_max, live = 2, 3 * nt - 5, (3, 2)
    dims = tattn.AttnDims(n_max, nt, 1024, 1024, heads, d)
    p = tattn.bwd_plan(dims, itemsize)
    hd = heads * d
    pow2 = lambda x: x & (x - 1) == 0  # noqa: E731
    assert pow2(p.lanes_head) and p.lanes_head <= 32 and p.lanes_head * p.run >= d
    assert pow2(p.lanes_item) and p.lanes_item <= 32 and p.items_warp * p.lanes_item == 32
    assert p.heads_item * p.lanes_head <= p.lanes_item and p.slices * p.heads_item >= heads
    assert p.slices == 1 or p.lanes_item == 32  # a slice's CTA: one item a warp
    assert (p.run, p.chunk) in tattn.FWD_INSTANCES and 1 <= p.rows_cta <= nt
    assert 1 <= p.warps <= tattn.FWD_MAX_WARPS
    assert tattn.bwd_smem_bytes(dims, 4, itemsize) <= tattn.SMEM_LIMIT
    if p.vec_bytes:  # 16-byte loads where d takes them
        assert p.vec_bytes == min(16, p.run * itemsize) and d % p.run == 0
    groups = -(-nt // p.rows_cta)
    assert p.groups_sample == 3 * groups
    n_groups = b * p.groups_sample
    units = n_groups * p.slices
    grid = min(units, max(1, ctas // p.slices) * p.slices)
    walkers = grid // p.slices
    warp, k, hl, f0 = _lane_layout(p, p.warps)
    per_pass = p.warps * p.items_warp
    dq = np.zeros((b, n_max, hd), np.int64)
    for cta in range(grid):
        sl = cta % p.slices
        h = sl * p.heads_item + hl
        for g in range(cta // p.slices, n_groups, walkers):
            bt = g // groups
            bb, t = bt % b, bt // b
            r0 = (g % groups) * p.rows_cta
            rows = min(p.rows_cta, nt - r0, n_max - t * nt - r0)
            if rows <= 0:
                continue
            if t >= live[bb]:  # a dead tile's rows: zero stores by slice 0
                dq[bb, t * nt + r0:t * nt + r0 + rows] += sl == 0
                continue
            for i0 in range(0, rows, per_pass):
                item = i0 + warp * p.items_warp + k
                on = (item < rows) & (hl < p.heads_item) & (h < heads) & (f0 < d)
                for i in range(p.run):
                    ok = on & (f0 + i < d)
                    np.add.at(dq, (bb, t * nt + r0 + item[ok], (h * d + f0 + i)[ok]), 1)
    # a CTA's dWₑ reduction: column c of its slice, summed over the lanes
    # whose run holds it
    dwe = np.zeros(hd, np.int64)
    for sl in range(p.slices):
        c = np.arange(hd)
        hlc = c // d - sl * p.heads_item
        mine = (hlc >= 0) & (hlc < p.heads_item)
        sub = (hlc * p.lanes_head + (c % d) // p.run)[mine]
        first = (sub % p.lanes_head) * p.run
        assert (sub < p.lanes_item).all() and (sub // p.lanes_head == hlc[mine]).all()
        assert ((first <= c[mine] % d) & (c[mine] % d < first + p.run)).all()
        dwe += mine
    # the second kernel: 8 warps a CTA, items (source row, slice)
    items = b * n_max * p.slices
    warp, k, hl, f0 = _lane_layout(p, 8)
    src_ctas = -(-items // (8 * p.items_warp))
    item = ((np.arange(src_ctas)[:, None] * 8 + warp[None]) * p.items_warp + k[None]).ravel()
    hl, f0 = np.tile(hl, src_ctas), np.tile(f0, src_ctas)
    row, h = item // p.slices, (item % p.slices) * p.heads_item + hl
    on = (row < b * n_max) & (hl < p.heads_item) & (h < heads) & (f0 < d)
    dk = np.zeros((b * n_max, hd), np.int64)
    for i in range(p.run):
        ok = on & (f0 + i < d)
        np.add.at(dk, (row[ok], (h * d + f0 + i)[ok]), 1)
    return dq, dk, dwe, p


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("heads,d", BWD_WIDTHS)
def test_bwd_plan_covers_every_row_and_feature_once(heads, d, itemsize):
    """K4's launch, replayed as csrc/attn_bwd.cuh ``attn_bwd_kernel`` and
    ``attn_bwd_src_kernel`` index it, in f32 and bf16 at every width the
    paths use, with a grid of 1, 7 or every unit: every (row, feature) of
    dq below n_max of two samples written once (live rows by their lanes,
    dead tiles' rows by the zero stores), every (source row, feature) of dk
    and dv once, every dWₑ column by one CTA slice's reduction; bf16 runs
    are 16-byte loads where d % 8 == 0, and HD 16 and HD 1 pack rows into a
    warp."""
    for ctas in (1, 7, 10 ** 6):
        dq, dk, dwe, p = _replay_bwd_plan(heads, d, 128, itemsize, ctas)
        assert (dq == 1).all() and (dk == 1).all() and (dwe == 1).all(), ctas
    if d % 8 == 0 and p.lanes_head * p.run == d:
        assert p.vec_bytes == 16
    if heads * d in (1, 16):
        assert p.items_warp >= 8


def test_bwd_plan_is_valid_at_every_width():
    """Every heads·d the wrapper accepts (≤ MAX_HD, heads of d ≤ MAX_D;
    24 × 32 = 768 included) gets a K4 plan the kernels take in both dtypes,
    with at most one item a warp where a row's heads take several slices."""
    for itemsize in (4, 2):
        for d in range(1, tattn.MAX_D + 1):
            for heads in range(1, tattn.MAX_HD // d + 1):
                p = tattn.bwd_plan(tattn.AttnDims(2048, 128, 1024, 1024, heads, d), itemsize)
                assert p.lanes_head & (p.lanes_head - 1) == 0 and p.lanes_head <= 32
                assert p.lanes_head * p.run >= d and (p.run, p.chunk) in tattn.FWD_INSTANCES
                assert p.heads_item * p.lanes_head <= p.lanes_item <= 32, (heads, d)
                # as few slices as the lanes allow (at most 32 up to 512 features)
                assert p.heads_item == min(heads, 32 // p.lanes_head), (heads, d)
                assert p.slices == -(-heads // p.heads_item), (heads, d)
                assert heads * d > 512 or p.slices <= 32, (heads, d)
                assert p.slices == 1 or p.lanes_item == 32, (heads, d)


def _k4_model(q, k, v, we, keep, meta, dims, g, ctas=7):
    """A numpy model of csrc/attn_bwd.cuh K4 in f32, in its order of sums. Per
    (row, head), K3's lane runs (:func:`tattn.bwd_plan`): each chunk of
    ``plan.chunk`` slots reads its k and v runs once, forms each lane's
    share of q · k + Σ_a attr_a (q · Wₑ[a]) and g · v + Σ_a attr_a (g ·
    Wₑ[a]), finishes both by the xor butterfly, and takes the logit in
    log2 units (× scale · log2 e) and dα = keep · g · (v + e); pass 1 runs
    the max, denominator and rowdot online over the chunks with exp2; pass 2
    forms α, dlog = α (dα − rowdot) · scale and used = α · keep in ascending
    slot order, dq = Σ dlog k + Σ_a (Σ dlog attr_a) Wₑ[a] and the row's dWₑ
    terms q · Σ dlog attr_a + g · Σ used attr_a. dWₑ: each unit walker's
    lanes (as ``attn_bwd_kernel`` walks the row groups with ``ctas`` CTAs)
    accumulate their rows' terms, a walker sums its lanes in (warp, item)
    order, and the walkers are summed in order. dk, dv: Σ dlog q[dst] and
    Σ used g[dst] over the slot view in ascending slot order. Pass 2 takes
    the warp's last chunk first (a warp holds ``plan.items_warp``
    consecutive rows and runs its longest row's chunk count), then the
    row's earlier chunks in order."""
    p = tattn.bwd_plan(dims)
    heads, d, nt, n_max = dims.heads, dims.d, dims.nt, dims.n_max
    g_, run, chunk = p.lanes_head, p.run, p.chunk
    s0, src_rel, dst_rel, attr, live = (x.numpy() for x in meta)
    bsz, t_all, eb = dst_rel.shape
    a_cols = attr.shape[-1]
    f32 = np.float32
    scale = f32(1.0 / np.sqrt(d))
    qscale = scale * f32(1.44269504)
    feat = np.arange(g_)[:, None] * run + np.arange(run)[None, :]  # (lanes, run)
    fmask = feat < d
    featc = np.minimum(feat, d - 1)
    lanes = np.arange(g_)

    def runs(x):  # (heads·d,) -> (heads, lanes, run), zero past d
        return np.where(fmask, x.reshape(heads, d)[:, featc], f32(0))

    def run_sum(x, y):
        acc = np.zeros(x.shape[:-1], f32)
        for i in range(run):
            acc = acc + x[..., i] * y[..., i]
        return acc

    def butterfly(x):  # (heads, lanes) -> every lane the head's sum
        o = 1
        while o < g_:
            x = x + x[:, lanes ^ o]
            o *= 2
        return x[:, 0]

    def unruns(x):  # (heads, lanes, run) -> (heads·d,)
        row = np.zeros((heads, d), f32)
        row[:, feat[fmask]] = x[:, fmask]
        return row.reshape(-1)

    w = np.stack([runs(we[a]) for a in range(a_cols)])  # (A, heads, lanes, run)
    zero = np.zeros((heads, g_, run), f32)
    dq = np.zeros_like(q)
    dlog = np.zeros((bsz, t_all * eb, heads), f32)
    used = np.zeros_like(dlog)
    groups = -(-nt // p.rows_cta)
    n_groups = bsz * t_all * groups
    walkers = max(1, min(n_groups, ctas // p.slices))
    per_pass = p.warps * p.items_warp
    acc = {}  # (walker, lane position) -> (A, heads, lanes, run)
    for gi in range(n_groups):
        bt = gi // groups
        b, t = bt % bsz, bt // bsz
        r0 = (gi % groups) * p.rows_cta
        if t >= int(live[b]):
            continue
        key = np.where(dst_rel[b, t] >= 0, dst_rel[b, t], np.iinfo(np.int32).max)
        rows = range(r0, min(r0 + p.rows_cta, nt, n_max - t * nt))
        bounds = [(np.searchsorted(key, r), np.searchsorted(key, r + 1)) for r in rows]
        chunks = [-(-(hi - lo) // chunk) for lo, hi in bounds]
        for r, (lo, hi) in zip(rows, bounds):
            i = r - r0  # a warp holds items_warp consecutive rows: the chunk count is its most
            nch = max(chunks[i - i % p.items_warp:i - i % p.items_warp + p.items_warp])
            node = t * nt + r
            qv, gv = runs(q[b, node]), runs(g[b, node])
            qw = [run_sum(qv, w[a]) for a in range(a_cols)]
            gw = [run_sum(gv, w[a]) for a in range(a_cols)]

            def chunk_of(jb):
                out = []
                for j in range(jb, min(jb + chunk, hi)):
                    sr = int(src_rel[b, t, j])
                    src = int(s0[b, t]) + sr
                    ok = 0 <= sr < dims.sw and src < n_max
                    kr = runs(k[b, src]) if ok else zero
                    vr = runs(v[b, src]) if ok else zero
                    s1, s2 = run_sum(qv, kr), run_sum(gv, vr)
                    for a in range(a_cols):
                        s1 = s1 + attr[b, t, j, a] * qw[a]
                        s2 = s2 + attr[b, t, j, a] * gw[a]
                    kp = (np.ones(heads, f32) if keep is None else
                          keep[b, t, np.minimum(np.arange(heads), keep.shape[2] - 1), j])
                    out.append((j, kr, butterfly(s1) * qscale, kp * butterfly(s2), kp))
                return out

            m = np.full(heads, -np.inf, f32)
            den = np.zeros(heads, f32)
            rd = np.zeros(heads, f32)
            for jb in range(lo, hi, chunk):  # pass 1: one read of each slot
                ch = chunk_of(jb)
                mn = np.maximum(m, np.max([c[2] for c in ch], axis=0))
                corr = np.exp2(m - mn)
                den, rd = den * corr, rd * corr
                for _, _, lg, da, _ in ch:
                    pe = np.exp2(lg - mn)
                    den = den + pe
                    rd = rd + pe * da
                m = mn
            inv = f32(1) / np.maximum(den, f32(1e-30))
            rowdot = rd * inv
            dqa = np.zeros((heads, g_, run), f32)
            ad = np.zeros((a_cols, heads), f32)
            au = np.zeros((a_cols, heads), f32)
            # pass 2: the warp's last chunk first (from registers), then the
            # row's earlier chunks again, in order
            for c in ([nch - 1] + list(range(nch - 1))) if nch else []:
                for j, kr, lg, da, kp in chunk_of(lo + c * chunk):
                    al = np.exp2(lg - m) * inv
                    dl = al * (da - rowdot) * scale
                    us = al * kp
                    dqa = dqa + dl[:, None, None] * kr
                    ad = ad + dl[None] * attr[b, t, j][:, None]
                    au = au + us[None] * attr[b, t, j][:, None]
                    dlog[b, t * eb + j], used[b, t * eb + j] = dl, us
            for a in range(a_cols):
                dqa = dqa + ad[a][:, None, None] * w[a]
            dq[b, node] = unruns(dqa)
            slot = gi % walkers, (r - r0) % per_pass
            terms = np.stack([qv * ad[a][:, None, None] + gv * au[a][:, None, None]
                              for a in range(a_cols)])
            acc[slot] = acc.get(slot, np.zeros_like(terms)) + terms
    dwe = np.zeros((a_cols, heads, g_, run), f32)
    for wk in range(walkers):
        part = np.zeros_like(dwe)
        for pos in range(per_pass):
            if (wk, pos) in acc:
                part = part + acc[(wk, pos)]
        dwe = dwe + part
    dwe = np.stack([unruns(dwe[a]) for a in range(a_cols)])
    # the second kernel, over the source-sorted view
    view = tattn.slot_view(meta, dims)
    order, offsets = view.order.numpy(), view.offsets.numpy()
    dk, dv = np.zeros_like(q), np.zeros_like(q)
    hidx = np.repeat(np.arange(heads), d)
    for b in range(bsz):
        for n in range(n_max):
            for e in order[offsets[b, n]:offsets[b, n + 1]]:
                slot = int(e) - b * t_all * eb
                dst = slot // eb * nt + int(dst_rel[b, slot // eb, slot % eb])
                dk[b, n] = dk[b, n] + dlog[b, slot][hidx] * q[b, dst]
                dv[b, n] = dv[b, n] + used[b, slot][hidx] * g[b, dst]
    return dq, dk, dv, dwe


@pytest.mark.parametrize("mesh", ["quadtree", "star"])
@pytest.mark.parametrize("heads,d,kh", [(8, 16, 8), (8, 16, 0), (1, 16, 1), (3, 8, 2),
                                        (1, 1, 1), (8, 32, 0), (3, 12, 3)])
def test_bwd_one_read_model_matches_attn_bwd_plain(windows, mesh, heads, d, kh):
    """The numpy model of K4's order of sums (chunks read once, exp2 in log2
    units, the dq and dWₑ folds, per-CTA dWₑ partials, the source gather in
    slot order) against ``attn_bwd_plain`` within 1e-5 × max(1, max|grad|),
    on the JAX package's meshes (dead tiles, isolated padding rows, rows of
    up to 14 slots) and on a star (one row of 40 slots, more than a chunk
    at every run), with keep rows a head, fewer keep rows, or none."""
    meta = windows[0] if mesh == "quadtree" else _star_meta()
    b, t = meta.s0.shape
    dims = tattn.AttnDims(N_MAX, NT, EB, SW, heads, d)
    rng = np.random.default_rng(heads * 10 + d + kh + 7)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, g = (mk(b, N_MAX, heads * d) for _ in range(4))
    we = mk(meta.attr.shape[-1], heads * d)
    keep = ((rng.random((b, t, kh, EB)) < 0.9) / 0.9).astype(np.float32) if kh else None
    plain = tattn.attn_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, we)),
                                 None if keep is None else torch.from_numpy(keep), meta, dims,
                                 torch.from_numpy(g))
    for name, mine, want in zip(("dq", "dk", "dv", "dwe"), _k4_model(q, k, v, we, keep, meta,
                                                                       dims, g), plain):
        want = want.numpy()
        err = np.abs(mine - want).max()
        assert err <= 1e-5 * max(1.0, np.abs(want).max()), (name, err)


@pytest.mark.parametrize("heads,d,dropout", [(8, 16, True), (1, 1, False)])
def test_bwd_one_read_model_matches_jax_vjp(windows, heads, d, dropout):
    """The numpy model of K4 against the JAX package's ``attn_apply`` VJP
    (its Pallas backward in interpret mode) on its own meshes, with keep
    rows a head from numpy or none: dq, dk, dv per sample and dWₑ summed
    over the batch within 1e-5 × max(1, max|grad|)."""
    meta, jmetas = windows
    b, t = meta.s0.shape
    hd = heads * d
    rng = np.random.default_rng(heads * 100 + d + 1)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v, g = (mk(b, N_MAX, hd) for _ in range(4))
    we = mk(2, hd)
    keep = ((rng.random((b, t, heads, EB)) < 0.9) / 0.9).astype(np.float32) if dropout else None
    dims = tattn.AttnDims(N_MAX, NT, EB, SW, heads, d)
    mine = _k4_model(q, k, v, we, keep, meta, dims, g)
    jdims = jattn.AttnDims(N_MAX, NT, EB, SW, heads, d)
    jwe = 0.0
    for s, jm in enumerate(jmetas):
        jkeep = jnp.asarray(keep[s]) if dropout else jnp.ones((t, EB), jnp.float32)
        _, vjp = jax.vjp(lambda qq, kk, vv, ww, jm=jm, jkeep=jkeep:
                         jattn.attn_apply(qq, kk, vv, ww, jkeep, jm, jdims),
                         jnp.asarray(q[s]), jnp.asarray(k[s]), jnp.asarray(v[s]),
                         jnp.asarray(we))
        jgrads = [np.asarray(x) for x in vjp(jnp.asarray(g[s]))]
        for name, x, jg in zip("qkv", mine[:3], jgrads[:3]):
            err = np.abs(x[s] - jg).max()
            assert err <= 1e-5 * max(1.0, np.abs(jg).max()), (name, s, err)
        jwe = jwe + jgrads[3]
    err = np.abs(mine[3] - jwe).max()
    assert err <= 1e-5 * max(1.0, np.abs(jwe).max()), err
