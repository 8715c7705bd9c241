"""PyTorch port vs JAX package: the stencil attention on the pixel grid
with its gradients (q, k, v, e_dir). The Pallas kernel runs in interpret
mode on the CPU; the port runs its plain versions (``grid_attn_plain``
forward, autograd through it backward), which
tests/test_torch_kernels_cuda.py and chip_smoke.py hold the CUDA kernels
against on the card. The 12×20 mask has an isolated valid pixel, whose
aggregation must be exactly 0, and a masked band."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import NEG_INF
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models.conv import multi_stream_attention as j_msa
from quadtree_mpnnlstm_tpu.ops import pallas_grid_attn as jga
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.models.conv import multi_stream_attention
from quadtree_mpnnlstm_tpu_torch.ops import grid_attn as tga
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (12, 20)
P = SHAPE[0] * SHAPE[1]
B = 2
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
ISOLATED = (5, 9)


def _mask():
    """True = invalid: random holes, a masked band, and one valid pixel
    whose 8 neighbours are all masked."""
    mask = np.random.default_rng(0).random(SHAPE) < 0.2
    mask[:2, :] = True
    r, c = ISOLATED
    mask[r - 1:r + 2, c - 1:c + 2] = True
    mask[r, c] = False
    return mask


def _operands(heads, d, ndirs, seed):
    rng = np.random.default_rng(seed)
    mk = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    h = heads * d
    return mk(B, P, h), mk(B, P, h), mk(B, P, h), mk(B, P, h), mk(ndirs, h)


# each (heads, d) with D = 4 and 8, and with and without a numpy keep plane
@pytest.mark.parametrize("heads,d,ndirs,dropout", [
    (1, 8, 4, False), (1, 8, 8, True), (3, 8, 4, True), (3, 8, 8, False),
    (8, 16, 4, False), (8, 16, 8, True), (1, 1, 4, True), (1, 1, 8, False)])
def test_grid_attn_apply_and_grads_match_jax(heads, d, ndirs, dropout):
    """Forward ≤1e-5; gradients of <out, g> in q, k, v and e_dir ≤1e-4 ×
    max(1, max|g_jax|). The keep planes (rate 0.1) come from numpy and go
    to both."""
    q, k, v, g, e = _operands(heads, d, ndirs, heads * 100 + d + ndirs)
    valid = (~_mask()).astype(np.float32).reshape(-1)
    keep = None
    if dropout:
        rng = np.random.default_rng(7)
        keep = ((rng.random((B, ndirs, P, heads)) < 0.9) / 0.9).astype(np.float32)
    dims = tga.GridAttnDims(*SHAPE, heads, d, ndirs)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, e)]
    out = tga.grid_attn_apply(*leaves, torch.from_numpy(valid),
                              None if keep is None else torch.from_numpy(keep), dims)
    assert type(out.grad_fn).__name__ == "GridAttnApplyBackward"
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))

    jdims = jga.GridAttnDims(*SHAPE, heads, d, ndirs, dropout)

    @jax.jit
    def jax_vg(qq, kk, vv, ee, gg, kp):
        def loss(qq, kk, vv, ee):
            o = jga.grid_attn_apply(qq, kk, vv, ee, jnp.asarray(valid)[:, None], kp, jdims)
            return jnp.sum(o * gg), o
        return jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(qq, kk, vv, ee)

    jde = 0.0  # de_dir sums over the batch
    for s in range(B):
        (_, ref), jgrads = jax_vg(q[s], k[s], v[s], e, g[s], None if keep is None else keep[s])
        np.testing.assert_allclose(out[s].detach().numpy(), np.asarray(ref), rtol=0, atol=FWD_TOL)
        for name, mine, jg in zip("qkv", grads[:3], jgrads[:3]):
            jg = np.asarray(jg)
            err = np.abs(mine[s].numpy() - jg).max()
            assert err <= GRAD_TOL * max(1.0, np.abs(jg).max()), (name, s, err)
        jde = jde + np.asarray(jgrads[3])
    err = np.abs(grads[3].numpy() - jde).max()
    assert err <= GRAD_TOL * max(1.0, np.abs(jde).max()), err
    # the isolated valid pixel and every masked pixel aggregate exactly 0
    out2d = out.detach().numpy().reshape(B, *SHAPE, -1)
    assert not out2d[:, ISOLATED[0], ISOLATED[1]].any()
    assert not out2d[:, _mask()].any()


@pytest.mark.parametrize("heads,d,ndirs,dropout", [
    (1, 8, 4, False), (3, 8, 8, True), (8, 16, 4, True), (1, 1, 8, False)])
def test_grid_backward_plain_matches_the_jax_bwd_rule(heads, d, ndirs, dropout):
    """K6's plain version (``grid_attn_bwd_plain``, what K6 is held to on
    the card) against the JAX package's ``_bwd_rule`` (its Pallas backward
    kernel in interpret mode) on the same cotangent: dq, dk, dv and de_dir
    within 1e-5 × max(1, max|ref|), with and without numpy keep planes."""
    q, k, v, g, e = _operands(heads, d, ndirs, heads * 10 + d + ndirs)
    valid = (~_mask()).astype(np.float32).reshape(-1)
    keep = None
    if dropout:
        rng = np.random.default_rng(11)
        keep = ((rng.random((B, ndirs, P, heads)) < 0.9) / 0.9).astype(np.float32)
    dims = tga.GridAttnDims(*SHAPE, heads, d, ndirs)
    mine = tga.grid_attn_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, e, valid)),
                                   None if keep is None else torch.from_numpy(keep), dims,
                                   torch.from_numpy(g))
    jdims = jga.GridAttnDims(*SHAPE, heads, d, ndirs, dropout)
    jde = 0.0
    for s in range(B):
        res = (jnp.asarray(q[s]), jnp.asarray(k[s]), jnp.asarray(v[s]), jnp.asarray(e),
               jnp.asarray(valid)[:, None], None if keep is None else jnp.asarray(keep[s]))
        ref = jga._bwd_rule(jdims, res, jnp.asarray(g[s]))
        for name, a, r in zip(("dq", "dk", "dv"), mine[:3], ref[:3]):
            r = np.asarray(r)
            err = np.abs(a[s].numpy() - r).max()
            assert err <= FWD_TOL * max(1.0, np.abs(r).max()), (name, s, err)
        jde = jde + np.asarray(ref[3])
    err = np.abs(mine[3].numpy() - jde).max()
    assert err <= FWD_TOL * max(1.0, np.abs(jde).max()), err


@pytest.mark.parametrize("corners", [False, True])
def test_grid_branch_matches_the_jax_xla_chain(corners):
    """The port's ``multi_stream_attention`` on a grid graph (e_dir =
    grid_attr @ Wₑ, the shared mask) against the JAX package's XLA
    shift/softmax chain (``grid_attn="xla"``), forward and gradients."""
    heads, d = 2, 4
    mask = _mask()
    x = np.random.default_rng(3).random((B, 1, *SHAPE, 1)).astype(np.float32)
    kw = dict(image_shape=SHAPE, thresh=NEG_INF, aggregation="grid", edges_at_corners=corners)
    tg, _ = image_to_graph(add_positional_encoding(torch.from_numpy(x)),
                           GraphConfig(**kw), mask=torch.from_numpy(mask))
    jg, _ = j_image_to_graph(j_posenc(jnp.asarray(x[0])), JGraphConfig(grid_attn="xla", **kw),
                             mask=jnp.asarray(mask))
    assert not jg.grid_attn_fused
    q, k, v, g, _ = _operands(heads, d, 4, 11)
    we = np.random.default_rng(12).standard_normal((2, heads * d)).astype(np.float32)
    leaves = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v, we)]
    out = multi_stream_attention(*leaves[:3], leaves[3], tg, heads, d)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).reshape(out.shape))

    def loss(qq, kk, vv, ww, gg):
        o, _ = j_msa(qq, kk, vv, ww, jg, heads, d)
        return jnp.sum(o.reshape(P, -1) * gg), o

    jwe = 0.0
    for s in range(B):
        (_, ref), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
            q[s], k[s], v[s], we, g[s])
        np.testing.assert_allclose(out[s].detach().numpy(), np.asarray(ref), rtol=0, atol=FWD_TOL)
        for mine, jgr in zip(grads[:3], jgrads[:3]):
            jgr = np.asarray(jgr)
            assert np.abs(mine[s].numpy() - jgr).max() <= GRAD_TOL * max(1.0, np.abs(jgr).max())
        jwe = jwe + np.asarray(jgrads[3])
    assert np.abs(grads[3].numpy() - jwe).max() <= GRAD_TOL * max(1.0, np.abs(jwe).max())


def test_cpu_tensors_never_launch_kernels():
    dims = tga.GridAttnDims(*SHAPE, 1, 4, 4)
    q = torch.zeros(B, P, 4, requires_grad=True)
    tga.reset_launch_counts()
    out = tga.grid_attn_apply(q, q, q, torch.zeros(4, 4), torch.ones(P), None, dims)
    out.sum().backward()
    assert tga.LAUNCHES == {"grid_attn_apply": 0, "grid_attn_apply_bwd": 0}


def test_grid_dropout_planes_come_from_the_generator(monkeypatch):
    """In training mode a grid attention draws (B, D, P, heads) keep planes
    from the generator: about 10 % zeros, the rest 1/0.9; the same seed
    gives the same planes; eval mode draws none."""
    x = torch.zeros(B, 1, *SHAPE, 1)
    tg, _ = image_to_graph(add_positional_encoding(x),
                           GraphConfig(image_shape=SHAPE, thresh=NEG_INF, aggregation="grid"))
    seen = []
    real = tga.grid_attn_apply
    monkeypatch.setattr(tga, "grid_attn_apply", lambda *a: seen.append(a[5]) or real(*a))
    q = torch.randn(B, P, 8 * 4, generator=torch.Generator().manual_seed(0))
    call = lambda gen, training: multi_stream_attention(  # noqa: E731
        q, q, q, None, tg, 8, 4, dropout=0.1, training=training, generator=gen)
    call(torch.Generator().manual_seed(0), True)
    call(torch.Generator().manual_seed(0), True)
    call(torch.Generator().manual_seed(1), True)
    call(None, False)
    keep = seen[0]
    assert keep.shape == (B, 4, P, 8)
    zero, kept = keep.unique().tolist()
    assert zero == 0.0 and kept == pytest.approx(1 / 0.9)
    assert abs(float((keep == 0).float().mean()) - 0.1) < 0.02
    assert torch.equal(seen[0], seen[1]) and not torch.equal(seen[0], seen[2])
    assert seen[3] is None
    with pytest.raises(ValueError, match="Generator"):
        call(None, True)


# ---------------------------------------------------------------- K5's plan

THREADS = 256  # csrc/grid_attn.cu kThreads
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a CTA may opt into on an H100
KV_SLOTS_F, Q_SLOTS_F, STAGES_F = tga.FWD_KV_SLOTS, tga.FWD_Q_SLOTS, tga.FWD_STAGES


def _head_counts(d):
    """Every head count up to heads·d 256, and H 768 (the sea-ice MH cells'
    width) where d divides it."""
    return [*range(1, 256 // d + 1), *([768 // d] if 768 % d == 0 else [])]


def _few_head_counts(d):
    """A few head counts at head width d: 1, 2, 3, a full feature group,
    heads·d 256, and H 768 where d divides it."""
    return sorted({1, 2, 3, max(1, 32 // d), max(1, 256 // d),
                   *([768 // d] if 768 % d == 0 else [])})


def _covers(n, size, lo, hi):
    """Per index of an axis of ``n``, how many of the ``size``-wide blocks
    extended by ``lo`` before and ``hi`` after hold it."""
    return np.array([sum(s - lo <= x < min(s + size, n) + hi for s in range(0, n, size))
                     for x in range(n)])


def _check_fwd_plan(p, dims, itemsize):
    """The plan is one csrc/grid_attn.cu ``grid_attn_fwd`` takes: row bands
    exactly at d 32 (:func:`fwd_walks`), one head a group, whole warps of
    at most 256 threads, one thread a (column, run of two 16-byte chunks);
    tiles of 256 threads by :data:`FWD_TILES` elsewhere; shared memory
    within an H100 CTA's 227 KB."""
    rows, cols, heads, d, ndirs = dims
    assert p.hpg == min(heads, max(1, 32 // d))
    assert p.walk == tga.fwd_walks(d) == (d == 32)
    assert p.strips == -(-cols // p.strip) and p.bands == -(-rows // p.band)
    assert p.smem <= SMEM_LIMIT
    if p.walk:
        assert p.hpg == 1 and p.run == 32 // itemsize
        assert p.threads % 32 == 0 and 32 <= p.threads <= THREADS
        assert p.strip * p.hpg * d // p.run <= p.threads and p.strip <= cols
        assert p.smem == tga.walk_smem_bytes(ndirs, p.hpg, d, itemsize, p.strip, p.band)
    else:
        run, lanes = tga.fwd_lanes(d)
        key = max(p.hpg * lanes, -(-p.hpg * d // 8))
        assert (p.band, p.strip) == next(t for width, t in tga.FWD_TILES if key <= width)
        assert p.run == run and p.threads == THREADS
        assert p.smem == tga.fwd_smem_bytes(dims, p.hpg, p.band, p.strip)


def _replay_fwd_plan(rows, cols, heads, d, ndirs, itemsize, batch):
    """K5's launch, replayed as csrc/grid_attn.cu indexes it: returns how
    often each (sample, pixel, feature) of the output is written and the
    plan. Row bands: every CTA's threads (column, run of the group), and
    the copies of a ring row (k and v: the strip and a side column each
    way; q: the strip), each (column, run) by exactly one thread; tiles:
    every CTA's (pixel, head) items and lane runs. Also checks that a
    head's lanes sit in one warp."""
    dims = tga.GridAttnDims(rows, cols, heads, d, ndirs)
    p = tga.fwd_plan(dims, itemsize, batch)
    _check_fwd_plan(p, dims, itemsize)
    groups = -(-heads // p.hpg)
    out = np.zeros((batch, rows, cols, heads * d), np.int64)
    for grp in range(groups):
        h0 = grp * p.hpg
        gh = min(p.hpg, heads - h0)
        if p.walk:
            runs, lanes = gh * d // p.run, d // p.run
            tid = np.arange(p.threads)
            cj, cc0, cstep = tid % runs, tid // runs, p.threads // runs
            sub = cj % lanes
            assert ((tid - sub) // 32 == (tid - sub + lanes - 1) // 32).all()
            for n in (p.strip + 2, p.strip):  # a k/v ring row, a q ring row
                copies = np.zeros((n, runs), np.int64)
                for px in (cc0, cc0 + cstep):
                    m = (cc0 < cstep) & (px < n)
                    np.add.at(copies, (px[m], cj[m]), 1)
                assert (copies == 1).all(), (n, p)
            oact = tid < p.strip * runs
            for unit in range(p.strips * p.bands):
                c0, r0 = (unit % p.strips) * p.strip, (unit // p.strips) * p.band
                on = oact & (c0 + cc0 < cols)
                for r in range(r0, min(r0 + p.band, rows)):
                    for x in range(p.run):
                        f = h0 * d + cj[on] * p.run + x
                        np.add.at(out, (slice(None), r, c0 + cc0[on], f), 1)
        else:
            run, lanes = tga.fwd_lanes(d)
            tr, tc = p.band, p.strip
            items = np.arange(tr * tc * gh)
            px, hh = items // gh, items % gh
            for tile in range(p.strips * p.bands):
                r0, c0 = (tile // p.strips) * tr, (tile % p.strips) * tc
                r, c = r0 + px // tc, c0 + px % tc
                on = (r < rows) & (c < cols)
                for sub in range(lanes):
                    for j in range(run):
                        f = h0 * d + hh * d + sub * run + j
                        np.add.at(out, (slice(None), r[on], c[on], f[on]), 1)
    return out, p


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 8, 16, 32, 64, 256])
def test_fwd_plan_covers_every_pixel_and_feature_once(d, itemsize):
    """K5's launch in f32 and bf16 (:func:`_replay_fwd_plan`: row bands at d
    32, tiles elsewhere) on an 11 × 13 grid at batch 2 at every head count
    up to heads·d 256 and at H 768 (one launch at any width; ragged last
    groups), and on a 40 × 37 grid at batch 1 at a few head counts, both
    D: every (pixel, feature) of the output written exactly once; every
    (column, run) of a ring row copied by one thread; a head's lanes in one
    warp; shared memory ≤ 227 KB."""
    for rows, cols, batch, counts in ((11, 13, 2, _head_counts(d)),
                                      (40, 37, 1, _few_head_counts(d))):
        for heads in counts:
            for ndirs in (4, 8):
                out, p = _replay_fwd_plan(rows, cols, heads, d, ndirs, itemsize, batch)
                assert (out == 1).all(), (rows, heads, ndirs, p)


def _replay_fwd_walk_rings(rows, cols, heads, d, ndirs, itemsize):
    """K5's row walk (csrc/grid_attn.cu ``grid_attn_walk_kernel``) over
    every CTA of a feature group, its stages replayed: the empty rings take
    stages R0 .. R0 + STAGES - 1 at once (stage r: q row r and k, v row r +
    1, the first stage also rows R0 - 1 and R0), then row j waits for
    stage j and issues stage j + STAGES; row j reads k, v rows j - 1 .. j +
    1 and q row j. Checks that a row has landed before it is read and that
    a copy never replaces a row in use or in flight; returns per pixel how
    often its k/v and its q row are staged."""
    p = tga.fwd_plan(tga.GridAttnDims(rows, cols, heads, d, ndirs), itemsize)
    assert p.walk
    kv_n, q_n = np.zeros((rows, cols), np.int64), np.zeros((rows, cols), np.int64)
    for unit in range(p.strips * p.bands):
        c0, r0 = (unit % p.strips) * p.strip, (unit // p.strips) * p.band
        r1 = min(r0 + p.band, rows)
        kv_slot, q_slot, landed, kv_rows, q_rows = {}, {}, {}, [], []

        def issue(r, now):
            for rr in range(r0 - 1, r0 + 2) if r == r0 else [r + 1]:
                old = kv_slot.get((rr + 1) % KV_SLOTS_F)
                assert old is None or old < now - 1, (rr, old, now)
                kv_slot[(rr + 1) % KV_SLOTS_F] = rr
                landed[("kv", rr)] = r
                kv_rows.append(rr)
            old = q_slot.get(r % Q_SLOTS_F)
            assert old is None or old < now, (r, old, now)
            q_slot[r % Q_SLOTS_F] = r
            landed[("q", r)] = r
            q_rows.append(r)

        for st in range(STAGES_F):
            if r0 + st < r1:
                issue(r0 + st, r0 - 1)
        for j in range(r0, r1):
            if j + STAGES_F < r1:
                issue(j + STAGES_F, j)
            for r in (j - 1, j, j + 1):
                assert kv_slot[(r + 1) % KV_SLOTS_F] == r and landed[("kv", r)] <= j
            assert q_slot[j % Q_SLOTS_F] == j and landed[("q", j)] <= j
        assert kv_rows == list(range(r0 - 1, r1 + 1)) and q_rows == list(range(r0, r1))
        for n, rr, halo in ((kv_n, kv_rows, 1), (q_n, q_rows, 0)):
            rr = np.array([r for r in rr if 0 <= r < rows])
            cs = np.arange(max(0, c0 - halo), min(cols, c0 + p.strip + halo))
            np.add.at(n, (rr[:, None], cs[None, :]), 1)
    return kv_n, q_n, p


K_BF16_LOADS = 4  # csrc/grid_attn.cu kBf16Loads


def _stage_tile_copies(n1, nt, per, itemsize):
    """The copies csrc/grid_attn.cu ``stage_tile`` makes in one K5 tile CTA,
    as its loops number them (k and v on the n1-pixel halo, then q on the
    nt-pixel tile, ``per`` copies a pixel row): f32 by cp.async, thread t
    taking copies t, t + 256, ... of k and v, then of q; bf16 in one pass,
    thread t taking kBf16Loads copies x0 + u·256 at a time (x0 = t, t +
    kBf16Loads·256, ...), its loads first, a copy past the end storing
    nothing."""
    total, nkv = (n1 + nt) * per, n1 * per
    tid = np.arange(THREADS)[:, None]
    if itemsize == 4:
        kv = (tid + THREADS * np.arange(-(-nkv // THREADS))).ravel()
        q = (nkv + tid + THREADS * np.arange(-(-(total - nkv) // THREADS))).ravel()
        return np.concatenate([kv[kv < nkv], q[q < total]])
    x0 = (tid + K_BF16_LOADS * THREADS * np.arange(-(-total // (K_BF16_LOADS * THREADS)))).ravel()
    x = (x0[x0 < total][:, None] + THREADS * np.arange(K_BF16_LOADS)).ravel()
    return x[x < total]


def _replay_stage_tile(rows, cols, heads, d, itemsize, aligned, valid):
    """K5's tile staging (csrc/grid_attn.cu ``stage_tile``) over every CTA
    of an f32 (itemsize 4) or bf16 (2) launch: each staged (pixel, feature)
    of the k and v halo rows and of the q tile rows written once, the
    padding of a row never; a copy fetches exactly the valid pixels on the
    grid, its validity read at its own pixel; with 4-value copies (runs of
    4 or 8 features, aligned tensors) every copy reads 16 (f32) or 8
    (bf16) aligned bytes and writes 16 aligned bytes of a shared row. The
    rows are f32 of stride ≥ the group's width (4 mod 8 with 4-value runs,
    else odd) in both dtypes, so a bf16 CTA takes f32's shared memory."""
    dims = tga.GridAttnDims(rows, cols, heads, d, 8)
    p = tga.fwd_plan(dims, itemsize)
    assert not p.walk and p.smem == tga.fwd_plan(dims, 4).smem
    tr, tc, hpg, H = p.band, p.strip, p.hpg, heads * d
    run, _ = tga.fwd_lanes(d)
    vec4 = 32 % d == 0 and run >= 4 and aligned
    step = 4 if vec4 else 1
    S = hpg * d
    while S % 8 != 4 if 32 % d == 0 and run >= 4 else S % 2 != 1:
        S += 1
    tw, n1, nt = tc + 2, (tr + 2) * (tc + 2), tr * tc
    assert p.smem == 4 * (2 * n1 * S + nt * S + 8 * hpg * d + n1 + 8 * nt * hpg)
    for grp in range(-(-heads // hpg)):
        f0, gw = grp * hpg * d, min(hpg, heads - grp * hpg) * d
        per = gw // step
        x = _stage_tile_copies(n1, nt, per, itemsize)
        assert len(np.unique(x)) == len(x) == (n1 + nt) * per
        isq = x >= n1 * per
        y = np.where(isq, x - n1 * per, x)
        w, voff = np.where(isq, tc, tw), isq.astype(np.int64)
        px, f = y // per, (y % per) * step
        dst = px * S + f
        vi = (px // w + voff) * tw + px % w + voff  # the copy's entry of the halo's validity
        if vec4:
            assert (dst % 4 == 0).all() and (n1 * S) % 4 == 0
        for tile in range(p.strips * p.bands):
            r0, c0 = (tile // p.strips) * tr, (tile % p.strips) * tc
            r, c = r0 - 1 + voff + px // w, c0 - 1 + voff + px % w
            assert (r0 - 1 + vi // tw == r).all() and (c0 - 1 + vi % tw == c).all()
            on = (r >= 0) & (r < rows) & (c >= 0) & (c < cols)
            fetch = on & valid[np.where(on, r, 0), np.where(on, c, 0)]
            at = (r * cols + c) * H + f0 + f
            if vec4:
                assert (at[fetch] % 4 == 0).all()
            for region, n, sel in (("kv", n1, ~isq), ("q", nt, isq)):
                written = np.zeros((n, S), np.int64)
                np.add.at(written, (px[sel][:, None], f[sel][:, None] + np.arange(step)), 1)
                assert (written[:, :gw] == 1).all() and not written[:, gw:].any(), (region, p)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 8, 16, 32, 64, 256])
def test_fwd_plan_bf16_stages_every_row_once(d):
    """K5's staging at head width d, in bf16 and f32. Tiles (every d but 32,
    :func:`_replay_stage_tile`): on an 11 × 13 grid with a masked band, at
    every head count up to heads·d 256 and at H 768, aligned and (where
    copies take 4 values) misaligned tensors, each staged (pixel, feature)
    written once, only valid pixels fetched, 4-value copies aligned, f32
    rows of the padded stride in both dtypes. Row bands (d 32,
    :func:`_check_walk_rings`): on the 11 × 13 grid at H 32, 256 and 768,
    every k, v and q row staged once a band."""
    rows, cols = 11, 13
    valid = np.ones((rows, cols), bool)
    valid[4:6, 2:9] = False
    for heads in _head_counts(d):
        for itemsize in (4, 2):
            if tga.fwd_walks(d):
                if heads in (1, 8, 24):
                    _check_walk_rings(rows, cols, heads, 8, itemsize)
                continue
            for aligned in (True, False) if d in (4, 8, 16) else (True,):
                _replay_stage_tile(rows, cols, heads, d, itemsize, aligned, valid)


def _check_walk_rings(rows, cols, heads, ndirs, itemsize):
    """K5's row walk at d 32 (:func:`_replay_fwd_walk_rings`): every k and v
    row staged once a band with one row and column of halo each way (twice
    only on the rows and columns where bands and strips meet), every q row
    once; bf16 rings take half an f32 CTA's ring bytes."""
    d = 32
    kv_n, q_n, p = _replay_fwd_walk_rings(rows, cols, heads, d, ndirs, itemsize)
    np.testing.assert_array_equal(
        kv_n, np.outer(_covers(rows, p.band, 1, 1), _covers(cols, p.strip, 1, 1)))
    assert (q_n == 1).all()
    f32 = tga.walk_smem_bytes(ndirs, p.hpg, d, 4, p.strip, p.band)
    ring = (2 * KV_SLOTS_F * (p.strip + 2) + Q_SLOTS_F * p.strip) * p.hpg * d
    assert f32 - p.smem == (2 * ring if itemsize == 2 else 0)


@pytest.mark.parametrize("rows,cols", [(11, 13), (40, 37), (224, 304)])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("ndirs", [4, 8])
def test_fwd_walk_stages_every_row_once_a_band(ndirs, itemsize, rows, cols):
    """K5's row walk in bf16 and f32 (:func:`_check_walk_rings`) at d 32 on
    an 11 × 13, a 40 × 37 and the flagship's 224 × 304 grid, at H 32, 256
    and 768: every k and v row staged once a band with its halo, every q
    row once; a row lands before it is read, and no copy replaces a row in
    use or in flight. bf16 rows stay bf16."""
    for heads in (1, 8, 24):
        _check_walk_rings(rows, cols, heads, ndirs, itemsize)


def test_fwd_plan_keeps_the_tiles_where_the_walk_does_not_run():
    """K5 walks row bands exactly at d 32 (every head of the flagship and
    the MH cells but their 1-feature head convs) and keeps the pixel tiles
    at every other d, by :data:`FWD_TILES`, in both dtypes; the path is the
    plan's, by shape."""
    for d in range(1, 257):
        for itemsize in (4, 2):
            for heads in (1, 3):
                dims = tga.GridAttnDims(224, 304, heads, d, 4)
                p = tga.fwd_plan(dims, itemsize)
                _check_fwd_plan(p, dims, itemsize)
                assert p.walk == (d == 32)


@pytest.mark.parametrize("ndirs", [4, 8])
def test_fwd_plan_fills_the_card_on_the_flagship_grid(ndirs):
    """On the flagship's 224 × 304 grid at batch 1, at every path width
    (H 1, 32, 256, 768; and the MH head convs' 96 and 3) in f32 and bf16,
    K5's plan is one the kernel takes: row bands at d 32 that fill the
    H100 in one wave (at least one CTA a multiprocessor, and where the rows
    are split into bands at most as many as the multiprocessors hold at
    once at the CTA's threads, 128 registers a thread and shared memory),
    tiles at d 1 with at least one CTA a multiprocessor."""
    for heads, d in ((1, 1), (1, 32), (8, 32), (24, 32), (3, 32), (3, 1)):
        for itemsize in (4, 2):
            dims = tga.GridAttnDims(224, 304, heads, d, ndirs)
            p = tga.fwd_plan(dims, itemsize)
            _check_fwd_plan(p, dims, itemsize)
            ctas = p.strips * p.bands * -(-heads // p.hpg)
            assert p.walk == (d == 32) and tga.SMS <= ctas, p
            if p.walk:
                slots = min(2048 // p.threads, 65536 // (p.threads * tga.KERNEL_REGS),
                            tga.SM_SMEM // (p.smem + 1024))
                assert p.bands == 1 or ctas <= slots * tga.SMS, p
                assert p.threads <= 128


def _tree(x):
    """The pairwise tree over the last axis, (x0 + x1) + (x2 + x3), ..., in f32."""
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 32])
def test_fwd_lane_split_reproduces_the_head_sum(d):
    """A numpy model of K5's head sums: each of the head's lanes sums its
    run of contiguous features as a pairwise tree, then an xor butterfly
    over the lanes (lane l adds lane l ^ o's value, o = 1, 2, ...). Every
    lane ends with :func:`_head_sum`'s value, bit for bit."""
    run, lanes = tga.fwd_lanes(d)
    prod = (np.random.default_rng(d).standard_normal((4096, d)) * 10.0 ** np.random.default_rng(
        d + 1).integers(-6, 6, (4096, d))).astype(np.float32)
    vals = [_tree(prod[:, j * run:(j + 1) * run]) for j in range(lanes)]
    o = 1
    while o < lanes:
        vals = [vals[j] + vals[j ^ o] for j in range(lanes)]
        o *= 2
    ref = tga._head_sum(torch.from_numpy(prod), d).numpy()
    for v in vals:
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v.view(np.int32), ref.view(np.int32))


def test_fwd_lane_split_is_one_lane_in_order_off_the_tree():
    """Where d does not divide 32 one lane sums the head in feature order,
    as :func:`_head_sum` does."""
    for d in (3, 5, 6, 12, 64, 256):
        assert tga.fwd_lanes(d) == (d, 1)


def _k5_model(q, k, v, e, valid, keep, dims, plan):
    """A numpy model of csrc/grid_attn.cu K5 in f32, in its order of sums,
    for ``plan``'s layout. Per (pixel, head): each run of ``plan.run``
    features sums its products as a pairwise tree and an xor butterfly
    over the head's runs finishes the logit (where d does not divide 32,
    the tiles' one lane sums the head in feature order); the softmax in
    direction order, the denominator from 0; the output from 0 over every
    direction in order. Masked pixels and pixels off the grid read as zero
    (the kernels zero-fill their rows), so a direction without an edge adds
    used_i = 0 times a finite value, as the row walk adds it without a
    branch. exp is torch's, as the plain version's is."""
    rows, cols, heads, d, ndirs = dims
    f32 = np.float32
    b = q.shape[0]
    scale = f32(tga._scale(d))
    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1), (1, 1)][:ndirs]
    ok = valid.reshape(rows, cols) != 0
    q, k, v = (np.where(ok[None, ..., None], x.reshape(b, rows, cols, heads * d), f32(0))
               for x in (q, k, v))

    def shift(x, dr, dc):  # x[r - dr, c - dc], 0 off the grid
        out = np.zeros_like(x)
        rs, cs = slice(max(dr, 0), rows + min(dr, 0)), slice(max(dc, 0), cols + min(dc, 0))
        rd, cd = slice(max(-dr, 0), rows + min(-dr, 0)), slice(max(-dc, 0), cols + min(-dc, 0))
        out[..., rs, cs, :] = x[..., rd, cd, :]
        return out

    def tree(x):
        while x.shape[-1] > 1:
            x = x[..., 0::2] + x[..., 1::2]
        return x[..., 0]

    def head_dot(a, bb):  # (b, rows, cols, heads·d) x 2 -> (b, rows, cols, heads)
        prod = a * bb
        if 32 % d:
            prod = prod.reshape(b, rows, cols, heads, d)
            acc = prod[..., 0]
            for x in range(1, d):
                acc = acc + prod[..., x]
            return acc
        lanes = d // plan.run
        acc = tree(prod.reshape(b, rows, cols, heads, lanes, plan.run))
        o = 1
        while o < lanes:
            acc = acc + acc[..., np.arange(lanes) ^ o]
            o *= 2
        return acc[..., 0]

    okf = ok[None, ..., None]
    has = [okf & shift(okf.astype(f32), dr, dc).astype(bool) for dr, dc in shifts]
    lg = [head_dot(q, shift(k, dr, dc) + e[i]) * scale for i, (dr, dc) in enumerate(shifts)]
    mx = np.max([np.where(h, x, -np.inf) for h, x in zip(has, lg)], axis=0)
    ex = [np.where(h, torch.exp(torch.from_numpy(np.where(h, x - mx, f32(0)))).numpy(), f32(0))
          for h, x in zip(has, lg)]
    den = np.zeros_like(ex[0])
    for x in ex:
        den = den + x
    used = []
    for i, (h, x) in enumerate(zip(has, ex)):
        u = np.where(h, x / np.where(h, den, f32(1)), f32(0))
        if keep is not None:
            u = np.where(h, u * keep[:, i].reshape(b, rows, cols, heads), f32(0))
        used.append(np.repeat(u, d, axis=-1))
    out = np.zeros_like(q)
    for i, (dr, dc) in enumerate(shifts):
        out = out + used[i] * (shift(v, dr, dc) + e[i])
    return out.reshape(b, rows * cols, heads * d)


@pytest.mark.parametrize("heads,d,ndirs,dropout,itemsize", [
    (8, 32, 4, True, 4), (8, 32, 4, False, 2), (1, 32, 8, False, 4), (24, 32, 4, True, 2),
    (2, 16, 8, True, 4), (4, 8, 4, False, 2), (1, 1, 4, True, 4), (3, 6, 8, True, 4)])
def test_k5_order_model_matches_the_plain_forward(heads, d, ndirs, dropout, itemsize):
    """:func:`_k5_model` (K5's order of sums in the plan's layout: row bands
    at d 32, tiles at d 16, 8, 1 and 6) on the 12 × 20 mask at batch 2
    against ``grid_attn_plain``: equal value for value, as K5 is held to it
    on the card, and within 1e-5 of the JAX package's ``grid_attn_apply``
    (its Pallas kernel in interpret mode); masked pixels and the isolated
    pixel exactly 0."""
    q, k, v, _, e = _operands(heads, d, ndirs, heads * 5 + d + ndirs)
    valid = (~_mask()).astype(np.float32).reshape(-1)
    keep = None
    if dropout:
        rng = np.random.default_rng(6)
        keep = ((rng.random((B, ndirs, P, heads)) < 0.9) / 0.9).astype(np.float32)
    dims = tga.GridAttnDims(*SHAPE, heads, d, ndirs)
    plan = tga.fwd_plan(dims, itemsize, B)
    assert plan.walk == (d == 32)
    mine = _k5_model(q, k, v, e, valid, keep, dims, plan)
    assert mine.dtype == np.float32
    plain = tga.grid_attn_plain(*(torch.from_numpy(x) for x in (q, k, v, e, valid)),
                                None if keep is None else torch.from_numpy(keep), dims).numpy()
    np.testing.assert_array_equal(mine, plain)
    jdims = jga.GridAttnDims(*SHAPE, heads, d, ndirs, dropout)
    for s in range(B):
        ref = jga.grid_attn_apply(jnp.asarray(q[s]), jnp.asarray(k[s]), jnp.asarray(v[s]),
                                  jnp.asarray(e), jnp.asarray(valid)[:, None],
                                  None if keep is None else jnp.asarray(keep[s]), jdims)
        np.testing.assert_allclose(mine[s], np.asarray(ref), rtol=0, atol=FWD_TOL)
    out2d = mine.reshape(B, *SHAPE, -1)
    assert not out2d[:, _mask()].any() and not out2d[:, ISOLATED[0], ISOLATED[1]].any()


# ---------------------------------------------------------------- K6's plan

KV_SLOTS, QG_SLOTS, STAGES = tga.BWD_KV_SLOTS, tga.BWD_QG_SLOTS, tga.BWD_STAGES


def _check_bwd_plan(p, dims, itemsize):
    """The plan is one csrc/grid_attn.cu ``grid_attn_bwd`` takes: whole
    warps, at most 256 threads, one thread a (column, run) of the outputs,
    16-byte runs only where d takes a power of two of them, and shared
    memory within an H100 CTA's 227 KB."""
    rows, cols, heads, d, ndirs = dims
    assert p.threads % 32 == 0 and 32 <= p.threads <= THREADS
    assert p.run in (1, 16 // itemsize) and p.hpg == min(heads, max(1, 32 // d))
    if p.run > 1:
        lanes = d // p.run
        assert d % p.run == 0 and lanes & (lanes - 1) == 0 and lanes <= 32
    assert p.strip * p.hpg * d // p.run <= p.threads
    assert p.smem == tga.bwd_smem_bytes(ndirs, p.hpg, d, p.run, itemsize, p.strip, p.band)
    assert p.smem <= SMEM_LIMIT
    assert p.strips == -(-cols // p.strip) and p.bands == -(-rows // p.band)
    assert p.strip <= cols and 1 <= p.band <= rows


def _replay_bwd_plan(rows, cols, heads, d, ndirs, itemsize, batch):
    """K6's launch, replayed as csrc/grid_attn.cu ``grid_attn_bwd_kernel``
    indexes it: returns how often each (sample, pixel, feature) of dq, dk
    and dv is written, and per pixel how often its k/v and q/g rows are
    staged and its softmax computed (over the CTAs of a group), after
    walking every CTA's row rings: a stage lands before a row is read, and
    a copy never replaces a row still in use."""
    dims = tga.GridAttnDims(rows, cols, heads, d, ndirs)
    p = tga.bwd_plan(dims, itemsize, batch)
    _check_bwd_plan(p, dims, itemsize)
    w, bh, run, hpg = p.strip, p.band, p.run, p.hpg
    groups = -(-heads // hpg)
    out = np.zeros((batch, rows, cols, heads * d), np.int64)
    kv_n, qg_n = np.zeros((rows, cols), np.int64), np.zeros((rows, cols), np.int64)
    soft = np.zeros((rows, cols, heads), np.int64)
    tid = np.arange(p.threads)
    for b in range(batch):
        for grp in range(groups):
            h0 = grp * hpg
            gh = min(hpg, heads - h0)
            runs = gh * d // run
            lanes = d // run if run > 1 else 1
            for unit in range(p.strips * p.bands):
                c0, r0 = (unit % p.strips) * w, (unit // p.strips) * bh
                r1 = min(r0 + bh, rows)
                c, jr = tid // runs, tid % runs
                act = (tid < w * runs) & (c0 + c < cols)
                for s in range(r0, r1):
                    for x in range(run):
                        np.add.at(out, (b, s, c0 + c[act], h0 * d + jr[act] * run + x), 1)
                if b:
                    continue
                # the softmax items: one (column, head) each with sub 0, a
                # head's lanes aligned in one warp
                items = (w + 2) * gh * lanes
                it = np.arange(-(-items // p.threads) * p.threads)
                on = it < items
                cc, hh, sub = it // (gh * lanes), (it // lanes) % gh, it % lanes
                assert ((it // lanes) * lanes // 32 == it // 32)[on].all()
                first = on & (sub == 0)
                assert len(set(zip(cc[first], hh[first]))) == first.sum() == (w + 2) * gh
                # the walk: stage j brings k/v row j + 2 (the first stage
                # R0-2..R0) and q/g row j + 1; the empty rings take stages
                # R0-2..R0+1 at once, then iteration j waits for stage j,
                # issues stage j + STAGES, takes the softmax of row j + 1
                # and the outputs of row j (rows from j - 1 on in use)
                kv_slot, qg_slot, done, kv_rows, qg_rows = {}, {}, set(), [], []

                def issue(j, now):
                    for r in range(r0 - 2 if j == r0 - 2 else j + 2, j + 3):
                        old = kv_slot.get((r + 2) % KV_SLOTS)
                        assert old is None or old < now - 1, (r, old, now)
                        kv_slot[(r + 2) % KV_SLOTS] = r
                        kv_rows.append(r)
                    old = qg_slot.get((j + 2) % QG_SLOTS)
                    assert old is None or old < now - 1, (j + 1, old, now)
                    qg_slot[(j + 2) % QG_SLOTS] = j + 1
                    qg_rows.append(j + 1)

                for st in range(STAGES + 2):
                    if r0 - 2 + st <= r1 - 1:
                        issue(r0 - 2 + st, r0 - 3)
                for j in range(r0 - 2, r1):
                    done.add(j)
                    if r0 + 1 < j + STAGES <= r1 - 1:
                        issue(j + STAGES, j)
                    last = set(range(j - 1, j + 2)) if j >= r0 else set()  # outputs of row j
                    used_kv = set(range(j, j + 3)) | last
                    used_qg = {j + 1} | last
                    for r in used_kv:
                        assert kv_slot[(r + 2) % KV_SLOTS] == r and max(r - 2, r0 - 2) in done
                    for r in used_qg:
                        assert qg_slot[(r + 1) % QG_SLOTS] == r and r - 1 in done
                    r = j + 1  # this iteration's softmax row
                    if 0 <= r < rows:
                        cs = c0 - 1 + cc[first]
                        ok = (cs >= 0) & (cs < cols)
                        np.add.at(soft, (r, cs[ok], h0 + hh[first][ok]), 1)
                assert kv_rows == list(range(r0 - 2, r1 + 2))  # each row once, halo included
                assert qg_rows == list(range(r0 - 1, r1 + 1))
                if grp == 0:
                    for n, rr, halo in ((kv_n, kv_rows, 2), (qg_n, qg_rows, 1)):
                        rr = np.array([r for r in rr if 0 <= r < rows])
                        cs = np.arange(max(0, c0 - halo), min(cols, c0 + w + halo))
                        np.add.at(n, (rr[:, None], cs[None, :]), 1)
    return out, kv_n, qg_n, soft, p


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("ndirs", [4, 8])
@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 16, 32, 64])
def test_bwd_plan_writes_every_output_once_and_stages_each_row_once(d, ndirs, itemsize):
    """K6 (csrc/grid_attn.cu), replayed by :func:`_replay_bwd_plan` on an
    11 × 13 grid at batch 2 and a 40 × 37 grid at batch 1, at one head, a
    full feature group
    and H 768 (one launch at any width), in f32 and bf16: every (pixel,
    feature) of dq, dk and dv written once; every k/v row staged once a
    strip with its two rows and columns of halo, every q/g row with one;
    every pixel's softmax computed once, twice on the rows and columns
    where strips and bands meet; the ring never reads a row before it lands
    or replaces one in use; shared memory ≤ 227 KB."""
    for rows, cols, batch in ((11, 13, 2), (40, 37, 1)):
        for heads in sorted({1, max(1, 32 // d), 768 // d}):
            out, kv_n, qg_n, soft, p = _replay_bwd_plan(rows, cols, heads, d, ndirs, itemsize,
                                                        batch)
            assert (out == 1).all(), (rows, heads, p)
            assert (p.run > 1) == (d * itemsize % 16 == 0
                                   and (d * itemsize // 16) in (1, 2, 4, 8, 16, 32))
            r2, c2 = _covers(rows, p.band, 2, 2), _covers(cols, p.strip, 2, 2)
            np.testing.assert_array_equal(kv_n, np.outer(r2, c2))
            r1, c1 = _covers(rows, p.band, 1, 1), _covers(cols, p.strip, 1, 1)
            np.testing.assert_array_equal(qg_n, np.outer(r1, c1))
            np.testing.assert_array_equal(soft, np.outer(r1, c1)[..., None] + 0 * soft)


@pytest.mark.parametrize("ndirs", [4, 8])
def test_bwd_plan_fills_the_card_on_the_flagship_grid(ndirs):
    """On the flagship's 224 × 304 grid at batch 1, at every path width
    (H 1, 32, 256, and 768 in one launch) in f32 and bf16, K6's plan is one
    the kernel takes, with 16-byte runs where d is 32, and fills the H100
    in one wave: at least one CTA a multiprocessor (132), and where the
    rows are split into bands at most as many as the multiprocessors hold
    at once (four CTAs of 128 threads of at most 128 registers, fewer where
    their shared memory takes more than a quarter of a multiprocessor's)."""
    for heads, d in ((1, 1), (1, 32), (8, 32), (24, 32)):
        for itemsize in (4, 2):
            dims = tga.GridAttnDims(224, 304, heads, d, ndirs)
            p = tga.bwd_plan(dims, itemsize)
            _check_bwd_plan(p, dims, itemsize)
            ctas = p.strips * p.bands * -(-heads // p.hpg)
            slots = min(4, tga.SM_SMEM // (p.smem + 1024))
            assert tga.SMS <= ctas and p.threads <= 128, p
            assert p.bands == 1 or ctas <= slots * tga.SMS, p
            assert p.run == (16 // itemsize if d == 32 else 1)


def _k6_model(q, k, v, g, e, valid, keep, dims, plan):
    """A numpy model of csrc/grid_attn.cu K6 in f32, in its order of sums.
    Per (pixel, head): each run of ``plan.run`` features sums its products
    in feature order and an xor butterfly over the head's runs finishes the
    logit and dα sums (single features: the head in order); the softmax in
    direction order; dq, dk, dv over the directions in order; de: each
    (column, feature) thread adds its band's pixels in row order, the
    strip's columns are summed by the kernel's halving tree, and the CTAs'
    partials, in (sample, band, strip) order, by the group's last CTA:
    chunks of consecutive partials each in order, then the chunks in order.
    Masked pixels and pixels off the grid read as zero (the kernel
    zero-fills their rows)."""
    rows, cols, heads, d, ndirs = dims
    f32 = np.float32
    b = q.shape[0]
    scale = f32(tga._scale(d))
    shifts = [(-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (1, -1), (-1, 1), (1, 1)][:ndirs]
    ok = valid.reshape(rows, cols) != 0
    q, k, v, g = (np.where(ok[None, ..., None], x.reshape(b, rows, cols, heads * d), f32(0))
                  for x in (q, k, v, g))

    def shift(x, dr, dc, fill=0):  # x[r - dr, c - dc], fill off the grid
        out = np.full_like(x, fill)
        rs, cs = slice(max(dr, 0), rows + min(dr, 0)), slice(max(dc, 0), cols + min(dc, 0))
        rd, cd = slice(max(-dr, 0), rows + min(-dr, 0)), slice(max(-dc, 0), cols + min(-dc, 0))
        out[..., rs, cs, :] = x[..., rd, cd, :]
        return out

    run = plan.run if plan.run > 1 else d
    lanes = d // run

    def head_dot(a, bb):  # (b, rows, cols, heads·d) x 2 -> (b, rows, cols, heads)
        prod = (a * bb).reshape(b, rows, cols, heads, lanes, run)
        acc = prod[..., 0]
        for x in range(1, run):
            acc = acc + prod[..., x]
        o = 1
        while o < lanes:
            acc = acc + acc[..., np.arange(lanes) ^ o]
            o *= 2
        return acc[..., 0]

    okf = ok[None, ..., None]
    has, lq, lg = [], [], []
    for i, (dr, dc) in enumerate(shifts):
        has.append(okf & (shift(ok[None, ..., None].astype(f32), dr, dc) != 0))
        ei = e[i][None, None, None, :]
        lq.append(head_dot(q, shift(k, dr, dc) + ei) * scale)
        lg.append(head_dot(g, shift(v, dr, dc) + ei))
    mx = np.max([np.where(h, x, -np.inf) for h, x in zip(has, lq)], axis=0)
    ex = [np.where(h, np.exp(np.where(h, x - mx, 0)), f32(0)).astype(f32) for h, x in zip(has, lq)]
    den = ex[0]
    for x in ex[1:]:
        den = den + x
    kp = [np.ones((b, rows, cols, heads), f32) if keep is None else
          keep[:, i].reshape(b, rows, cols, heads) for i in range(ndirs)]
    alpha = [np.where(h, x / np.where(h, den, 1), f32(0)) for h, x in zip(has, ex)]
    kp = [np.where(h, x, f32(1)) for h, x in zip(has, kp)]
    dal = [x * y for x, y in zip(lg, kp)]
    rowdot = alpha[0] * dal[0]
    for a, da in zip(alpha[1:], dal[1:]):
        rowdot = rowdot + a * da
    dl = [(a * (da - rowdot)) * scale for a, da in zip(alpha, dal)]
    used = [a * x for a, x in zip(alpha, kp)]
    rep = lambda x: np.repeat(x, d, axis=-1)  # noqa: E731  (a head's value on its features)
    dq = dk = dv = np.zeros_like(q)
    for i, (dr, dc) in enumerate(shifts):
        dq = dq + rep(dl[i]) * (shift(k, dr, dc) + e[i])
        dk = dk + shift(rep(dl[i]), -dr, -dc) * shift(q, -dr, -dc)
        dv = dv + shift(rep(used[i]), -dr, -dc) * shift(g, -dr, -dc)
    terms = np.stack([rep(dl[i]) * q + rep(used[i]) * g for i in range(ndirs)], axis=3)
    w, bh = plan.strip, plan.band
    parts = []
    for s in range(b):
        for unit in range(plan.strips * plan.bands):
            c0, r0 = (unit % plan.strips) * w, (unit // plan.strips) * bh
            red = np.zeros((w, ndirs, heads * d), f32)
            for r in range(r0, min(r0 + bh, rows)):
                red[:min(w, cols - c0)] = red[:min(w, cols - c0)] + terms[s, r, c0:c0 + w]
            width = w
            while width > 1:
                half = (width + 1) // 2
                red[:width - half] = red[:width - half] + red[half:width]
                width = half
            parts.append(red[0])
    # each group's last CTA: C = D × group width columns; with fewer
    # columns than threads, chunks of consecutive partials each in order,
    # then the chunks in order
    de = np.zeros((ndirs, heads * d), f32)
    for h0 in range(0, heads, plan.hpg):
        grp = slice(h0 * d, min(heads, h0 + plan.hpg) * d)
        c = ndirs * (grp.stop - grp.start)
        chunks = 1 if c >= plan.threads else plan.threads // c
        per = -(-len(parts) // chunks)
        for k in range(chunks):
            acc = np.zeros((ndirs, grp.stop - grp.start), f32)
            for u in range(k * per, min(len(parts), (k + 1) * per)):
                acc = acc + parts[u][:, grp]
            de[:, grp] = acc if k == 0 else de[:, grp] + acc
    flat = lambda x: x.reshape(b, rows * cols, heads * d)  # noqa: E731
    return flat(dq), flat(dk), flat(dv), de


@pytest.mark.parametrize("heads,d,ndirs,dropout", [
    (8, 32, 4, True), (1, 32, 8, False), (1, 1, 4, True), (3, 6, 8, True), (2, 16, 4, False),
    (24, 32, 4, True)])
def test_k6_order_model_matches_the_plain_backward(heads, d, ndirs, dropout):
    """:func:`_k6_model` (K6's order of sums: runs then butterfly, the
    directions in order, de by thread rows, column tree and CTA partials)
    on the 12 × 20 mask at batch 2 against ``grid_attn_bwd_plain``: dq,
    dk, dv and de_dir within 1e-5 × max(1, max|plain|), the tolerance K6
    is held to on the card; masked pixels exactly 0."""
    q, k, v, g, e = _operands(heads, d, ndirs, heads * 7 + d + ndirs)
    valid = (~_mask()).astype(np.float32).reshape(-1)
    keep = None
    if dropout:
        rng = np.random.default_rng(5)
        keep = ((rng.random((B, ndirs, P, heads)) < 0.9) / 0.9).astype(np.float32)
    dims = tga.GridAttnDims(*SHAPE, heads, d, ndirs)
    plan = tga.bwd_plan(dims, 4, B)
    mine = _k6_model(q, k, v, g, e, valid, keep, dims, plan)
    ref = tga.grid_attn_bwd_plain(*(torch.from_numpy(x) for x in (q, k, v, e, valid)),
                                  None if keep is None else torch.from_numpy(keep), dims,
                                  torch.from_numpy(g))
    for name, a, r in zip(("dq", "dk", "dv", "de_dir"), mine, ref):
        r = r.numpy()
        assert a.dtype == np.float32
        err = np.abs(a - r).max()
        assert err <= 1e-5 * max(1.0, np.abs(r).max()), (name, err)
    for a in mine[:3]:
        assert not a[:, valid == 0].any()


def test_grid_attn_apply_at_h768_is_one_call(monkeypatch):
    """``GridAttnApply`` at H 768 (24 heads × d 32, the sea-ice MH cells)
    calls the plain forward and backward once each on the CPU, on the whole
    width, bit-identical to them (the CUDA path launches K5 and K6 once
    each the same way: tests/test_torch_kernels_cuda.py); neither attention
    module has a head-group dispatch left, so no call splits heads."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn as tattn

    assert not any(hasattr(tga, n) for n in ("grid_fwd_by_groups", "grid_bwd_by_groups",
                                             "MAX_H", "head_groups"))
    assert not any(hasattr(tattn, n) for n in ("attn_fwd_by_groups", "attn_bwd_by_groups",
                                               "head_groups"))
    calls = []
    for name in ("grid_attn_plain", "grid_attn_bwd_plain"):
        real = getattr(tga, name)
        monkeypatch.setattr(tga, name, lambda *a, _r=real, _n=name: calls.append(
            (_n, a[0].shape[-1])) or _r(*a))
    heads, d, ndirs = 24, 32, 4
    q, k, v, g, e = _operands(heads, d, ndirs, 768)
    valid = torch.from_numpy((~_mask()).astype(np.float32).reshape(-1))
    keep = torch.from_numpy(((np.random.default_rng(9).random((B, ndirs, P, heads)) < 0.9)
                             / 0.9).astype(np.float32))
    dims = tga.GridAttnDims(*SHAPE, heads, d, ndirs)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v, e)]
    out = tga.grid_attn_apply(*leaves, valid, keep, dims)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    # the plain backward recomputes through the plain forward, at full width
    assert calls == [("grid_attn_plain", 768), ("grid_attn_bwd_plain", 768),
                     ("grid_attn_plain", 768)]
    plain = [torch.from_numpy(x) for x in (q, k, v, e)]
    assert torch.equal(out.detach(), tga.grid_attn_plain(*plain, valid, keep, dims))
    for a, b in zip(grads, tga.grid_attn_bwd_plain(*plain, valid, keep, dims,
                                                   torch.from_numpy(g))):
        assert torch.equal(a, b)
