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


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 8, 16, 32, 64, 256])
def test_fwd_plan_covers_every_pixel_and_feature_once(d):
    """K5's launch, replayed as csrc/grid_attn.cu indexes it: the CTAs'
    (tile, feature group) pairs and each CTA's (pixel, head) items and lane
    runs cover every (pixel, feature) of an 11 × 13 grid exactly once, for
    every head count the wrapper accepts at this d (heads·d ≤ 256) and both
    D; a head's lanes sit in one warp; the CTA's shared memory fits."""
    rows, cols = 11, 13
    for heads in range(1, tga.MAX_H // d + 1):
        for ndirs in (4, 8):
            dims = tga.GridAttnDims(rows, cols, heads, d, ndirs)
            hpg, tr, tc, tiles = tga.fwd_plan(dims)
            run, lanes = tga.fwd_lanes(d)
            assert run * lanes == d and 32 % lanes == 0
            assert tga.fwd_smem_bytes(dims, hpg, tr, tc) <= SMEM_LIMIT, (heads, d)
            groups = -(-heads // hpg)
            tiles_c = -(-cols // tc)
            assert tiles == -(-rows // tr) * tiles_c
            count = np.zeros((rows, cols, heads * d), dtype=np.int64)
            for x in range(tiles * groups):
                grp, tile = x % groups, x // groups
                r0, c0 = (tile // tiles_c) * tr, (tile % tiles_c) * tc
                h0 = grp * hpg
                gh = min(hpg, heads - h0)
                items = np.arange(tr * tc * gh)
                px, hh = items // gh, items % gh
                r, c = r0 + px // tc, c0 + px % tc
                on = (r < rows) & (c < cols)
                for sub in range(lanes):
                    for j in range(run):
                        f = h0 * d + hh * d + sub * run + j
                        np.add.at(count, (r[on], c[on], f[on]), 1)
            assert (count == 1).all(), (heads, d, ndirs)


@pytest.mark.parametrize("d", [1, 2, 3, 4, 6, 8, 16, 32, 64, 256])
def test_fwd_plan_bf16_stages_every_row_once(d):
    """K5 in bf16 keeps its f32 plan and f32 shared rows: bf16 rows are
    loaded, widened and stored by the threads (csrc/grid_attn.cu
    ``stage_rows``), 4 values a load where the f32 kernel copies 16 bytes
    (runs of 4 or 8 features) and 1 value a load elsewhere. Replayed over
    the k/v halo and the q tile of every CTA of an 11 × 13 grid: each
    staged (pixel, feature) is written once, every 4-value load reads 8
    aligned bytes of the bf16 tensor and stores 16 aligned bytes of a
    shared row, and the shared memory is f32's."""
    rows, cols = 11, 13
    for heads in range(1, tga.MAX_H // d + 1):
        dims = tga.GridAttnDims(rows, cols, heads, d, 8)
        hpg, tr, tc, tiles = tga.fwd_plan(dims)
        run, _ = tga.fwd_lanes(d)
        vec4 = 32 % d == 0 and run >= 4
        step = 4 if vec4 else 1
        gw_full, h = hpg * d, heads * d
        stride = gw_full
        while stride % 8 != 4 if vec4 else stride % 2 != 1:
            stride += 1
        assert tga.fwd_smem_bytes(dims, hpg, tr, tc) <= SMEM_LIMIT
        groups, tiles_c = -(-heads // hpg), -(-cols // tc)
        for x in range(tiles * groups):
            grp, tile = x % groups, x // groups
            r0, c0 = (tile // tiles_c) * tr, (tile % tiles_c) * tc
            f0 = grp * hpg * d
            gw = min(hpg, heads - grp * hpg) * d
            for w, n, org in ((tc + 2, (tr + 2) * (tc + 2), (r0 - 1, c0 - 1)),
                              (tc, tr * tc, (r0, c0))):
                i = np.arange(n * (gw // step))  # the copies, as the kernel's loop numbers them
                px, f = i // (gw // step), (i % (gw // step)) * step
                written = np.zeros((n, gw), dtype=np.int64)
                np.add.at(written, (px[:, None], f[:, None] + np.arange(step)), 1)
                assert (written == 1).all(), (heads, d)
                if vec4:
                    r, c = org[0] + px // w, org[1] + px % w
                    inside = (r >= 0) & (r < rows) & (c >= 0) & (c < cols)
                    assert ((px * stride + f) % 4 == 0).all()  # a float4 of the shared row
                    at = (r * cols + c) * h + f0 + f
                    assert (at[inside] % 4 == 0).all()  # 8 aligned bytes of the bf16 rows


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
