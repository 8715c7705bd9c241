"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Skips without one (the kernels have no CPU mode). Imports no JAX,
so it runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.ops import spmm
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding

pytestmark = pytest.mark.cuda

NT, EB, SW = 128, 1024, 1024


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _windows(device, n_max=2048, shape=(64, 64), batch=3, thresh=0.1):
    cfg = GraphConfig(image_shape=shape, max_grid_size=8, thresh=thresh, n_max=n_max,
                      e_max=5 * n_max, node_budget=n_max, use_edge_attrs=False)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((batch, 1, *shape, 1)) ** 4).astype(np.float32))
    g, _ = image_to_graph(add_positional_encoding(x), cfg)
    w, ovf = spmm.spmm_tile_meta(g.edge_src, g.edge_dst, g.sym_coeff, n_max, NT, EB, SW)
    assert int(ovf.max()) == 0
    w = spmm.SpmmWindows(*(t.to(device) for t in w))
    live = spmm.live_tiles(g.n_nodes.to(device), w.src_rel.shape[1], NT)
    return w, live, n_max


def test_build_blocks_kernel_is_exact(card):
    w, live, _ = _windows(card)
    args = (w.src_rel, w.dst_rel, w.coeff, live, NT, SW)
    before = spmm.LAUNCHES["spmm_build_blocks"]
    blocks = spmm._build_blocks_cuda(*args)
    assert spmm.LAUNCHES["spmm_build_blocks"] == before + 1
    torch.testing.assert_close(blocks, spmm.build_blocks_plain(*args), rtol=0, atol=0)


@pytest.mark.parametrize("f", [1, 16, 17, 20, 32, 33, 128])
def test_apply_kernel_matches_plain(card, f):
    w, live, n_max = _windows(card)
    blocks = spmm.build_blocks_plain(w.src_rel, w.dst_rel, w.coeff, live, NT, SW)
    gen = torch.Generator(card).manual_seed(f)
    z = torch.randn(w.s0.shape[0], n_max, f, device=card, generator=gen)
    args = (z, w.s0, blocks, live, n_max, NT, SW)
    torch.testing.assert_close(spmm._apply_cuda(*args), spmm.apply_plain(*args),
                               rtol=0, atol=1e-5)


def test_apply_kernel_dead_tiles_and_ragged_shapes(card):
    """n_max not a multiple of NT, SW not a multiple of the kernel's stage,
    windows running past n_max, and dead tiles."""
    nt, sw, n_max = 64, 72, 200
    w, _ = spmm.spmm_tile_meta(*_edges(card, n_max), n_max, nt, 256, sw)
    live = torch.tensor([1, 2, 4], dtype=torch.int32, device=card)
    blocks = spmm._build_blocks_cuda(w.src_rel, w.dst_rel, w.coeff, live, nt, sw)
    torch.testing.assert_close(
        blocks, spmm.build_blocks_plain(w.src_rel, w.dst_rel, w.coeff, live, nt, sw),
        rtol=0, atol=0)
    z = torch.randn(3, n_max, 5, device=card, generator=torch.Generator(card).manual_seed(0))
    args = (z, w.s0, blocks, live, n_max, nt, sw)
    torch.testing.assert_close(spmm._apply_cuda(*args), spmm.apply_plain(*args),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("f", [1, 5, 17, 33, 128, 129])
def test_apply_kernel_one_live_tile_and_windows_past_n_max(card, f):
    """K2 and K2b with one live tile a sample, n_max (200) no multiple of NT
    (64), source windows that run past n_max, and F on both sides of each
    of the kernel's feature widths (32, 64, 128, 256 a warp); each launch
    counts once, and a repeated launch is bit-identical."""
    nt, sw, n_max = 64, 72, 200
    w, _ = spmm.spmm_tile_meta(*_edges(card, n_max), n_max, nt, 256, sw)
    live = torch.ones(3, dtype=torch.int32, device=card)
    blocks = spmm.build_blocks_plain(w.src_rel, w.dst_rel, w.coeff, live, nt, sw)
    # a window past n_max on the one live tile: rows there must read as zero
    s0 = w.s0.clone()
    s0[:, 0] = n_max - sw // 2
    z = torch.randn(3, n_max, f, device=card, generator=torch.Generator(card).manual_seed(f))
    args = (z, s0, blocks, live, n_max, nt, sw)
    before = dict(spmm.LAUNCHES)
    out = spmm._apply_cuda(*args)
    out_b = spmm._apply_bwd_cuda(*args)
    assert spmm.LAUNCHES["spmm_apply"] == before["spmm_apply"] + 1
    assert spmm.LAUNCHES["spmm_apply_bwd"] == before["spmm_apply_bwd"] + 1
    plain = spmm.apply_plain(*args)
    torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    torch.testing.assert_close(out_b, plain, rtol=0, atol=1e-5)
    assert not out[:, nt:].any() and out[:, :nt].any()
    assert torch.equal(spmm._apply_cuda(*args), out)


def test_apply_kernel_repeats_bit_for_bit_on_the_main_paths_windows(card):
    """K2 on the main path's window geometry (64×64 meshes, NT 128, SW
    1024, n_max 2048, batch 16) at F 32: two launches are bit-identical,
    and both within 1e-5 of ``apply_plain``."""
    w, live, n_max = _windows(card, batch=16)
    blocks = spmm._build_blocks_cuda(w.src_rel, w.dst_rel, w.coeff, live, NT, SW)
    z = torch.randn(16, n_max, 32, device=card, generator=torch.Generator(card).manual_seed(3))
    args = (z, w.s0, blocks, live, n_max, NT, SW)
    first, second = spmm._apply_cuda(*args), spmm._apply_cuda(*args)
    assert torch.equal(first, second)
    torch.testing.assert_close(first, spmm.apply_plain(*args), rtol=0, atol=1e-5)


def _edges(device, n_max):
    cfg = GraphConfig(image_shape=(16, 16), max_grid_size=8, thresh=0.3, n_max=n_max,
                      e_max=2048, use_edge_attrs=False)
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.random((3, 1, 16, 16, 1)) ** 4).astype(np.float32))
    g, _ = image_to_graph(add_positional_encoding(x), cfg)
    return g.edge_src.to(device), g.edge_dst.to(device), g.sym_coeff.to(device)


def test_wrappers_reject_bad_inputs(card):
    w, live, n_max = _windows(card)
    with pytest.raises(TypeError):
        spmm._build_blocks_cuda(w.src_rel.long(), w.dst_rel, w.coeff, live, NT, SW)
    with pytest.raises(ValueError):
        spmm._apply_cuda(torch.zeros(3, n_max, 4), w.s0, torch.zeros(1), live, n_max, NT, SW)


def _k2b_case(device, ragged):
    """(z-shaped operands, meta geometry) whose Â is symmetric: no window
    drops an edge, and dead tiles come from the node count alone."""
    if ragged:  # n_max not a multiple of NT, SW not a multiple of the stage
        n_max, nt, eb, sw, side, e_max = 200, 64, 512, 200, 16, 800
    else:
        n_max, nt, eb, sw, side, e_max = 2048, NT, EB, SW, 64, 10240
    cfg = GraphConfig(image_shape=(side, side), max_grid_size=8, thresh=0.1, n_max=n_max,
                      e_max=e_max, node_budget=n_max, use_edge_attrs=False)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((3, 1, side, side, 1)) ** 4).astype(np.float32))
    g, _ = image_to_graph(add_positional_encoding(x), cfg)
    assert int(g.overflow.max()) == 0
    src, dst, coeff, n_nodes = (t.to(device) for t in (g.edge_src, g.edge_dst,
                                                         g.sym_coeff, g.n_nodes))
    w, ovf = spmm.spmm_tile_meta(src, dst, coeff, n_max, nt, eb, sw)
    assert int(ovf.max()) == 0
    meta = spmm.spmm_build_blocks(w, nt, sw, n_nodes)
    assert int(meta.live.min()) < w.s0.shape[1]  # dead tiles
    return meta, n_max, nt, sw


@pytest.mark.parametrize("f,ragged", [(16, False), (128, False), (5, True)])
def test_apply_backward_kernel_is_the_transpose(card, f, ragged):
    """K2b: the gradient through ``spmm_apply`` launches the kernel on the
    cotangent and equals autograd's transpose through ``apply_plain``."""
    meta, n_max, nt, sw = _k2b_case(card, ragged)
    gen = torch.Generator(card).manual_seed(f)
    b = meta.s0.shape[0]
    z = torch.randn(b, n_max, f, device=card, generator=gen, requires_grad=True)
    g = torch.randn(b, n_max, f, device=card, generator=gen)
    out = spmm.spmm_apply(z, meta, n_max, nt, sw)
    assert type(out.grad_fn).__name__ == "SpmmApplyBackward"
    before = dict(spmm.LAUNCHES)
    (dz,) = torch.autograd.grad(out, z, g)
    assert spmm.LAUNCHES["spmm_apply_bwd"] == before["spmm_apply_bwd"] + 1
    assert spmm.LAUNCHES["spmm_apply"] == before["spmm_apply"]
    plain = spmm.apply_plain(z, meta.s0, meta.blocks, meta.live, n_max, nt, sw)
    (dz_t,) = torch.autograd.grad(plain, z, g)
    torch.testing.assert_close(dz, dz_t, rtol=0, atol=1e-5)


def test_unflatten_backward_is_reproducible_on_the_card(card):
    from quadtree_mpnnlstm_tpu_torch.graph.state import unflatten

    cfg = GraphConfig(image_shape=(64, 64), max_grid_size=8, thresh=0.1, n_max=2048,
                      e_max=10240, node_budget=2048, use_edge_attrs=False)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.random((4, 1, 64, 64, 1)) ** 4).astype(np.float32)).to(card)
    graph, _ = image_to_graph(add_positional_encoding(x), cfg)
    nodes = torch.randn(4, 2048, 16, device=card, generator=torch.Generator(card).manual_seed(0),
                        requires_grad=True)
    cot = torch.randn(4, 64, 64, 16, device=card, generator=torch.Generator(card).manual_seed(1))
    grads = [torch.autograd.grad(unflatten(nodes, graph, (64, 64)), nodes, cot)[0]
             for _ in range(2)]
    assert torch.equal(grads[0], grads[1])


# ---------------------------------------------------------------- attention


def _attn_case(device, ragged, heads, d, dropout):
    """Attention windows of real meshes with dead tiles and empty rows, and
    seeded q/k/v/Wₑ/keep of width heads·d."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    if ragged:
        # n_max not a multiple of NT; 175 nodes in sample 0 (the sentinel
        # edges' slots reach row 180 of a live tile, rows 175..179 have no
        # slot), 73 in sample 1 (a dead tile with visible rows); source
        # windows that run past n_max
        n_max, nt, eb, sw, side, thresh, e_max = 180, 64, 1024, 180, 16, 0.02, 1000
        rng = np.random.default_rng(0)
        r, c = np.arange(side)[:, None], np.arange(side)[None, :]
        frames = []
        for _ in range(3):
            cy, cx = rng.uniform(0, side, 2)
            frames.append(np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (side / 6) ** 2)))
        x = np.stack(frames)[:, None, :, :, None]
    else:
        n_max, nt, eb, sw, side, thresh, e_max = 2048, NT, EB, SW, 64, 0.1, 10240
        x = np.random.default_rng(heads * d).random((3, 1, side, side, 1)) ** 4
    cfg = GraphConfig(image_shape=(side, side), max_grid_size=8, thresh=thresh, n_max=n_max,
                      e_max=e_max, node_budget=n_max)
    g, _ = image_to_graph(add_positional_encoding(torch.from_numpy(x.astype(np.float32))), cfg)
    meta, ovf = attn.attn_tile_meta(g.edge_src.to(device), g.edge_dst.to(device),
                                    g.edge_attr.to(device), n_max, nt, eb, sw,
                                    g.n_nodes.to(device))
    assert int(ovf.max()) == 0 and int(meta.live.min()) < meta.s0.shape[1]  # dead tiles
    gen = torch.Generator(device).manual_seed(heads * d)
    hd = heads * d
    qkv = [torch.randn(3, n_max, hd, device=device, generator=gen) for _ in range(3)]
    we = torch.randn(2, hd, device=device, generator=gen)
    keep = None
    if dropout:
        u = torch.rand(3, meta.s0.shape[1], heads, eb, device=device, generator=gen)
        keep = (u < 0.9).float() / 0.9
    dims = attn.AttnDims(n_max, nt, eb, sw, heads, d)
    return (*qkv, we, keep, meta, dims), gen


ATTN_CASES = [(1, 1, False, False), (1, 16, False, True), (8, 16, False, True),
              (3, 8, True, True), (1, 1, True, False), (24, 16, False, False),
              (8, 32, False, True), (8, 32, True, False)]


@pytest.mark.parametrize("heads,d,ragged,dropout", ATTN_CASES)
def test_attn_kernels_match_plain(card, heads, d, ragged, dropout):
    """K3 against ``attn_plain`` (≤1e-5) and K4 against autograd through it
    (≤1e-5 × max(1, max|grad|)), at HD = 1, 16, 128, 256 (and 24, 384), on
    ragged shapes with dead tiles and rows without a slot."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    args, gen = _attn_case(card, ragged, heads, d, dropout)
    before = dict(attn.LAUNCHES)
    out = attn._attn_fwd_cuda(*args)
    torch.testing.assert_close(out, attn.attn_plain(*args), rtol=0, atol=1e-5)
    g = torch.randn(out.shape, device=card, generator=gen)
    kern = attn._attn_bwd_cuda(*args, g)
    plain = attn.attn_bwd_plain(*args, g)
    for name, a, p in zip(("dq", "dk", "dv", "dwe"), kern, plain):
        err = float((a - p).abs().max())
        assert err <= 1e-5 * max(1.0, float(p.abs().max())), (name, err)
    assert attn.LAUNCHES["attn_apply"] == before["attn_apply"] + 1
    assert attn.LAUNCHES["attn_apply_bwd"] == before["attn_apply_bwd"] + 1


def test_attn_apply_on_the_card_goes_through_the_kernels(card):
    """A CUDA ``attn_apply`` on inputs that need a gradient carries the
    ``AttnApply`` node; its backward launches K4 once and no K3, and K4 run
    twice is bit-identical."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    (q, k, v, we, keep, meta, dims), gen = _attn_case(card, False, 8, 16, True)
    leaves = [x.requires_grad_(True) for x in (q, k, v, we)]
    out = attn.attn_apply(*leaves, keep, meta, dims)
    assert type(out.grad_fn).__name__ == "AttnApplyBackward"
    g = torch.randn(out.shape, device=card, generator=gen)
    before = dict(attn.LAUNCHES)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
    assert attn.LAUNCHES["attn_apply_bwd"] == before["attn_apply_bwd"] + 1
    assert attn.LAUNCHES["attn_apply"] == before["attn_apply"]
    again = torch.autograd.grad(out, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


def test_attn_backward_reads_the_graphs_slot_view(card):
    """A window graph built on the card carries the source-sorted slot
    view; it equals ``slot_view`` of its windows, and K4 through it gives
    the gradients K4 gives when it builds the view itself, bit for bit."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    cfg = GraphConfig(image_shape=(64, 64), max_grid_size=8, thresh=0.1, n_max=2048,
                      e_max=10240, node_budget=2048, aggregation="pallas", attn_windows=True,
                      carry_edges=False, agg_nt=NT, agg_eb=EB, agg_sw=SW)
    x = np.random.default_rng(5).random((3, 1, 64, 64, 1)) ** 4
    graph, _ = image_to_graph(add_positional_encoding(torch.from_numpy(x.astype(np.float32))
                                                      .to(card)), cfg)
    meta, dims = graph.attn_meta, attn.AttnDims(2048, NT, EB, SW, 8, 16)
    want = attn.slot_view(meta, dims)
    assert torch.equal(graph.slot_view.order, want.order)
    assert torch.equal(graph.slot_view.offsets, want.offsets)
    gen = torch.Generator(card).manual_seed(0)
    q, k, v, g = (torch.randn(3, 2048, 128, device=card, generator=gen) for _ in range(4))
    we = torch.randn(2, 128, device=card, generator=gen)
    mine = attn._attn_bwd_cuda(q, k, v, we, None, meta, dims, g, graph.slot_view)
    built = attn._attn_bwd_cuda(q, k, v, we, None, meta, dims, g)
    assert all(torch.equal(a, b) for a, b in zip(mine, built))


def _sprite_frames(card):
    """The decoder frames (16 × 10, 64 × 64) of the Moving-MNIST batch the
    main path trains on, rendered from the committed digit sprites: what a
    teacher-forced decoder remeshes on."""
    from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset

    ds = ModMovingMNISTDataset(16, input_timesteps=4, output_timesteps=10, canvas_size=(64, 64),
                               digit_size=(18, 18), pixel_noise=0.02, velocity_noise=0.0, seed=0)
    return torch.as_tensor(ds.y, device=card)


def test_kernels_on_near_capacity_windows(card):
    """K1-K4 against their plain versions on the meshes of true Moving-MNIST
    frames at thresh 0.1 (the main path's graph config): windows with more
    than half of EB's slots filled in their fullest tile, no overflow. K1
    exact, K2 and K2b ≤1e-5 at F 16 and 32, K3 ≤1e-5 and K4 ≤1e-5 ×
    max(1, max|grad|) at HD 1, 16, 128 and 256 (8 × d 32) with keep
    windows."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    frames = _sprite_frames(card)
    base = dict(image_shape=(64, 64), max_grid_size=8, thresh=0.1, n_max=2048, e_max=10240,
                node_budget=2048, aggregation="pallas", agg_nt=NT, agg_eb=EB, agg_sw=SW)
    gen = torch.Generator(card).manual_seed(0)
    fullest = 0
    for t in (0, 5, 9):
        img = add_positional_encoding(frames[:, t:t + 1])
        cheb, _ = image_to_graph(img, GraphConfig(**base, use_edge_attrs=False))
        wins, _ = image_to_graph(img, GraphConfig(**base, attn_windows=True, carry_edges=False))
        assert int(cheb.overflow.max()) == 0 and int(wins.overflow.max()) == 0
        blocks = cheb.agg_meta
        w, _ = spmm.spmm_tile_meta(cheb.edge_src, cheb.edge_dst, cheb.sym_coeff, 2048, NT, EB, SW)
        bargs = (w.src_rel, w.dst_rel, w.coeff, blocks.live, NT, SW)
        assert torch.equal(spmm._build_blocks_cuda(*bargs), spmm.build_blocks_plain(*bargs))
        for f in (16, 32):
            z = torch.randn(16, 2048, f, device=card, generator=gen)
            args = (z, blocks.s0, blocks.blocks, blocks.live, 2048, NT, SW)
            torch.testing.assert_close(spmm._apply_cuda(*args), spmm.apply_plain(*args),
                                       rtol=0, atol=1e-5)
            torch.testing.assert_close(spmm._apply_bwd_cuda(*args), spmm.apply_plain(*args),
                                       rtol=0, atol=1e-5)
        meta = wins.attn_meta
        fullest = max(fullest, int((meta.dst_rel >= 0).sum(-1).max()))
        for heads, d in ((1, 1), (1, 16), (8, 16), (8, 32)):
            dims = attn.AttnDims(2048, NT, EB, SW, heads, d)
            q, k, v, g = (torch.randn(16, 2048, heads * d, device=card, generator=gen)
                          for _ in range(4))
            we = torch.randn(2, heads * d, device=card, generator=gen)
            u = torch.rand(16, meta.s0.shape[1], heads, EB, device=card, generator=gen)
            args = (q, k, v, we, (u < 0.9).float() / 0.9, meta, dims)
            torch.testing.assert_close(attn._attn_fwd_cuda(*args), attn.attn_plain(*args),
                                       rtol=0, atol=1e-5)
            kern = attn._attn_bwd_cuda(*args, g, wins.slot_view)
            for name, a, p in zip(("dq", "dk", "dv", "dwe"), kern, attn.attn_bwd_plain(*args, g)):
                err = float((a - p).abs().max())
                assert err <= 1e-5 * max(1.0, float(p.abs().max())), (t, heads * d, name, err)
    assert fullest > EB // 2


def _star_case(device, heads, d, a, dropout):
    """Hand-made windows (n_max 300, NT 64, EB 512, SW 300) of two samples
    with 200 and 100 nodes, so tiles past ``live`` are dead (sample 0's
    tile 4 holds visible rows 256..299): node 7 receives 40 edges and node
    70 33 (more than a chunk at every run), node 9 none, the rest a ring;
    padding edges reach row n_max. Seeded q/k/v/Wₑ/attributes (A = a) and
    keep windows of KH = heads."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    n_max, nt, eb, sw, e = 300, 64, 512, 300, 420
    gen = torch.Generator(device).manual_seed(heads * d + a)
    srcs, dsts = [], []
    for n in (200, 100):
        pairs = [(s, 7) for s in range(20, 60)] + [(s, 70) for s in range(100, 133) if s < n]
        pairs += [(i, (i + 1) % n) for i in range(n) if (i + 1) % n not in (7, 9, 70)]
        pairs.sort(key=lambda x: x[1])  # the graph build's edge lists are dst-sorted
        pairs += [(n_max, n_max)] * (e - len(pairs))
        srcs.append([x[0] for x in pairs])
        dsts.append([x[1] for x in pairs])
    edge_src = torch.tensor(srcs, device=device)
    edge_dst = torch.tensor(dsts, device=device)
    edge_attr = torch.randn(2, e, a, device=device, generator=gen)
    meta, ovf = attn.attn_tile_meta(edge_src, edge_dst, edge_attr, n_max, nt, eb, sw,
                                    torch.tensor([200, 100], device=device))
    assert int(ovf.max()) == 0 and meta.live.tolist() == [4, 2]
    hd = heads * d
    qkv = [torch.randn(2, n_max, hd, device=device, generator=gen) for _ in range(3)]
    we = torch.randn(a, hd, device=device, generator=gen)
    keep = None
    if dropout:
        u = torch.rand(2, meta.s0.shape[1], heads, eb, device=device, generator=gen)
        keep = (u < 0.9).float() / 0.9
    return (*qkv, we, keep, meta, attn.AttnDims(n_max, nt, eb, sw, heads, d)), gen


@pytest.mark.parametrize("heads,d", [(1, 1), (1, 16), (8, 16), (8, 32), (3, 8), (3, 12)])
@pytest.mark.parametrize("a,dropout", [(1, False), (4, True)])
def test_attn_kernels_on_long_rows_and_dead_tiles(card, heads, d, a, dropout):
    """K3 (≤1e-5) and K4 (≤1e-5 × max(1, max|grad|)) against their plain
    versions on rows of 33 and 40 slots, an isolated row and dead tiles
    past ``live``, at A = 1 and 4; every row of a dead tile is zero."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    args, gen = _star_case(card, heads, d, a, dropout)
    out = attn._attn_fwd_cuda(*args)
    torch.testing.assert_close(out, attn.attn_plain(*args), rtol=0, atol=1e-5)
    assert not out[0, 256:].any() and not out[1, 128:].any() and not out[0, 9].any()
    g = torch.randn(out.shape, device=card, generator=gen)
    for name, k, p in zip(("dq", "dk", "dv", "dwe"), attn._attn_bwd_cuda(*args, g),
                          attn.attn_bwd_plain(*args, g)):
        err = float((k - p).abs().max())
        assert err <= 1e-5 * max(1.0, float(p.abs().max())), (name, err)


@pytest.mark.parametrize("heads,d,dropout", [(1, 1, True), (1, 16, False), (8, 16, True),
                                             (8, 32, False)])
def test_attn_forward_repeats_bit_for_bit(card, heads, d, dropout):
    """Two K3 calls on the same operands agree bit for bit (no atomics, a
    fixed order of every sum)."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    args, _ = _attn_case(card, False, heads, d, dropout)
    assert torch.equal(attn._attn_fwd_cuda(*args), attn._attn_fwd_cuda(*args))


@pytest.mark.parametrize("heads,d", [(1, 1), (1, 16), (8, 16), (8, 32), (3, 8), (24, 16)])
def test_attn_forward_launches_its_plan(card, heads, d):
    """K3 launches ``fwd_plan``'s geometry, as the C entry reports it back
    through the wrapper: samples × the plan's row groups, at most one CTA
    a group, 32 lanes a warp, ``fwd_smem_bytes``, the plan's run and chunk,
    float4 rows where d allows. Another valid plan gives the same output
    bit for bit (the geometry moves no sum); a plan the kernel does not
    take raises and counts no launch."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    args, _ = _attn_case(card, False, heads, d, True)
    dims, a = args[6], args[5].attr.shape[-1]
    plan = attn.fwd_plan(dims)
    got = {}
    out = attn._attn_fwd_cuda(*args, geometry=got)
    assert 1 <= got.pop("ctas") <= 3 * plan.groups_sample
    assert got == dict(groups=3 * plan.groups_sample, block=32 * plan.warps,
                       smem=attn.fwd_smem_bytes(dims, a), run=plan.run, chunk=plan.chunk,
                       vec=int(plan.run % 4 == 0 and d % plan.run == 0), vec_win=1)
    other = plan._replace(rows_cta=max(1, plan.rows_cta // 2), warps=max(1, plan.warps // 4))
    assert torch.equal(attn._attn_fwd_cuda(*args, plan=other), out)
    before = attn.LAUNCHES["attn_apply"]
    with pytest.raises(RuntimeError):
        attn._attn_fwd_cuda(*args, plan=plan._replace(chunk=plan.chunk + 1))
    assert attn.LAUNCHES["attn_apply"] == before


@pytest.mark.parametrize("heads,d,dropout", [(48, 16, True), (24, 32, False)])
def test_attn_apply_takes_any_width_by_head_groups(card, heads, d, dropout):
    """``attn_apply`` at HD 768 (above the kernels' 512): K3 and K4 launch
    once per group of whole heads (2 here), and the result is the plain
    version's at the full width, ≤1e-5 (gradients ≤1e-5 × max(1,
    max|g|)), with keep rows a head."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    (q, k, v, we, keep, meta, dims), gen = _attn_case(card, False, heads, d, dropout)
    groups = len(attn.head_groups(heads, d, attn.MAX_HD))
    assert groups == 2
    leaves = [x.requires_grad_(True) for x in (q, k, v, we)]
    before = dict(attn.LAUNCHES)
    out = attn.attn_apply(*leaves, keep, meta, dims)
    assert attn.LAUNCHES["attn_apply"] == before["attn_apply"] + groups
    plain_args = [x.detach() for x in leaves] + [keep, meta, dims]
    torch.testing.assert_close(out.detach(), attn.attn_plain(*plain_args), rtol=0, atol=1e-5)
    g = torch.randn(out.shape, device=card, generator=gen)
    grads = torch.autograd.grad(out, leaves, g)
    assert attn.LAUNCHES["attn_apply_bwd"] == before["attn_apply_bwd"] + groups
    for name, a, p in zip(("dq", "dk", "dv", "dwe"), grads, attn.attn_bwd_plain(*plain_args, g)):
        err = float((a - p).abs().max())
        assert err <= 1e-5 * max(1.0, float(p.abs().max())), (name, err)


def test_attn_wrappers_reject_bad_inputs(card):
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    (q, k, v, we, keep, meta, dims), _ = _attn_case(card, True, 1, 16, False)
    with pytest.raises(TypeError):
        attn._attn_fwd_cuda(q.double(), k, v, we, keep, meta, dims)
    with pytest.raises(ValueError):
        attn._attn_fwd_cuda(q.cpu(), k, v, we, keep, meta, dims)
    with pytest.raises(ValueError):  # keep with more rows than heads
        attn._attn_fwd_cuda(q, k, v, we, torch.ones(3, meta.s0.shape[1], 2, dims.eb,
                                                     device=card), meta, dims)


# ---------------------------------------------------------------- grid attention


def _grid_case(device, rows, cols, heads, d, ndirs, dropout, batch=2, dead_rows=0):
    """Seeded operands of the stencil attention on a rows × cols grid whose
    mask holds an isolated valid pixel (all 8 neighbours masked) and random
    holes; ``dead_rows`` masks the top rows whole (K6 tiles with no valid
    pixel)."""
    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    mask = np.random.default_rng(rows * cols).random((rows, cols)) < 0.25
    mask[2:5, 3:6] = True
    mask[3, 4] = False  # isolated
    mask[:dead_rows] = True
    gen = torch.Generator(device).manual_seed(heads * d + ndirs)
    p, h = rows * cols, heads * d
    qkv = [torch.randn(batch, p, h, device=device, generator=gen) for _ in range(3)]
    e_dir = torch.randn(ndirs, h, device=device, generator=gen)
    valid = torch.from_numpy(~mask.reshape(-1)).float().to(device)
    keep = None
    if dropout:
        u = torch.rand(batch, ndirs, p, heads, device=device, generator=gen)
        keep = (u < 0.9).float() / 0.9
    return (*qkv, e_dir, valid, keep, grid_attn.GridAttnDims(rows, cols, heads, d, ndirs)), gen


# (rows, cols, heads, d, D, keep): H 256 (the flagship's gate stack, 8 × 32),
# 32 and 1 (its head convs), D 4 and 8, cols 13 (column wrap, and not a
# multiple of any K6 tile), d = 6, which takes K5's shared-memory head sums
# instead of the shuffles (and K6's ragged 3-head group), and d = 64 > 32
# (one head a K6 group, a 4 × 8 tile)
GRID_CASES = [(224, 304, 8, 32, 4, False), (224, 304, 8, 32, 4, True),
              (224, 304, 1, 32, 4, False), (224, 304, 1, 1, 4, True),
              (11, 13, 8, 32, 8, True), (11, 13, 1, 32, 8, False), (11, 13, 1, 1, 8, True),
              (11, 13, 3, 6, 4, True), (11, 13, 2, 4, 8, False), (11, 13, 2, 64, 4, True)]


@pytest.mark.parametrize("rows,cols,heads,d,ndirs,dropout", GRID_CASES)
def test_grid_attn_kernels_match_plain(card, rows, cols, heads, d, ndirs, dropout):
    """K5 against ``grid_attn_plain`` (bit-identical where d divides 32, else
    ≤1e-5) and K6 against autograd through it (≤1e-5 × max(1, max|grad|));
    the isolated and the masked pixels aggregate exactly 0."""
    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    args, gen = _grid_case(card, rows, cols, heads, d, ndirs, dropout)
    before = dict(grid_attn.LAUNCHES)
    out = grid_attn._grid_attn_fwd_cuda(*args)
    plain = grid_attn.grid_attn_plain(*args)
    if 32 % d == 0:  # K5 sums every head in _head_sum's tree: bit for bit
        assert torch.equal(out, plain), float((out - plain).abs().max())
    else:
        torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    invalid = args[4] == 0
    assert not out[:, invalid].any() and not out[:, 3 * cols + 4].any()
    g = torch.randn(out.shape, device=card, generator=gen)
    kern = grid_attn._grid_attn_bwd_cuda(*args, g)
    plain = grid_attn.grid_attn_bwd_plain(*args, g)
    for name, a, p in zip(("dq", "dk", "dv", "de_dir"), kern, plain):
        err = float((a - p).abs().max())
        assert err <= 1e-5 * max(1.0, float(p.abs().max())), (name, err)
    assert grid_attn.LAUNCHES["grid_attn_apply"] == before["grid_attn_apply"] + 1
    assert grid_attn.LAUNCHES["grid_attn_apply_bwd"] == before["grid_attn_apply_bwd"] + 1


@pytest.mark.parametrize("heads,d,ndirs", [(8, 32, 8), (1, 32, 4), (1, 1, 8), (3, 8, 4)])
def test_grid_attn_backward_with_dead_tiles(card, heads, d, ndirs):
    """K6 on a 40 × 37 grid whose top 20 rows are masked: whole tiles
    without a valid pixel (and 37 columns, no multiple of a tile) give
    zero dq, dk, dv there and a de_dir within 1e-5 of the plain one."""
    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    args, gen = _grid_case(card, 40, 37, heads, d, ndirs, True, dead_rows=20)
    g = torch.randn(args[0].shape, device=card, generator=gen)
    kern = grid_attn._grid_attn_bwd_cuda(*args, g)
    plain = grid_attn.grid_attn_bwd_plain(*args, g)
    for name, a, p in zip(("dq", "dk", "dv", "de_dir"), kern, plain):
        err = float((a - p).abs().max())
        assert err <= 1e-5 * max(1.0, float(p.abs().max())), (name, err)
    for a in kern[:3]:
        assert not a[:, :19 * 37].any()  # rows 0..18 have no valid pixel within one step


@pytest.mark.parametrize("rows,cols", [(21, 45), (16, 64), (9, 33)])
@pytest.mark.parametrize("heads,d,ndirs,dropout", [(8, 32, 4, True), (1, 32, 8, False),
                                                   (1, 1, 4, True), (2, 16, 8, True),
                                                   (3, 6, 4, False)])
def test_grid_attn_forward_on_ragged_and_masked_tiles(card, rows, cols, heads, d, ndirs, dropout):
    """K5's tiles (8 × 8 at d 32, 8 × 32 at d 1; :func:`fwd_plan`) on grids
    whose rows and columns are no multiple of a tile (21 × 45, 9 × 33) and
    whose tiles end on the row's end, where a ±1 column shift must not wrap
    to the next row (16 × 64); the top 8 rows are masked whole, so whole
    tiles hold no valid pixel: bit-identical to ``grid_attn_plain`` where d
    divides 32 (else ≤1e-5), and 0 at every masked pixel."""
    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    args, _ = _grid_case(card, rows, cols, heads, d, ndirs, dropout, dead_rows=8)
    before = grid_attn.LAUNCHES["grid_attn_apply"]
    out = grid_attn._grid_attn_fwd_cuda(*args)
    assert grid_attn.LAUNCHES["grid_attn_apply"] == before + 1
    plain = grid_attn.grid_attn_plain(*args)
    if 32 % d == 0:
        assert torch.equal(out, plain), float((out - plain).abs().max())
    else:
        torch.testing.assert_close(out, plain, rtol=0, atol=1e-5)
    assert not out[:, args[4] == 0].any() and not out[:, :8 * cols].any()
    assert out[:, 8 * cols:].any()


def test_grid_attn_apply_on_the_card_goes_through_the_kernels(card):
    """A CUDA ``grid_attn_apply`` on inputs that need a gradient carries the
    ``GridAttnApply`` node; its backward launches K6 once and no K5, and K6
    run twice is bit-identical."""
    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    (q, k, v, e_dir, valid, keep, dims), gen = _grid_case(card, 224, 304, 8, 32, 4, True, 1)
    leaves = [x.requires_grad_(True) for x in (q, k, v, e_dir)]
    out = grid_attn.grid_attn_apply(*leaves, valid, keep, dims)
    assert type(out.grad_fn).__name__ == "GridAttnApplyBackward"
    g = torch.randn(out.shape, device=card, generator=gen)
    before = dict(grid_attn.LAUNCHES)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
    assert grid_attn.LAUNCHES["grid_attn_apply_bwd"] == before["grid_attn_apply_bwd"] + 1
    assert grid_attn.LAUNCHES["grid_attn_apply"] == before["grid_attn_apply"]
    again = torch.autograd.grad(out, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("dropout", [False, True])
def test_grid_attn_apply_takes_any_width_by_head_groups(card, dropout):
    """``grid_attn_apply`` at H 768 (24 heads × 32, above the kernels'
    256): K5 and K6 launch once per group of whole heads (3), K5's output
    bit-identical to the plain version's at the full width, K6 ≤1e-5 ×
    max(1, max|g|), with and without keep planes."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn, grid_attn

    (q, k, v, e_dir, valid, keep, dims), gen = _grid_case(card, 11, 13, 24, 32, 4, dropout)
    groups = len(attn.head_groups(24, 32, grid_attn.MAX_H))
    assert groups == 3
    leaves = [x.requires_grad_(True) for x in (q, k, v, e_dir)]
    before = dict(grid_attn.LAUNCHES)
    out = grid_attn.grid_attn_apply(*leaves, valid, keep, dims)
    assert grid_attn.LAUNCHES["grid_attn_apply"] == before["grid_attn_apply"] + groups
    plain_args = [x.detach() for x in leaves] + [valid, keep, dims]
    assert torch.equal(out.detach(), grid_attn.grid_attn_plain(*plain_args))
    g = torch.randn(out.shape, device=card, generator=gen)
    grads = torch.autograd.grad(out, leaves, g)
    assert grid_attn.LAUNCHES["grid_attn_apply_bwd"] == before["grid_attn_apply_bwd"] + groups
    for name, a, p in zip(("dq", "dk", "dv", "de_dir"), grads,
                          grid_attn.grid_attn_bwd_plain(*plain_args, g)):
        err = float((a - p).abs().max())
        assert err <= 1e-5 * max(1.0, float(p.abs().max())), (name, err)


def test_grid_attn_wrappers_reject_bad_inputs(card):
    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    (q, k, v, e_dir, valid, keep, dims), _ = _grid_case(card, 11, 13, 1, 8, 4, False)
    with pytest.raises(TypeError):
        grid_attn._grid_attn_fwd_cuda(q.double(), k, v, e_dir, valid, keep, dims)
    with pytest.raises(ValueError):
        grid_attn._grid_attn_fwd_cuda(q.cpu(), k, v, e_dir, valid, keep, dims)
    with pytest.raises(ValueError):  # wider than the kernels take
        wide = grid_attn.GridAttnDims(11, 13, 33, 8, 4)
        z = torch.zeros(2, 143, 264, device=card)
        grid_attn._grid_attn_fwd_cuda(z, z, z, torch.zeros(4, 264, device=card), valid, None,
                                      wide)
    with pytest.raises(ValueError):  # keep planes of the wrong shape
        grid_attn._grid_attn_fwd_cuda(q, k, v, e_dir, valid, torch.ones(2, 4, 143, 2,
                                                                        device=card), dims)


# ---------------------------------------------------------------- segment sum


def _segment_case(device, f, sorted_ids, batch=2, length=6000, n_out=1500, seed=0):
    """Seeded values (B, L, F) and ids (B, L): a tenth of the entries
    sentinels (n_out), one negative id, a band of empty buckets, and
    buckets of 0 to ~20 entries (the pixelwise mesh has 1 to 4)."""
    rng = np.random.default_rng(seed + f)
    ids = rng.integers(0, n_out, (batch, length))
    ids[(ids > 100) & (ids < 140)] -= 40
    ids[:, ::10] = n_out
    if sorted_ids:
        ids = np.sort(ids, axis=1)
    else:
        ids[:, 7] = -1
    values = rng.standard_normal((batch, length, f)).astype(np.float32)
    return torch.from_numpy(values).to(device), torch.from_numpy(ids).to(device), n_out


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("f", [1, 2, 3, 17, 32, 33, 70, 256, 300])
def test_segment_sum_kernel_matches_plain(card, f, sorted_ids):
    """K7 against ``segment_sum_plain`` at ragged F, through the view of
    sorted ids (offsets only) and of unsorted ones: ≤1e-6 × max(1,
    max|out|), and bit for bit where no bucket holds 32 entries (the
    accumulating ``index_put_`` sums in entry order there)."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    values, ids, n_out = _segment_case(card, f, sorted_ids)
    view = segment_sum.segment_view(ids, n_out, sorted_ids=sorted_ids)
    assert (view.order is None) == sorted_ids
    before = segment_sum.LAUNCHES["segment_sum"]
    out = segment_sum._segment_sum_cuda(values, ids, n_out, view)
    torch.cuda.synchronize()
    assert segment_sum.LAUNCHES["segment_sum"] == before + 1
    plain = segment_sum.segment_sum_plain(values, ids, n_out)
    err = float((out - plain).abs().max())
    assert err <= 1e-6 * max(1.0, float(plain.abs().max())), err
    assert not out[:, 101:140].any()
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


def test_segment_sum_kernel_all_sentinels_and_batch(card):
    """Ids that are all dropped give zeros; a batch of 2 is each sample's
    own sum, as one launch."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    values, ids, n_out = _segment_case(card, 33, sorted_ids=False)
    dropped = torch.full_like(ids, n_out)
    out = segment_sum.segment_sum(values, dropped, n_out)
    assert out.shape == (2, n_out, 33) and not out.any()
    both = segment_sum.segment_sum(values, ids, n_out)
    for b in range(2):
        alone = segment_sum.segment_sum(values[b:b + 1], ids[b:b + 1], n_out)
        assert torch.equal(both[b:b + 1], alone)


def test_segment_sum_on_the_card_goes_through_the_kernel(card):
    """A CUDA ``segment_sum`` on values that need a gradient carries the
    ``SegmentSum`` node and launches K7 once; its backward is the row
    gather (0 at a dropped id) and launches nothing; two launches are
    bit-identical."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    values, ids, n_out = _segment_case(card, 256, sorted_ids=False)
    values.requires_grad_(True)
    before = segment_sum.LAUNCHES["segment_sum"]
    out = segment_sum.segment_sum(values, ids, n_out)
    assert type(out.grad_fn).__name__ == "SegmentSumBackward"
    assert segment_sum.LAUNCHES["segment_sum"] == before + 1
    g = torch.randn(out.shape, device=card, generator=torch.Generator(card).manual_seed(0))
    (grad,) = torch.autograd.grad(out, values, g)
    assert segment_sum.LAUNCHES["segment_sum"] == before + 1
    assert torch.equal(grad, segment_sum.gather_rows_plain(g, ids, n_out))
    assert not grad[:, ::10].any()
    assert torch.equal(segment_sum.segment_sum(values, ids, n_out), out)


def test_segment_backend_routes_cuda_tensors_to_the_kernel(card):
    """On a CUDA tensor ``segment_sum_nodes`` and a gather's backward each
    launch K7 once, and a gather with ``routed=False`` (the plain
    references') none; the sums are the plain version's bit for bit."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment, segment_sum

    values, ids, n_out = _segment_case(card, 8, sorted_ids=False)
    nodes = values[:, :n_out].clone().requires_grad_(True)
    plain = segment_sum.segment_sum_plain(values, ids, n_out)
    before = segment_sum.LAUNCHES["segment_sum"]
    s = segment.segment_sum_nodes(values, ids, n_out)
    assert segment_sum.LAUNCHES["segment_sum"] == before + 1
    (g,) = torch.autograd.grad(segment.gather_nodes(nodes, ids, n_out), nodes, values)
    assert segment_sum.LAUNCHES["segment_sum"] == before + 2
    (g_plain,) = torch.autograd.grad(segment.gather_nodes(nodes, ids, n_out, routed=False),
                                     nodes, values)
    assert segment_sum.LAUNCHES["segment_sum"] == before + 2
    assert torch.equal(s, plain) and torch.equal(g, plain) and torch.equal(g_plain, plain)


def test_graphs_built_on_the_card_carry_their_views(card):
    """A pixelwise edge-list graph built on the card carries the CSR views
    of pixel_node, edge_dst (offsets only: it is sorted) and edge_src, and
    they equal the views built from the ids; a quadtree graph that drops
    its edge list drops their views too."""
    from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
    from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum
    from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding

    x = torch.rand((2, 2, 16, 16, 1), device=card, generator=torch.Generator(card).manual_seed(0))
    img = add_positional_encoding(x)
    graph, _ = image_to_graph(img, GraphConfig(image_shape=(16, 16), thresh=float("-inf"),
                                               aggregation="xla"))
    n_max = graph.n_max
    for view, ids, sorted_ids in ((graph.pixel_view, graph.pixel_node, False),
                                  (graph.dst_view, graph.edge_dst, True),
                                  (graph.src_view, graph.edge_src, False)):
        want = segment_sum.segment_view(ids, n_max, sorted_ids=sorted_ids)
        assert (view.order is None) == sorted_ids
        assert torch.equal(view.offsets, want.offsets)
        assert sorted_ids or torch.equal(view.order, want.order)
    windows, _ = image_to_graph(img, GraphConfig(image_shape=(16, 16), thresh=0.1,
                                                 max_grid_size=8, n_max=256, e_max=1280,
                                                 agg_nt=32, agg_eb=128, agg_sw=128,
                                                 aggregation="pallas", carry_edges=False))
    assert windows.pixel_view is not None
    assert windows.dst_view is None and windows.src_view is None


def test_segment_sum_wrapper_rejects_bad_inputs(card):
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    values, ids, n_out = _segment_case(card, 4, sorted_ids=True)
    view = segment_sum.segment_view(ids, n_out, sorted_ids=True)
    with pytest.raises(TypeError):
        segment_sum._segment_sum_cuda(values.double(), ids, n_out, view)
    with pytest.raises(ValueError):
        segment_sum._segment_sum_cuda(values.cpu(), ids, n_out, view)
    with pytest.raises(ValueError):  # a view of another bucket count
        segment_sum._segment_sum_cuda(values, ids, n_out + 1, view)
    with pytest.raises(ValueError):  # ids of another length
        segment_sum._segment_sum_cuda(values, ids[:, 1:], n_out, view)


# ---------------------------------------------------------------- bf16

BF16_TOL = 2.0**-7  # one bf16 rounding, × max(1, max|plain|)


def _bf16_close(kern, plain, what):
    assert kern.dtype == plain.dtype == torch.bfloat16, (what, kern.dtype, plain.dtype)
    err = float((kern.float() - plain.float()).abs().max())
    assert err <= BF16_TOL * max(1.0, float(plain.float().abs().max())), (what, err)


def _misaligned(x):
    """A contiguous copy of x that starts one element into its storage, so
    that no row is 4- or 16-byte aligned: the kernels' scalar paths."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("ragged", [False, True])
def test_build_blocks_bf16_kernel_is_exact(card, ragged):
    """K1 in bf16: each entry the f32 coefficient sum rounded once, bit for
    bit the plain version's, on the main path's windows and on ragged
    ones (NT·SW not a multiple of 8, dead tiles)."""
    if ragged:
        nt, sw, n_max = 64, 71, 200
        w, _ = spmm.spmm_tile_meta(*_edges(card, n_max), n_max, nt, 256, sw)
        live = torch.tensor([1, 2, 4], dtype=torch.int32, device=card)
    else:
        (w, live, _), nt, sw = _windows(card), NT, SW
    args = (w.src_rel, w.dst_rel, w.coeff, live, nt, sw, torch.bfloat16)
    spmm.reset_launch_counts()
    blocks = spmm._build_blocks_cuda(*args)
    assert spmm.LAUNCHES_BF16["spmm_build_blocks"] == 1 and spmm.LAUNCHES["spmm_build_blocks"] == 0
    plain = spmm.build_blocks_plain(*args)
    assert blocks.dtype == torch.bfloat16 and torch.equal(blocks, plain)
    assert torch.equal(plain, spmm.build_blocks_plain(*args[:6]).to(torch.bfloat16))


@pytest.mark.parametrize("f", [1, 16, 17, 20, 32, 33, 128, 129])
def test_apply_bf16_kernel_matches_plain(card, f):
    """K2 and K2b in bf16 (bf16 z and blocks, f32 accumulator, bf16 out)
    against ``apply_plain`` within one bf16 rounding, at the main path's
    widths and ragged ones; with z and out misaligned the kernel takes its
    scalar z loads and gives the same result."""
    w, live, n_max = _windows(card)
    blocks = spmm.build_blocks_plain(w.src_rel, w.dst_rel, w.coeff, live, NT, SW, torch.bfloat16)
    gen = torch.Generator(card).manual_seed(f)
    z = torch.randn(w.s0.shape[0], n_max, f, device=card, generator=gen).to(torch.bfloat16)
    args = (z, w.s0, blocks, live, n_max, NT, SW)
    spmm.reset_launch_counts()
    out = spmm._apply_cuda(*args)
    _bf16_close(out, spmm.apply_plain(*args), f"K2 F={f}")
    _bf16_close(spmm._apply_bwd_cuda(*args), spmm.apply_plain(*args), f"K2b F={f}")
    assert spmm.LAUNCHES_BF16["spmm_apply"] == spmm.LAUNCHES_BF16["spmm_apply_bwd"] == 1
    assert spmm.LAUNCHES["spmm_apply"] == 0
    assert torch.equal(spmm._apply_cuda(_misaligned(z), *args[1:]), out)
    assert torch.equal(spmm._apply_cuda(*args), out)  # a repeat is bit-identical


@pytest.mark.parametrize("f", [5, 17, 128])
def test_apply_bf16_kernel_dead_tiles_and_ragged_shapes(card, f):
    """n_max not a multiple of NT, SW (71) not a multiple of 8 (the block
    rows lose their 16-byte alignment), windows past n_max, dead tiles."""
    nt, sw, n_max = 64, 71, 200
    w, _ = spmm.spmm_tile_meta(*_edges(card, n_max), n_max, nt, 256, sw)
    live = torch.tensor([1, 2, 4], dtype=torch.int32, device=card)
    blocks = spmm._build_blocks_cuda(w.src_rel, w.dst_rel, w.coeff, live, nt, sw, torch.bfloat16)
    z = torch.randn(3, n_max, f, device=card, generator=torch.Generator(card).manual_seed(f))
    args = (z.to(torch.bfloat16), w.s0, blocks, live, n_max, nt, sw)
    _bf16_close(spmm._apply_cuda(*args), spmm.apply_plain(*args), f"K2 F={f}")


def test_apply_bf16_backward_through_autograd(card):
    """A bf16 Â·z on the card carries the K2b node; its gradient is bf16 and
    within one rounding of autograd's transpose through ``apply_plain``."""
    meta, n_max, nt, sw = _k2b_case(card, False)
    meta = meta._replace(blocks=meta.blocks.to(torch.bfloat16))
    gen = torch.Generator(card).manual_seed(0)
    b = meta.s0.shape[0]
    z = torch.randn(b, n_max, 20, device=card, generator=gen).to(torch.bfloat16).requires_grad_()
    g = torch.randn(b, n_max, 20, device=card, generator=gen).to(torch.bfloat16)
    out = spmm.spmm_apply(z, meta, n_max, nt, sw)
    assert type(out.grad_fn).__name__ == "SpmmApplyBackward" and out.dtype == torch.bfloat16
    (dz,) = torch.autograd.grad(out, z, g)
    plain = spmm.apply_plain(z, meta.s0, meta.blocks, meta.live, n_max, nt, sw)
    (dz_t,) = torch.autograd.grad(plain, z, g)
    _bf16_close(dz, dz_t, "K2b through autograd")


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("f", [1, 3, 8, 12, 16, 17, 32, 64, 256, 300])
def test_segment_sum_bf16_kernel_matches_plain(card, f, sorted_ids):
    """K7 on bf16 values (f32 sums in entry order, rounded once) against
    ``segment_sum_plain``: within one bf16 rounding, and bit for bit (the
    plain version sums the f32 values in the same order); F a multiple of 8
    takes 16-byte loads, misaligned values the scalar path, alike."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    values, ids, n_out = _segment_case(card, f, sorted_ids)
    values = values.to(torch.bfloat16)
    view = segment_sum.segment_view(ids, n_out, sorted_ids=sorted_ids)
    segment_sum.reset_launch_counts()
    out = segment_sum._segment_sum_cuda(values, ids, n_out, view)
    assert segment_sum.LAUNCHES_BF16["segment_sum"] == 1 and segment_sum.LAUNCHES["segment_sum"] == 0
    plain = segment_sum.segment_sum_plain(values, ids, n_out)
    _bf16_close(out, plain, f"K7 F={f}")
    assert torch.equal(out, plain)
    assert torch.equal(segment_sum._segment_sum_cuda(_misaligned(values), ids, n_out, view), out)


def test_bf16_wrappers_reject_mixed_or_other_types(card):
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    w, live, n_max = _windows(card)
    blocks = spmm.build_blocks_plain(w.src_rel, w.dst_rel, w.coeff, live, NT, SW)  # f32
    z = torch.zeros(3, n_max, 4, device=card, dtype=torch.bfloat16)
    with pytest.raises(TypeError):  # bf16 z with f32 blocks: no quiet cast
        spmm._apply_cuda(z, w.s0, blocks, live, n_max, NT, SW)
    with pytest.raises(TypeError):
        spmm._apply_cuda(z.half(), w.s0, blocks.half(), live, n_max, NT, SW)
    with pytest.raises(TypeError):
        spmm._build_blocks_cuda(w.src_rel, w.dst_rel, w.coeff, live, NT, SW, torch.float16)
    values, ids, n_out = _segment_case(card, 4, sorted_ids=True)
    with pytest.raises(TypeError):
        segment_sum._segment_sum_cuda(values.half(), ids, n_out,
                                      segment_sum.segment_view(ids, n_out, sorted_ids=True))


def test_bf16_kernels_on_near_capacity_windows(card):
    """K1, K2 and K2b in bf16 on the near-capacity windows of
    ``test_kernels_on_near_capacity_windows`` (true Moving-MNIST frames at
    thresh 0.1), built from bf16 frames as the bf16 model builds them; K7
    on the same meshes' bf16 pooling."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    frames = _sprite_frames(card).to(torch.bfloat16)
    cfg = GraphConfig(image_shape=(64, 64), max_grid_size=8, thresh=0.1, n_max=2048,
                      e_max=10240, node_budget=2048, aggregation="pallas", agg_nt=NT,
                      agg_eb=EB, agg_sw=SW, use_edge_attrs=False)
    gen = torch.Generator(card).manual_seed(0)
    fullest = 0
    for t in (0, 5, 9):
        img = add_positional_encoding(frames[:, t:t + 1])
        graph, data = image_to_graph(img, cfg)
        assert int(graph.overflow.max()) == 0 and data.dtype == torch.bfloat16
        blocks = graph.agg_meta
        assert blocks.blocks.dtype == torch.bfloat16
        w, _ = spmm.spmm_tile_meta(graph.edge_src, graph.edge_dst, graph.sym_coeff, 2048,
                                   NT, EB, SW)
        bargs = (w.src_rel, w.dst_rel, w.coeff, blocks.live, NT, SW, torch.bfloat16)
        assert torch.equal(spmm._build_blocks_cuda(*bargs), spmm.build_blocks_plain(*bargs))
        fullest = max(fullest, int((w.dst_rel >= 0).sum(-1).max()))
        for f in (16, 32, 128):
            z = torch.randn(16, 2048, f, device=card, generator=gen).to(torch.bfloat16)
            args = (z, blocks.s0, blocks.blocks, blocks.live, 2048, NT, SW)
            _bf16_close(spmm._apply_cuda(*args), spmm.apply_plain(*args), (t, "K2", f))
            _bf16_close(spmm._apply_bwd_cuda(*args), spmm.apply_plain(*args), (t, "K2b", f))
        flat = img.reshape(16, 1, 64 * 64, 3).permute(0, 2, 1, 3).reshape(16, 64 * 64, 3)
        pooled = segment_sum._segment_sum_cuda(flat.contiguous(), graph.pixel_node, 2048,
                                               graph.pixel_view)
        assert torch.equal(pooled, segment_sum.segment_sum_plain(flat, graph.pixel_node, 2048))
    assert fullest > EB // 2


def test_bf16_model_on_the_card_goes_through_the_bf16_kernels(card):
    """A bf16 forecast and train step on the card launch the bf16 K1, K2,
    K2b and K7 (no f32 launch but K7's node counts), return float32 frames
    and keep float32 masters and gradients."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    model = NextFramePredictorS2S(
        (32, 32), 0.1, input_timesteps=3, output_timesteps=3, device="cuda", seed=0,
        model_kwargs=dict(hidden_size=8, n_layers=2, n_conv_layers=2,
                          convolution_type="ChebConv", compute_dtype="bfloat16"),
        graph_kwargs=dict(max_grid_size=8, n_max=1024, e_max=8192, node_budget=1024,
                          aggregation="pallas", agg_nt=128, agg_eb=512, agg_sw=512))
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 32, 32, 1)).astype(np.float32)
    y = rng.random((2, 3, 32, 32, 1)).astype(np.float32)
    spmm.reset_launch_counts()
    segment_sum.reset_launch_counts()
    y_hat, overflow, _ = model.forecast(x)
    assert y_hat.dtype == torch.float32 and torch.isfinite(y_hat).all() and int(overflow.max()) == 0
    assert spmm.LAUNCHES_BF16["spmm_build_blocks"] == 4 and spmm.LAUNCHES_BF16["spmm_apply"] > 0
    assert segment_sum.LAUNCHES_BF16["segment_sum"] > 0
    assert spmm.LAUNCHES["spmm_apply"] == spmm.LAUNCHES["spmm_build_blocks"] == 0
    assert segment_sum.LAUNCHES["segment_sum"] == 4  # the node counts of 4 meshes
    model.initiate_training(lr=0.01, lr_decay=0.95)
    loss, _ = model.train_step(x, y)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert spmm.LAUNCHES_BF16["spmm_apply_bwd"] > 0
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in model.model.parameters())


# ---------------------------------------------------------------- bf16 attention


def _bf16_args(args):
    """The float operands of an attention case in bf16 (the windows, the
    attributes and keep stay f32)."""
    return tuple(x.to(torch.bfloat16) if torch.is_tensor(x) and x.dtype == torch.float32
                 and x.dim() >= 1 and i < 4 else x for i, x in enumerate(args))


@pytest.mark.parametrize("heads,d,ragged,dropout", ATTN_CASES)
def test_attn_bf16_kernels_match_plain(card, heads, d, ragged, dropout):
    """K3 and K4 in bf16 (bf16 q, k, v, Wₑ and cotangent; f32 arithmetic;
    each output rounded once) against ``attn_plain`` and autograd through
    it, within one bf16 rounding × max(1, max|plain|), at HD 1, 16, 128 and
    256 (and 24, 384) on ragged windows with dead tiles and rows without a
    slot. Misaligned q, k, v and out take K3's scalar loads and give the
    same output bit for bit; a repeat is bit-identical; the launches count
    as bf16."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    args, gen = _attn_case(card, ragged, heads, d, dropout)
    args = _bf16_args(args)
    attn.reset_launch_counts()
    out = attn._attn_fwd_cuda(*args)
    _bf16_close(out, attn.attn_plain(*args), f"K3 {heads}x{d}")
    assert torch.equal(attn._attn_fwd_cuda(*args), out)
    mis = tuple(_misaligned(x) for x in args[:3]) + args[3:]
    got = {}
    assert torch.equal(attn._attn_fwd_cuda(*mis, geometry=got), out) and got["vec"] == 0
    g = torch.randn(out.shape, device=card, generator=gen).to(torch.bfloat16)
    kern = attn._attn_bwd_cuda(*args, g)
    for name, a, p in zip(("dq", "dk", "dv", "dwe"), kern, attn.attn_bwd_plain(*args, g)):
        _bf16_close(a, p, f"K4 {name} {heads}x{d}")
    assert attn.LAUNCHES_BF16 == {"attn_apply": 3, "attn_apply_bwd": 1}
    assert attn.LAUNCHES == {"attn_apply": 0, "attn_apply_bwd": 0}


@pytest.mark.parametrize("heads,d", [(1, 1), (1, 16), (8, 16), (8, 32), (3, 8), (3, 12)])
@pytest.mark.parametrize("a,dropout", [(1, False), (4, True)])
def test_attn_bf16_kernels_on_long_rows_and_dead_tiles(card, heads, d, a, dropout):
    """K3 and K4 in bf16 on rows of 33 and 40 slots, an isolated row and
    dead tiles past ``live``, at A = 1 and 4: within one bf16 rounding of
    their plain versions, and every row of a dead tile exactly zero."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    args, gen = _star_case(card, heads, d, a, dropout)
    args = _bf16_args(args)
    out = attn._attn_fwd_cuda(*args)
    _bf16_close(out, attn.attn_plain(*args), f"K3 {heads}x{d} A={a}")
    assert not out[0, 256:].any() and not out[1, 128:].any() and not out[0, 9].any()
    g = torch.randn(out.shape, device=card, generator=gen).to(torch.bfloat16)
    for name, k, p in zip(("dq", "dk", "dv", "dwe"), attn._attn_bwd_cuda(*args, g),
                          attn.attn_bwd_plain(*args, g)):
        _bf16_close(k, p, f"K4 {name} {heads}x{d} A={a}")


def test_attn_bf16_apply_through_autograd(card):
    """A bf16 ``attn_apply`` on the card carries the ``AttnApply`` node, and
    its gradients are bf16 and bit-identical on a repeat."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    (q, k, v, we, keep, meta, dims), gen = _attn_case(card, False, 8, 16, True)
    leaves = [x.to(torch.bfloat16).requires_grad_(True) for x in (q, k, v, we)]
    out = attn.attn_apply(*leaves, keep, meta, dims)
    assert type(out.grad_fn).__name__ == "AttnApplyBackward" and out.dtype == torch.bfloat16
    g = torch.randn(out.shape, device=card, generator=gen).to(torch.bfloat16)
    grads = torch.autograd.grad(out, leaves, g, retain_graph=True)
    assert all(x.dtype == torch.bfloat16 for x in grads)
    again = torch.autograd.grad(out, leaves, g)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("rows,cols,heads,d,ndirs,dropout", GRID_CASES)
def test_grid_attn_bf16_kernels_match_plain(card, rows, cols, heads, d, ndirs, dropout):
    """K5 and K6 in bf16 (bf16 q, k, v, e_dir, valid and cotangent; f32
    arithmetic in the f32 kernels' order; each output rounded once): K5
    bit-identical to ``grid_attn_plain`` where d divides 32 (else within one
    bf16 rounding × max(1, max|plain|)), K6 within one rounding of autograd
    through it; the isolated and masked pixels aggregate 0. Misaligned q,
    k, v and out take the scalar staging and give the same output bit for
    bit; a repeat is bit-identical; the launches count as bf16."""
    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    args, gen = _grid_case(card, rows, cols, heads, d, ndirs, dropout)
    args = tuple(x.to(torch.bfloat16) if i < 5 else x for i, x in enumerate(args))
    grid_attn.reset_launch_counts()
    out = grid_attn._grid_attn_fwd_cuda(*args)
    plain = grid_attn.grid_attn_plain(*args)
    if 32 % d == 0:
        assert torch.equal(out, plain), float((out.float() - plain.float()).abs().max())
    _bf16_close(out, plain, f"K5 {heads}x{d}")
    invalid = args[4] == 0
    assert not out[:, invalid].any() and not out[:, 3 * cols + 4].any()
    assert torch.equal(grid_attn._grid_attn_fwd_cuda(*args), out)
    mis = tuple(_misaligned(x) for x in args[:3]) + args[3:]
    assert torch.equal(grid_attn._grid_attn_fwd_cuda(*mis), out)
    g = torch.randn(out.shape, device=card, generator=gen).to(torch.bfloat16)
    kern = grid_attn._grid_attn_bwd_cuda(*args, g)
    for name, a, p in zip(("dq", "dk", "dv", "de_dir"), kern,
                          grid_attn.grid_attn_bwd_plain(*args, g)):
        _bf16_close(a, p, f"K6 {name} {heads}x{d}")
    assert all(torch.equal(a, b) for a, b in zip(grid_attn._grid_attn_bwd_cuda(*mis, g), kern))
    assert grid_attn.LAUNCHES_BF16 == {"grid_attn_apply": 3, "grid_attn_apply_bwd": 2}
    assert grid_attn.LAUNCHES == {"grid_attn_apply": 0, "grid_attn_apply_bwd": 0}


@pytest.mark.parametrize("rows,cols", [(21, 45), (9, 33)])
@pytest.mark.parametrize("heads,d,ndirs,dropout", [(8, 32, 4, True), (1, 32, 8, False),
                                                   (1, 1, 4, True), (3, 6, 4, False)])
def test_grid_attn_bf16_on_ragged_and_masked_tiles(card, rows, cols, heads, d, ndirs, dropout):
    """K5 and K6 in bf16 on grids that are no multiple of a tile, whose top
    8 rows are masked whole (tiles without a valid pixel): K5 bit-identical
    to its plain version where d divides 32 and 0 at every masked pixel, K6
    within one bf16 rounding."""
    from quadtree_mpnnlstm_tpu_torch.ops import grid_attn

    args, gen = _grid_case(card, rows, cols, heads, d, ndirs, dropout, dead_rows=8)
    args = tuple(x.to(torch.bfloat16) if i < 5 else x for i, x in enumerate(args))
    out = grid_attn._grid_attn_fwd_cuda(*args)
    plain = grid_attn.grid_attn_plain(*args)
    if 32 % d == 0:
        assert torch.equal(out, plain)
    _bf16_close(out, plain, f"K5 {rows}x{cols} {heads}x{d}")
    assert not out[:, args[4] == 0].any() and not out[:, :8 * cols].any()
    g = torch.randn(out.shape, device=card, generator=gen).to(torch.bfloat16)
    for name, a, p in zip(("dq", "dk", "dv", "de_dir"), grid_attn._grid_attn_bwd_cuda(*args, g),
                          grid_attn.grid_attn_bwd_plain(*args, g)):
        _bf16_close(a, p, f"K6 {name} {rows}x{cols} {heads}x{d}")


def test_bf16_attention_wrappers_reject_mixed_types(card):
    """bf16 q with f32 Wₑ (or e_dir, or valid) raises: no quiet cast; f16
    raises too."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn, grid_attn

    (q, k, v, we, keep, meta, dims), _ = _attn_case(card, True, 1, 16, False)
    bq, bk, bv = (x.to(torch.bfloat16) for x in (q, k, v))
    with pytest.raises(TypeError):
        attn._attn_fwd_cuda(bq, bk, bv, we, keep, meta, dims)
    with pytest.raises(TypeError):
        attn._attn_fwd_cuda(q.half(), k.half(), v.half(), we.half(), keep, meta, dims)
    with pytest.raises(TypeError):  # an f32 cotangent of bf16 operands
        attn._attn_bwd_cuda(bq, bk, bv, we.to(torch.bfloat16), keep, meta, dims, q)
    (q, k, v, e_dir, valid, keep, dims), _ = _grid_case(card, 11, 13, 1, 8, 4, False)
    bq, bk, bv, be = (x.to(torch.bfloat16) for x in (q, k, v, e_dir))
    with pytest.raises(TypeError):
        grid_attn._grid_attn_fwd_cuda(bq, bk, bv, be, valid, keep, dims)
    with pytest.raises(TypeError):
        grid_attn._grid_attn_fwd_cuda(bq, bk, bv, e_dir, valid.to(torch.bfloat16), keep, dims)


@pytest.mark.parametrize("mesh", ["windows", "grid"])
def test_bf16_attention_model_on_the_card_goes_through_the_bf16_kernels(card, mesh):
    """A bf16 TransformerConv forecast and train step on the card, on
    attention windows (K3/K4) or on the pixelwise grid with climatology
    (K5/K6), launch only the bf16 attention kernels, return float32
    frames and keep float32 masters and gradients."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn, grid_attn
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    model = dict(hidden_size=8, n_layers=2, n_conv_layers=2, convolution_type="TransformerConv",
                 compute_dtype="bfloat16")
    if mesh == "windows":
        graph, thresh, clim, ops = dict(max_grid_size=8, n_max=1024, e_max=8192,
                                        node_budget=1024, aggregation="pallas", agg_nt=128,
                                        agg_eb=1024, agg_sw=1024), 0.1, False, attn
    else:
        graph, thresh, clim, ops = dict(aggregation="grid"), float("-inf"), True, grid_attn
    tp = NextFramePredictorS2S((32, 32), thresh, input_timesteps=3, output_timesteps=3,
                               device="cuda", seed=0, use_climatology=clim,
                               model_kwargs=model, graph_kwargs=graph)
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 32, 32, 1)).astype(np.float32)
    y = rng.random((2, 3, 32, 32, 1)).astype(np.float32)
    climatology = rng.random((2, 3, 32, 32, 1)).astype(np.float32) if clim else None
    ops.reset_launch_counts()
    y_hat, overflow, _ = tp.forecast(x, climatology=climatology)
    assert y_hat.dtype == torch.float32 and torch.isfinite(y_hat).all() and int(overflow.max()) == 0
    fwd, bwd = list(ops.LAUNCHES_BF16)
    assert ops.LAUNCHES_BF16[fwd] > 0 and set(ops.LAUNCHES.values()) == {0}
    tp.initiate_training(lr=0.01, lr_decay=0.95)
    loss, _ = tp.train_step(x, y, climatology=climatology)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert ops.LAUNCHES_BF16[bwd] > 0 and set(ops.LAUNCHES.values()) == {0}
    assert all(p.dtype == p.grad.dtype == torch.float32 for p in tp.model.parameters())


# ---------------------------------------------------------------- K7 on the main path's shapes


def _pooling_ids(kind, seed=0):
    """Ids (B, L = 4096) over n_out 2048 rows as the main path's pixel view
    meets them: compact node ids (a mesh's valid rows first), each row 1-64
    pixels, most rows empty, the pixels in no order (the view is unsorted).
    ``pooling``: 16 samples of 64 to 1500 nodes; ``fine``: 16 samples of
    1400 nodes, mostly single pixels and 42 leaves of 64 among them, as a
    detailed frame's mesh; ``long``: one bucket of 1500 entries, longer
    than any batch the kernel stages; ``empty``: a sample whose ids are all
    dropped beside a pooling sample."""
    rng = np.random.default_rng(seed)
    length, n_out = 4096, 2048
    batch = 16 if kind in ("pooling", "fine") else 2
    ids = np.full((batch, length), n_out)
    for b in range(batch):
        nodes = [64, 1500, 300, 16][b % 4] if kind == "pooling" else 200
        sizes = rng.integers(1, 65, nodes)
        if kind == "fine":
            nodes, sizes = 1400, np.ones(1400, np.int64)
            sizes[rng.choice(nodes, 42, replace=False)] = 64
        cells = np.repeat(np.arange(nodes), sizes)[:length]
        ids[b, :len(cells)] = cells
        ids[b] = rng.permutation(ids[b])
    if kind == "long":
        ids[0, rng.permutation(length)[:1500]] = 5
    elif kind == "empty":
        ids[1] = n_out
    return torch.from_numpy(ids), n_out


@pytest.mark.parametrize("kind", ["pooling", "fine", "long", "empty"])
@pytest.mark.parametrize("f", [1, 4, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_on_the_main_paths_shapes(card, dtype, f, kind):
    """K7 on the pixel view's shapes (``_pooling_ids``) is bit for bit the
    entry-ordered sum: ``segment_sum_plain`` on the CPU with torch on one
    thread (on the card, the accumulating ``index_put_`` reduces a bucket
    of 32 or more entries at F 1 by warps, out of entry order), rounded
    once in bf16. A repeat and misaligned values (the scalar loads) give
    the same bits; empty rows are zeros."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    ids, n_out = _pooling_ids(kind)
    rng = np.random.default_rng(f)
    values = torch.from_numpy(rng.standard_normal((*ids.shape, f)).astype(np.float32)).to(dtype)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = segment_sum.segment_sum_plain(values, ids, n_out)
    finally:
        torch.set_num_threads(threads)
    ids_c, values_c = ids.to(card), values.to(card)
    view = segment_sum.segment_view(ids_c, n_out)
    segment_sum.reset_launch_counts()
    out = segment_sum._segment_sum_cuda(values_c, ids_c, n_out, view)
    torch.cuda.synchronize()
    counts = segment_sum.LAUNCHES_BF16 if dtype == torch.bfloat16 else segment_sum.LAUNCHES
    assert counts["segment_sum"] == 1
    assert out.dtype == dtype and torch.equal(out.cpu(), want)
    assert torch.equal(segment_sum._segment_sum_cuda(values_c, ids_c, n_out, view), out)
    assert torch.equal(segment_sum._segment_sum_cuda(_misaligned(values_c), ids_c, n_out, view),
                       out)
    empty = (view.offsets[:, 1:] == view.offsets[:, :-1]).cpu()
    assert not out.cpu()[empty].any()
    if kind == "empty":
        assert not out[1].any()


def test_segment_sum_kernel_launches_its_plan(card):
    """The wrapper launches ``segment_plan``'s layout: on a pixel view, the
    spans layout at F ≤ 16 and the lanes layout above, each bit for bit the
    CPU's entry-ordered sum on the same ids; a plan the kernel does not
    take (spans at F 17, a span whose pairs exceed the threads' registers,
    16-byte loads of 8 f32 values, lanes of 3 lanes) is refused."""
    import ctypes

    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum
    from quadtree_mpnnlstm_tpu_torch.ops.cuda_build import load_library

    ids, n_out = _pooling_ids("empty")
    ids_c = ids.to(card)
    view = segment_sum.segment_view(ids_c, n_out)
    threads = torch.get_num_threads()
    for f, route in ((16, "spans"), (17, "lanes")):
        assert segment_sum.segment_plan(f, 4, n_out, False).route == route
        values = torch.randn((*ids.shape, f), generator=torch.Generator().manual_seed(f))
        torch.set_num_threads(1)
        try:
            want = segment_sum.segment_sum_plain(values, ids, n_out)
        finally:
            torch.set_num_threads(threads)
        got = segment_sum._segment_sum_cuda(values.to(card), ids_c, n_out, view)
        assert torch.equal(got.cpu(), want)
    lib = load_library("segment.cu")
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for f, plan in ((17, (1, 1, 128, 0)), (17, (0, 1, 0, 3)), (16, (1, 4, 512, 0)),
                    (16, (1, 8, 256, 0))):
        values = torch.zeros((*ids.shape, f), device=card)
        out = torch.empty((2, n_out, f), device=card)
        err = lib.qtm_segment_sum(ptr(values), ptr(view.order), ptr(view.offsets), ptr(out),
                                  2, ids.shape[1], n_out, f, *plan, stream)
        assert err != 0, (f, plan)


# ---------------------------------------------------------------- bench.py's defaults


def _ice_quadtree_case(device, seed=0):
    """The ice-quadtree workload's windows (224×304, thresh 0.15 on
    ``dist_from_05`` of a smooth field with values near 0, near 1 and in
    between, node budget 16384, NT 128, EB = SW = 1024) and seeded q, k, v,
    Wₑ and keep planes at 8 heads × d 32 (HD 256: the fused gate stack's 8
    streams of hidden 32)."""
    from quadtree_mpnnlstm_tpu_torch.graph.quadtree import dist_from_05
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    shape, budget, heads, d = (224, 304), 16384, 8, 32
    rng = np.random.default_rng(seed)
    coarse = rng.choice([0.0, 0.05, 0.3, 0.5, 0.95, 1.0], size=(1, 1, 28, 38, 1))
    x = np.clip(np.kron(coarse, np.ones((1, 1, 8, 8, 1))) + 0.03 * rng.standard_normal(
        (1, 1, *shape, 1)), 0.0, 1.0).astype(np.float32)
    cfg = GraphConfig(image_shape=shape, max_grid_size=8, thresh=0.15, n_max=budget,
                      e_max=8 * budget, node_budget=budget, aggregation="pallas",
                      attn_windows=True, agg_nt=NT, agg_eb=EB, agg_sw=SW)
    g, _ = image_to_graph(add_positional_encoding(torch.from_numpy(x).to(device)), cfg,
                          transform_func=dist_from_05)
    assert int(g.overflow.max()) == 0 and int(g.n_nodes.max()) > 4 * NT
    gen = torch.Generator(device).manual_seed(seed)
    hd = heads * d
    qkv = [torch.randn(1, budget, hd, device=device, generator=gen) for _ in range(3)]
    we = torch.randn(2, hd, device=device, generator=gen)
    meta = g.attn_meta
    keep = (torch.rand(1, meta.s0.shape[1], heads, EB, device=device, generator=gen)
            < 0.9).float() / 0.9
    dims = attn.AttnDims(budget, NT, EB, SW, heads, d)
    return (*qkv, we, keep, meta, dims), g.slot_view, gen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attn_kernels_at_hd256_on_ice_quadtree_windows(card, dtype):
    """K3 and K4 at HD 256 on the ice-quadtree workload's own windows,
    against their plain versions: f32 K3 ≤1e-5 and K4 ≤1e-5 × max(1,
    max|grad|), bf16 within one bf16 rounding; K4 through the graph's slot
    view, as the train step runs it."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    args, view, gen = _ice_quadtree_case(card)
    if dtype == "bfloat16":
        args = _bf16_args(args)
    out = attn._attn_fwd_cuda(*args)
    g = torch.randn(out.shape, device=card, generator=gen).to(out.dtype)
    kern = attn._attn_bwd_cuda(*args, g, view)
    plain = attn.attn_bwd_plain(*args, g)
    if dtype == "bfloat16":
        _bf16_close(out, attn.attn_plain(*args), "K3 HD 256")
        for name, a, p in zip(("dq", "dk", "dv", "dwe"), kern, plain):
            _bf16_close(a, p, f"K4 {name} HD 256")
        return
    torch.testing.assert_close(out, attn.attn_plain(*args), rtol=0, atol=1e-5)
    for name, a, p in zip(("dq", "dk", "dv", "dwe"), kern, plain):
        err = float((a - p).abs().max())
        assert err <= 1e-5 * max(1.0, float(p.abs().max())), (name, err)


@pytest.mark.parametrize("conv,dtype", [("ChebConv", "float32"),
                                        ("TransformerConv", "bfloat16")])
def test_remat_full_step_is_bit_identical_on_the_card(card, conv, dtype, tmp_path):
    """One train step with per-step remat full and one without, from the
    same weights, inputs and generator (dropout 0.1, teacher forcing 0.5),
    on the kernels: the same loss, gradients and generator state bit for
    bit, and the replay launches the forward's K2 (or K3) again."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn
    from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

    rng = np.random.default_rng(1)
    x = (rng.random((2, 3, 32, 32, 1)) ** 4).astype(np.float32)
    y = (rng.random((2, 3, 32, 32, 1)) ** 4).astype(np.float32)
    out = {}
    for remat in ("none", "full"):
        tp = NextFramePredictorS2S(
            (32, 32), 0.1, input_timesteps=3, output_timesteps=3, device="cuda", seed=2,
            teacher_forcing_ratio=0.5, run_dir=str(tmp_path),
            model_kwargs=dict(hidden_size=16, n_layers=2, n_conv_layers=2,
                              convolution_type=conv, compute_dtype=dtype, remat=remat),
            graph_kwargs=dict(max_grid_size=8, n_max=1024, e_max=5120, node_budget=1024,
                              aggregation="pallas", agg_eb=1024, agg_sw=1024))
        tp.initiate_training(lr=0.0, lr_decay=0.95)
        gen = torch.Generator(card).manual_seed(3)
        spmm.reset_launch_counts()
        attn.reset_launch_counts()
        loss, _ = tp.train_step(x, y, generator=gen)
        fwd = (spmm.LAUNCHES["spmm_apply"] + spmm.LAUNCHES_BF16["spmm_apply"]
               + attn.LAUNCHES["attn_apply"] + attn.LAUNCHES_BF16["attn_apply"])
        out[remat] = (loss, {n: p.grad for n, p in tp.model.named_parameters()},
                      gen.get_state(), fwd)
    (loss_n, g_n, s_n, fwd_n), (loss_f, g_f, s_f, fwd_f) = out["none"], out["full"]
    assert torch.equal(loss_n, loss_f) and torch.equal(s_n, s_f)
    assert all(torch.equal(g_f[n], g) for n, g in g_n.items())
    assert fwd_f == 2 * fwd_n > 0


def _preset_sets(device, kind):
    """The id sets K7 sums over on a preset mesh of the sea-ice
    experiments 9 (``heterogeneous``) and 10 (``homogeneous``), at 96×128
    with a masked coast and ``max_grid_size=4``, ridden by a batch of 2 as
    views (``expand_graph``): the sorted edge_dst, edge_src and the pixel
    map, each with the CSR view the preset carries, rebased for the
    batch. Most slots are sentinels, as on the flagship's presets."""
    from quadtree_mpnnlstm_tpu_torch.graph import static

    shape = (96, 128)
    rng = np.random.default_rng(0)
    mask = rng.random(shape) < 0.05
    mask[:30, :50] = True
    mask[60:, 90:] = True
    cfg = GraphConfig(image_shape=shape, max_grid_size=4, resolution=1 / 12)
    mask_t = torch.from_numpy(mask).to(device)
    if kind == "heterogeneous":
        preset = static.create_static_heterogeneous_graph(cfg, mask=mask_t, device=device)
    else:
        preset = static.create_static_homogeneous_graph(cfg, mask_t, device=device)
    graph = static.expand_graph(preset, 2)
    assert int(preset.n_edges[0]) < 0.5 * cfg.e_max
    return cfg.n_max, {"dst": (graph.edge_dst, graph.dst_view, True),
                       "src": (graph.edge_src, graph.src_view, False),
                       "pixel": (graph.pixel_node, graph.pixel_view, False)}


@pytest.mark.parametrize("kind", ["heterogeneous", "homogeneous"])
@pytest.mark.parametrize("ids_name", ["dst", "src", "pixel"])
@pytest.mark.parametrize("f", [1, 32, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_sum_kernel_on_the_preset_lists(card, dtype, f, ids_name, kind):
    """K7 on a preset mesh's mostly-sentinel sets, through the views the
    preset carries rebased for a batch of 2: the rebased view is the view
    of the batch's ids, and K7 is bit for bit the entry-ordered sum
    (``segment_sum_plain`` on the CPU, torch on one thread; bf16 rounded
    once)."""
    from quadtree_mpnnlstm_tpu_torch.ops import segment_sum

    n_max, sets = _preset_sets(card, kind)
    ids, view, sorted_ids = sets[ids_name]
    want_view = segment_sum.segment_view(ids.contiguous(), n_max, sorted_ids=sorted_ids)
    assert torch.equal(view.offsets, want_view.offsets)
    assert (view.order is None) == sorted_ids
    if not sorted_ids:
        assert torch.equal(view.order, want_view.order)
    rng = np.random.default_rng(f)
    values = torch.from_numpy(rng.standard_normal((*ids.shape, f)).astype(np.float32)).to(dtype)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = segment_sum.segment_sum_plain(values, ids.cpu(), n_max)
    finally:
        torch.set_num_threads(threads)
    segment_sum.reset_launch_counts()
    out = segment_sum._segment_sum_cuda(values.to(card), ids, n_max, view)
    counts = segment_sum.LAUNCHES_BF16 if dtype == torch.bfloat16 else segment_sum.LAUNCHES
    assert counts["segment_sum"] == 1
    assert out.dtype == dtype and torch.equal(out.cpu(), want)


# ---------------------------------------------------------------- shared meshes


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,f", [(5, 1), (5, 16), (5, 128), (16, 1), (16, 16), (16, 128),
                                     (32, 16), (32, 33), (32, 128)])
def test_apply_kernel_on_a_shared_mesh(card, batch, f, dtype):
    """K2 (and K2b) on one mesh's blocks (batch 1) for a batch of 5, 16 or
    32, folded widths B·F up to 4096: equal to its plain version (f32
    ≤1e-5, bf16 within one rounding), bit for bit to the kernel on the
    blocks copied for every sample and to the row-a-warp kernel, and two
    launches bit for bit."""
    w, live, n_max = _windows(card)
    blocks = spmm.build_blocks_plain(w.src_rel, w.dst_rel, w.coeff, live, NT, SW, dtype)
    one = (w.s0[:1], blocks[:1], live[:1])
    copied = tuple(t[:1].expand((batch,) + t.shape[1:]).contiguous()
                   for t in (w.s0, blocks, live))
    z = torch.randn(batch, n_max, f, device=card, generator=torch.Generator(card).manual_seed(f))
    z = z.to(dtype)
    shared = spmm._apply_cuda(z, *one, n_max, NT, SW)
    assert torch.equal(shared, spmm._apply_cuda(z, *one, n_max, NT, SW))
    assert torch.equal(shared, spmm._apply_cuda(z, *copied, n_max, NT, SW))
    assert torch.equal(shared, spmm._apply_rowwarp_cuda(z, *one, n_max, NT, SW))
    assert torch.equal(spmm._apply_bwd_cuda(z, *one, n_max, NT, SW), shared)
    plain = spmm.apply_plain(z, *one, n_max, NT, SW)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7 * max(1.0, float(plain.float().abs().max()))
    assert float((shared.float() - plain.float()).abs().max()) <= tol
    with pytest.raises(ValueError, match="metadata of batch"):
        spmm._apply_cuda(z, w.s0[:2], blocks[:2], live[:2], n_max, NT, SW)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("meta_batch", [3, 1])
def test_apply_kernel_rows_past_the_list_pool(card, dtype, meta_batch):
    """Rows with more non-zeros than their share of a CTA's list pool
    holds (SW 2048, some rows dense) beside sparse ones, on meshes a sample
    and on a shared mesh: K2 equal to ``apply_plain`` (f32 ≤1e-5, bf16 within one
    rounding), bit for bit to the row-a-warp kernel, and two launches bit
    for bit; rows of the windows past n_max read as zero."""
    nt, sw, t, n_max, f = 64, 2048, 3, 150, 24
    rng = np.random.default_rng(7)
    dense = (rng.standard_normal((meta_batch, t, nt, sw)) / 64).astype(np.float32)
    keep = rng.random((meta_batch, t, nt, sw)) < 0.01
    keep[:, :, [3, 5, 40], :] = True  # dense rows: 2048 non-zeros each
    blocks = torch.from_numpy(np.where(keep, dense, 0.0)).to(card, dtype)
    s0 = torch.tensor([[0, 16, 32]] * meta_batch, dtype=torch.int32, device=card)
    live = torch.full((meta_batch,), 2, dtype=torch.int32, device=card)
    z = torch.randn(3, n_max, f, device=card, generator=torch.Generator(card).manual_seed(1))
    args = (z.to(dtype), s0, blocks, live, n_max, nt, sw)
    out = spmm._apply_cuda(*args)
    assert torch.equal(out, spmm._apply_cuda(*args))
    assert torch.equal(out, spmm._apply_rowwarp_cuda(*args))
    plain = spmm.apply_plain(*args)
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7 * max(1.0, float(plain.float().abs().max()))
    assert float((out.float() - plain.float()).abs().max()) <= tol
    assert not out[:, 2 * nt:].any()


@pytest.mark.parametrize("heads,d,ragged,dropout", [(8, 16, False, True), (1, 1, True, False),
                                                    (8, 32, False, False)])
def test_attn_kernels_on_a_shared_mesh(card, heads, d, ragged, dropout):
    """K3 and K4 on one mesh's windows (batch 1) for the batch of 3: within
    their tolerances of the plain versions, and bit for bit the kernels on
    the windows copied for every sample (K4 also through the batch-1 slot
    view)."""
    from quadtree_mpnnlstm_tpu_torch.ops import attn

    args, gen = _attn_case(card, ragged, heads, d, dropout)
    q, k, v, we, keep, meta, dims = args
    one = attn.AttnMeta(*(t[:1] for t in meta))
    copied = attn.AttnMeta(*(t[:1].expand((3,) + t.shape[1:]).contiguous() for t in meta))
    out = attn._attn_fwd_cuda(q, k, v, we, keep, one, dims)
    assert torch.equal(out, attn._attn_fwd_cuda(q, k, v, we, keep, copied, dims))
    torch.testing.assert_close(out, attn.attn_plain(q, k, v, we, keep, one, dims), rtol=0,
                               atol=1e-5)
    g = torch.randn(out.shape, device=card, generator=gen)
    kern = attn._attn_bwd_cuda(q, k, v, we, keep, one, dims, g, attn.slot_view(one, dims))
    for a, b in zip(kern, attn._attn_bwd_cuda(q, k, v, we, keep, copied, dims, g)):
        assert torch.equal(a, b)
    for name, a, p in zip(("dq", "dk", "dv", "dwe"), kern,
                          attn.attn_bwd_plain(q, k, v, we, keep, one, dims, g)):
        err = float((a - p).abs().max())
        assert err <= 1e-5 * max(1.0, float(p.abs().max())), (name, err)


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_data_parallel_step_on_the_card(card, tmp_path, backend, world):
    """``NextFramePredictorS2S(dp_devices=N)`` on the card
    (``tests/test_torch_parallel.py``'s scenarios with attention dropout on
    the windows and without dropout): two gloo ranks sharing the card
    within that file's tolerances of the one-process step on the card (the
    gradients also at the port's gradient tolerance, ≤1e-4 × max(1,
    max|g|)), and one NCCL rank bit for bit."""
    import torch_dp_workers as w
    from quadtree_mpnnlstm_tpu_torch.parallel import dp

    names = ["full_bptt", "dropout_windows"]
    got = dp.launch(w.card_worker, world, backend=backend,
                    device="cuda:0" if backend == "gloo" else None,
                    args=(names, str(tmp_path)), timeout=600)
    for name in names:
        pred = w.make_predictor(name, str(tmp_path / "one"), 1, "cuda:0")
        pred.initiate_training(lr=0.01, lr_decay=0.95)
        grads, losses = [], []
        for x, y in w.batches():
            loss, _ = pred.train_step(x, y, **w.SCENARIOS[name][3])
            losses.append(float(loss))
            grads.append(w.flat_grads(pred).cpu().numpy())
        params = w.flat_params(pred).cpu().numpy()
        g = got[name]
        assert g["replicas_equal"]
        if world == 1:
            assert g["losses"] == losses
            assert np.array_equal(g["params"], params)
            continue
        np.testing.assert_allclose(g["losses"], losses, rtol=1e-5)
        for a, b in zip(g["grads"], grads):  # the port's gradient tolerance
            assert np.abs(a - b).max() <= 1e-4 * max(1.0, np.abs(b).max())
        w.hold_to_one_process(g, grads, params, [p.numel() for p in pred.model.parameters()])
