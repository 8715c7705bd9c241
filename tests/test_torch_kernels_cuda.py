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
