"""PyTorch port vs JAX package: the sort-free "csum" adjacency
(``GraphConfig.adjacency="csum"``, ``graph/adjacency.py``
``build_adjacency_canonical``).

The port's csum edge list equals the JAX package's element for element
(self-loops first, then each ``_SHIFTS_4`` group, each edge at its
prefix-sum rank: K7 sums in entry order and K1/K3 pack their windows in
list order), on the JAX package's own cases (``tests/test_adjacency_csum.py``:
masks, ragged shapes with clipped cells, a node budget, meshes split only
by the mask or all the way down), in a batch of two samples whose meshes
differ; ``edge_attr`` within 2⁻²³ (each framework's ``atan2`` rounds its
own way). Against the port's own sort list it holds the same edge set,
dst-grouped, with one self-loop per multi-pixel cell, and the same
overflow. With 8-neighbour edges and on the pixelwise mesh it is the sort
list (the JAX package's fallback). On Â blocks the csum mesh gives the
sort mesh's blocks up to the degree sums' order, and on attention windows
the JAX package's csum windows bit for bit; a TransformerConv forecast on
a csum edge list matches the JAX package's within 1e-4 on meshes asserted
identical.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.ops.pallas_attn import attn_tile_meta as j_attn_tile_meta
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

ATTR_TOL = 2.0**-23

CASES = [
    # (shape, mask?, thresh, budget), the JAX package's csum cases
    ((32, 32), False, 0.1, None),
    ((32, 32), True, 0.1, None),
    ((24, 40), True, 0.1, None),
    ((19, 27), True, 0.05, None),     # ragged: right/bottom clipped cells
    ((32, 32), True, 0.1, 96),        # node_budget coarsening
    ((32, 32), True, float("inf"), None),   # splits only at the mask
    ((16, 16), False, -1.0, None),    # everything splits to singletons
]


def _mask(shape):
    m = np.zeros(shape, bool)
    m[: shape[0] // 5] = True
    m[-3:, -7:] = True
    return m


def _frames(shape, seed):
    """Two samples of two frames each, (B, T, rows, cols, 1)."""
    rng = np.random.default_rng(seed)
    return rng.random((2, 2, *shape, 1), np.float32)


def _port_graph(frames, mask, **cfg):
    g, _ = image_to_graph(add_positional_encoding(torch.from_numpy(frames)), GraphConfig(**cfg),
                          mask=None if mask is None else torch.from_numpy(mask))
    return g


def _jax_graph(frames, mask, **cfg):
    g, _ = j_image_to_graph(j_posenc(jnp.asarray(frames)), JGraphConfig(**cfg),
                            mask=None if mask is None else jnp.asarray(mask))
    return g


def _pairs(src, dst, valid):
    pairs = set(zip(src[valid].tolist(), dst[valid].tolist()))
    assert len(pairs) == int(valid.sum()), "duplicate edges emitted"
    return pairs


@pytest.mark.parametrize("shape,use_mask,thresh,budget", CASES)
def test_csum_list_matches_jax_element_for_element(shape, use_mask, thresh, budget):
    frames = _frames(shape, sum(shape) + int(use_mask))
    mask = _mask(shape) if use_mask else None
    cfg = dict(image_shape=shape, max_grid_size=8, thresh=thresh, n_max=512, e_max=4096,
               node_budget=budget, adjacency="csum")
    got = _port_graph(frames, mask, **cfg)
    for b in range(2):
        want = _jax_graph(frames[b], mask, **cfg)
        for name in ("pixel_node", "edge_src", "edge_dst", "edge_valid", "n_edges", "overflow"):
            np.testing.assert_array_equal(getattr(got, name)[b].numpy(),
                                          np.asarray(getattr(want, name)), err_msg=name)
        np.testing.assert_allclose(got.edge_attr[b].numpy(), np.asarray(want.edge_attr),
                                   rtol=0, atol=ATTR_TOL)

    # the same edge set as the sort list, dst-grouped, live slots first
    sort = _port_graph(frames, mask, **dict(cfg, adjacency="sort"))
    for b in range(2):
        src, dst, valid = (x[b].numpy() for x in (got.edge_src, got.edge_dst, got.edge_valid))
        assert _pairs(src, dst, valid) == _pairs(
            *(x[b].numpy() for x in (sort.edge_src, sort.edge_dst, sort.edge_valid)))
        n_e = int(got.n_edges[b])
        assert valid[:n_e].all() and not valid[n_e:].any()
        assert (np.diff(dst[:n_e]) >= 0).all()
    assert torch.equal(got.overflow, sort.overflow) and torch.equal(got.n_edges, sort.n_edges)


def test_csum_self_loops_and_overflow():
    """One self-loop per multi-pixel cell, none for a singleton, emitted
    first in its destination's run; edges past e_max are counted as the
    sort list counts them, and the kept prefix is the JAX package's."""
    shape = (16, 16)
    frames = _frames(shape, 3)
    cfg = dict(image_shape=shape, max_grid_size=8, thresh=0.3, n_max=256, e_max=4096,
               adjacency="csum")
    g = _port_graph(frames, None, **cfg)
    for b in range(2):
        src, dst, valid = (x[b].numpy() for x in (g.edge_src, g.edge_dst, g.edge_valid))
        counts = g.counts[b].numpy()
        loops = src[valid & (src == dst)]
        assert sorted(loops.tolist()) == [n for n in range(int(g.n_nodes[b])) if counts[n] > 1]
        first = np.flatnonzero(valid & np.r_[True, dst[1:] != dst[:-1]])
        runs_with_loop = [i for i in first if counts[dst[i]] > 1]
        assert all(src[i] == dst[i] for i in runs_with_loop)
    small = dict(cfg, e_max=64)
    got = _port_graph(frames, None, **small)
    sort = _port_graph(frames, None, **dict(small, adjacency="sort"))
    assert (got.overflow > 0).all() and torch.equal(got.overflow, sort.overflow)
    for b in range(2):
        want = _jax_graph(frames[b], None, **small)
        assert int(got.overflow[b]) == int(want.overflow)
        np.testing.assert_array_equal(got.edge_src[b].numpy(), np.asarray(want.edge_src))
        np.testing.assert_array_equal(got.edge_dst[b].numpy(), np.asarray(want.edge_dst))


@pytest.mark.parametrize("kw", [dict(edges_at_corners=True, thresh=0.1),
                                dict(thresh=float("-inf"))], ids=["corners", "pixelwise"])
def test_csum_falls_back_to_sort(kw):
    shape = (16, 24)
    frames = _frames(shape, 5)
    cfg = dict(image_shape=shape, max_grid_size=8, **kw)
    got = _port_graph(frames, _mask(shape), **dict(cfg, adjacency="csum"))
    sort = _port_graph(frames, _mask(shape), **cfg)
    for name in ("edge_src", "edge_dst", "edge_valid", "edge_attr", "overflow"):
        assert torch.equal(getattr(got, name), getattr(sort, name)), name


def test_csum_blocks_and_windows():
    """Â blocks from the csum list are the sort list's (one dense Â; the
    windows' slot order differs) up to the rounding of the degree sums,
    which add the same edge weights in the csum list's order (2⁻²² × the
    largest entry), and attention windows are the JAX package's csum
    windows bit for bit."""
    shape = (32, 32)
    frames = _frames(shape, 7)
    cfg = dict(image_shape=shape, max_grid_size=8, thresh=0.1, n_max=1024, e_max=8192,
               aggregation="pallas", agg_nt=64, agg_eb=512, agg_sw=256, adjacency="csum")
    csum = _port_graph(frames, None, **cfg)
    sort = _port_graph(frames, None, **dict(cfg, adjacency="sort"))
    assert not torch.equal(csum.edge_src, sort.edge_src)  # another order
    for name in ("s0", "live"):
        assert torch.equal(getattr(csum.agg_meta, name), getattr(sort.agg_meta, name)), name
    blocks, ref = csum.agg_meta.blocks, sort.agg_meta.blocks
    assert torch.equal(blocks != 0, ref != 0)
    assert float((blocks - ref).abs().max()) <= 2.0**-22 * float(ref.abs().max())
    win = _port_graph(frames, None, **dict(cfg, attn_windows=True, use_edge_attrs=True))
    for b in range(2):
        jg = _jax_graph(frames[b], None, **dict(cfg, use_edge_attrs=True))
        jmeta, _ = j_attn_tile_meta(jg.edge_src, jg.edge_dst, jg.edge_attr, 1024, 64, 512, 256,
                                    n_nodes=jg.n_nodes)
        meta = win.attn_meta
        np.testing.assert_array_equal(meta.s0[b].numpy(), np.asarray(jmeta.s0)[:, 0])
        for name in ("src_rel", "dst_rel"):
            np.testing.assert_array_equal(getattr(meta, name)[b].numpy(),
                                          np.asarray(getattr(jmeta, name)), err_msg=name)
        assert int(meta.live[b]) == int(np.asarray(jmeta.live)[0, 0])
        np.testing.assert_allclose(meta.attr[b].numpy(),
                                   np.transpose(np.asarray(jmeta.attr_t), (0, 2, 1)),
                                   rtol=0, atol=ATTR_TOL)
        assert int(win.overflow[b]) == int(jg.overflow) == 0


def test_transformer_forecast_on_csum_list_matches_jax():
    """TransformerConv on a csum edge list through ``predict`` (its edge
    softmax and K7's sums in the csum list's order): every decoder step on
    the JAX package's mesh, frames within 1e-4."""
    shape, t_in, t_out = (16, 16), 2, 3
    graph = dict(max_grid_size=4, n_max=256, e_max=2048, aggregation="xla", adjacency="csum")
    model = dict(hidden_size=8, n_layers=1, n_conv_layers=1, dropout=0.0,
                 convolution_type="TransformerConv", remat=False)
    jp = JPredictor(shape, 0.2, input_timesteps=t_in, output_timesteps=t_out,
                    model_kwargs=dict(model), graph_kwargs=dict(graph))
    jp._ensure_params()
    x = np.random.default_rng(9).random((2, t_in, *shape, 1)).astype(np.float32)
    jy = np.asarray(jax.jit(jax.vmap(lambda xb: jp.eval_model.apply(jp.params, xb)))(
        jnp.asarray(x)))
    tp = NextFramePredictorS2S(shape, 0.2, input_timesteps=t_in, output_timesteps=t_out,
                               device="cpu", model_kwargs=dict(model), graph_kwargs=dict(graph))
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    assert tp.gcfg.adjacency == "csum"
    y, overflow, meshes = tp.forecast(x)
    assert int(overflow.max()) == 0
    for b in range(2):
        want = _jax_graph(x[b], None, image_shape=shape, **dict(graph, thresh=0.2))
        np.testing.assert_array_equal(meshes[0, b].numpy(), np.asarray(want.pixel_node))
        for t in range(1, t_out):
            want = _jax_graph(jy[b, t - 1][None], None, image_shape=shape,
                              **dict(graph, thresh=0.2))
            np.testing.assert_array_equal(meshes[t, b].numpy(), np.asarray(want.pixel_node))
    np.testing.assert_allclose(y.numpy(), jy, atol=1e-4)
