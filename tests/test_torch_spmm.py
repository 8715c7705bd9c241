"""PyTorch port vs JAX package: SpMM window metadata (bit-identical),
Â-block densification (exact), the block product and its backward
(≤1e-5), with dead tiles; the Pallas kernels run in interpret mode on the
CPU. The CUDA
kernels are held against these plain versions on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.ops import pallas_spmm as jspmm
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.ops import spmm as tspmm

NT, EB, SW = 128, 512, 512


def _jax_graphs(n_max, thresh, batch=2, shape=(32, 32), seed=0):
    """Edge lists of ``batch`` JAX meshes, stacked as numpy."""
    cfg = JGraphConfig(image_shape=shape, max_grid_size=8, thresh=thresh,
                       n_max=n_max, e_max=8 * n_max, use_edge_attrs=False)
    rng = np.random.default_rng(seed)
    r = np.arange(shape[0])[:, None]
    c = np.arange(shape[1])[None, :]

    def frame():  # a blob plus faint noise: refined near the blob only
        cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
        blob = np.exp(-((r - cy) ** 2 + (c - cx) ** 2) / (2 * (shape[0] / 5) ** 2))
        img = blob + 0.04 * rng.random(shape)
        return jnp.asarray(img[None, :, :, None].astype(np.float32))

    graphs = [j_image_to_graph(j_posenc(frame()), cfg)[0] for _ in range(batch)]
    stack = lambda name: np.stack([np.asarray(getattr(g, name)) for g in graphs])
    return graphs, stack("edge_src"), stack("edge_dst"), stack("sym_coeff"), stack("n_nodes")


@pytest.mark.parametrize("n_max,thresh", [(256, 0.3), (512, 0.1), (1024, 0.05), (200, 0.3)])
def test_tile_meta_bit_identical(n_max, thresh):
    graphs, src, dst, coeff, _ = _jax_graphs(n_max, thresh)
    tw, tovf = tspmm.spmm_tile_meta(
        torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
        torch.from_numpy(coeff), n_max, NT, EB, SW,
    )
    for b, g in enumerate(graphs):
        jw, jovf = jspmm.spmm_tile_meta(g.edge_src, g.edge_dst, g.sym_coeff,
                                        n_max, NT, EB, SW)
        np.testing.assert_array_equal(tw.s0[b].numpy(), np.asarray(jw.s0)[:, 0])
        np.testing.assert_array_equal(tw.src_rel[b].numpy(), np.asarray(jw.src_rel))
        np.testing.assert_array_equal(tw.dst_rel[b].numpy(), np.asarray(jw.dst_rel))
        np.testing.assert_array_equal(tw.coeff[b].numpy(), np.asarray(jw.coeff))
        assert int(tovf[b]) == int(jovf)
        assert tw.s0.dtype == tw.src_rel.dtype == torch.int32


@pytest.mark.parametrize("nt,eb,sw", [(32, 64, 48), (64, 128, 64)])
def test_tile_meta_bit_identical_with_window_overflow(nt, eb, sw):
    graphs, src, dst, coeff, _ = _jax_graphs(512, 0.05, seed=3)
    tw, tovf = tspmm.spmm_tile_meta(
        torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
        torch.from_numpy(coeff), 512, nt, eb, sw,
    )
    for b, g in enumerate(graphs):
        jw, jovf = jspmm.spmm_tile_meta(g.edge_src, g.edge_dst, g.sym_coeff, 512, nt, eb, sw)
        np.testing.assert_array_equal(tw.src_rel[b].numpy(), np.asarray(jw.src_rel))
        np.testing.assert_array_equal(tw.s0[b].numpy(), np.asarray(jw.s0)[:, 0])
        assert int(tovf[b]) == int(jovf) > 0


def _windows(n_max, thresh, seed=0):
    graphs, src, dst, coeff, n_nodes = _jax_graphs(n_max, thresh, seed=seed)
    tw, ovf = tspmm.spmm_tile_meta(
        torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
        torch.from_numpy(coeff), n_max, NT, EB, SW,
    )
    return graphs, tw, torch.from_numpy(n_nodes), ovf


@pytest.mark.parametrize("n_max,thresh", [(512, 0.1), (1024, 0.3), (1024, 0.05)])
def test_build_blocks_plain_exact(n_max, thresh):
    graphs, tw, n_nodes, ovf = _windows(n_max, thresh)
    meta = tspmm.spmm_build_blocks(tw, NT, SW, n_nodes)
    for b, g in enumerate(graphs):
        jw, _ = jspmm.spmm_tile_meta(g.edge_src, g.edge_dst, g.sym_coeff, n_max, NT, EB, SW)
        jm = jspmm.spmm_build_blocks(jw, NT, EB, SW, n_nodes=g.n_nodes)
        np.testing.assert_array_equal(meta.blocks[b].numpy(), np.asarray(jm.blocks))
        assert int(meta.live[b]) == int(np.asarray(jm.live)[0, 0])


@pytest.mark.parametrize("n_max,thresh,f", [(1024, 0.3, 20), (1024, 0.3, 17),
                                            (1024, 0.1, 128), (768, 0.3, 1)])
def test_apply_plain_matches_jax(n_max, thresh, f):
    graphs, tw, n_nodes, ovf = _windows(n_max, thresh, seed=f)
    meta = tspmm.spmm_build_blocks(tw, NT, SW, n_nodes)
    # dead tiles: these meshes use fewer than n_max/NT tiles
    assert (meta.live < n_max // NT).all() and (n_nodes <= n_max).all()
    rng = np.random.default_rng(f)
    z = rng.standard_normal((len(graphs), n_max, f)).astype(np.float32)
    out = tspmm.spmm_apply(torch.from_numpy(z), meta, n_max, NT, SW)
    for b, g in enumerate(graphs):
        jw, _ = jspmm.spmm_tile_meta(g.edge_src, g.edge_dst, g.sym_coeff, n_max, NT, EB, SW)
        jm = jspmm.spmm_build_blocks(jw, NT, EB, SW, n_nodes=g.n_nodes)
        ref = jspmm.spmm_apply(jnp.asarray(z[b]), jm, n_max, NT, SW)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), atol=1e-5)
        if int(ovf[b]):  # window misses drop edges in both kernels alike
            continue
        oracle = jspmm.spmm_reference(jnp.asarray(z[b]), g.sym_coeff, g.edge_src,
                                      g.edge_dst, n_max)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(oracle), atol=1e-5)


def test_window_rows_past_n_max_read_zero():
    """A source window that runs past n_max must read zeros there, not
    clamped rows: s0 is clipped to a 16-aligned bound above n_max − SW."""
    n_max, nt, sw = 200, 64, 72
    graphs, src, dst, coeff, n_nodes = _jax_graphs(n_max, 0.3, seed=2)
    tw, _ = tspmm.spmm_tile_meta(torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
                                 torch.from_numpy(coeff), n_max, nt, 256, sw)
    assert (tw.s0.long() + sw > n_max).any()
    meta = tspmm.spmm_build_blocks(tw, nt, sw, torch.from_numpy(n_nodes))
    z = np.random.default_rng(0).standard_normal((2, n_max, 3)).astype(np.float32)
    out = tspmm.spmm_apply(torch.from_numpy(z), meta, n_max, nt, sw)
    for b, g in enumerate(graphs):
        jw, _ = jspmm.spmm_tile_meta(g.edge_src, g.edge_dst, g.sym_coeff, n_max, nt, 256, sw)
        jm = jspmm.spmm_build_blocks(jw, nt, 256, sw, n_nodes=g.n_nodes)
        ref = jspmm.spmm_apply(jnp.asarray(z[b]), jm, n_max, nt, sw)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref), atol=1e-5)


def test_cpu_tensors_never_launch_kernels():
    _, tw, n_nodes, _ = _windows(256, 0.3)
    tspmm.reset_launch_counts()
    meta = tspmm.spmm_build_blocks(tw, NT, SW, n_nodes)
    tspmm.spmm_apply(torch.zeros(2, 256, 4), meta, 256, NT, SW)
    assert tspmm.LAUNCHES == {"spmm_build_blocks": 0, "spmm_apply": 0, "spmm_apply_bwd": 0}


@pytest.mark.parametrize("n_max,thresh,f", [(1024, 0.3, 20), (1024, 0.1, 16), (768, 0.3, 3)])
def test_apply_backward_matches_jax_and_the_true_transpose(n_max, thresh, f):
    """K2b on the CPU: the gradient of <Â z, g> through ``spmm_apply`` (its
    backward runs ``apply_plain`` on g) equals ``jax.grad`` through the JAX
    package's ``spmm_apply`` (the same kernel on the cotangent) and the
    transpose that autograd takes through ``apply_plain`` itself, which
    holds while Â is symmetric: no window dropped an edge."""
    eb = sw = 1024  # the main path's windows, wide enough to drop nothing
    graphs, src, dst, coeff, n_nodes = _jax_graphs(n_max, thresh, seed=f + 1)
    tw, ovf = tspmm.spmm_tile_meta(torch.from_numpy(src).long(), torch.from_numpy(dst).long(),
                                   torch.from_numpy(coeff), n_max, NT, eb, sw)
    assert int(ovf.max()) == 0
    meta = tspmm.spmm_build_blocks(tw, NT, sw, torch.from_numpy(n_nodes))
    rng = np.random.default_rng(f)
    z = rng.standard_normal((len(graphs), n_max, f)).astype(np.float32)
    g = rng.standard_normal((len(graphs), n_max, f)).astype(np.float32)

    zt = torch.from_numpy(z).requires_grad_(True)
    out = tspmm.spmm_apply(zt, meta, n_max, NT, sw)
    assert type(out.grad_fn).__name__ == "SpmmApplyBackward"
    (dz,) = torch.autograd.grad(out, zt, torch.from_numpy(g))

    zt2 = torch.from_numpy(z).requires_grad_(True)
    plain = tspmm.apply_plain(zt2, meta.s0, meta.blocks, meta.live, n_max, NT, sw)
    (dz_t,) = torch.autograd.grad(plain, zt2, torch.from_numpy(g))
    np.testing.assert_allclose(dz.numpy(), dz_t.numpy(), atol=1e-5)

    for b, gr in enumerate(graphs):
        jw, _ = jspmm.spmm_tile_meta(gr.edge_src, gr.edge_dst, gr.sym_coeff, n_max, NT, eb, sw)
        jm = jspmm.spmm_build_blocks(jw, NT, eb, sw, n_nodes=gr.n_nodes)
        gb = jnp.asarray(g[b])
        ref = jax.grad(lambda zz: jnp.sum(jspmm.spmm_apply(zz, jm, n_max, NT, sw) * gb))(
            jnp.asarray(z[b]))
        np.testing.assert_allclose(dz[b].numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("nt,sw,f", [(128, 1024, 16), (128, 1024, 17), (128, 1024, 128),
                                     (128, 1024, 129), (64, 72, 5), (64, 200, 33),
                                     (128, 512, 300), (60, 1000, 1)])
def test_apply_plan_covers_rows_columns_and_features(nt, sw, f):
    """K2's plan: the row slabs hold every row of a tile once; the column
    chunks a warp reads cover [0, SW) once, in ascending order, so that
    every output is one sum in ascending column order; the feature chunks
    cover [0, F) once, each within a warp's 32 · fpl lanes' features, and
    F ≤ 256 takes one pass over the row."""
    plan = tspmm.apply_plan(nt, sw, f)
    rows = np.concatenate([np.arange(i * plan.rows_per_cta, (i + 1) * plan.rows_per_cta)
                           for i in range(plan.slabs)])
    assert np.array_equal(rows[rows < nt], np.arange(nt)) and (rows >= nt).sum() < plan.rows_per_cta
    cols = np.concatenate([np.arange(c0, c1) for c0, c1 in plan.col_chunks])
    assert np.array_equal(cols, np.arange(sw))
    assert all(c1 - c0 <= 4 * 32 for c0, c1 in plan.col_chunks)
    feats = np.concatenate([np.arange(f0, f1) for f0, f1 in plan.f_chunks])
    assert np.array_equal(feats, np.arange(f))
    assert all(f1 - f0 <= 32 * plan.fpl for f0, f1 in plan.f_chunks)
    assert plan.fpl in (1, 2, 4, 8)
    assert (len(plan.f_chunks) == 1) == (f <= 256)
