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
