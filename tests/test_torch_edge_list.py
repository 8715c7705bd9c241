"""PyTorch port vs JAX package: the pixelwise edge-list backend
(``thresh=-inf`` with ``aggregation="xla"``).

* ``pixelwise_graph`` on a masked 24×32 image: node ids, counts, the edge
  list and its validity bit for bit (4 and 8 directions), the bearing
  within 2⁻²³ (torch's and XLA's ``atan2`` differ in the last bits on a
  few angles);
* the edge-list branch of ``multi_stream_attention`` at (heads, d) in
  {(8, 4), (1, 4), (1, 1)}, forward ≤1e-5 and gradients ≤1e-4 relative to
  the largest, with dropout 0 (the JAX function) and with a keep injected
  from numpy (the JAX branch's own primitives with that keep);
* the dropout keep-scales, keyed by the edges' (src, dst) node ids: the
  same after the slots are permuted, reproducible from the generator;
* TransformerConv on an ``xla`` quadtree mesh: a ``predict`` rollout at
  16×16 against the JAX predictor, on meshes asserted identical first.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import NEG_INF
from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.data.loader import ArrayDataset as JArrayDataset
from quadtree_mpnnlstm_tpu.data.loader import DataLoader as JDataLoader
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.ops import segment as jseg
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding as t_posenc
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (24, 32)
B = 2
FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _mask():
    mask = np.random.default_rng(0).random(SHAPE) < 0.2
    mask[:3, :5] = True
    return mask


def _graphs(corners=False):
    x = np.random.default_rng(1).random((B, 2, *SHAPE, 3)).astype(np.float32)
    mask = _mask()
    kw = dict(image_shape=SHAPE, thresh=NEG_INF, aggregation="xla", edges_at_corners=corners)
    tg, data = image_to_graph(t_posenc(torch.from_numpy(x)), GraphConfig(**kw),
                              mask=torch.from_numpy(mask))
    jouts = [j_image_to_graph(j_posenc(jnp.asarray(x[b])), JGraphConfig(**kw),
                              mask=jnp.asarray(mask)) for b in range(B)]
    return tg, data, jouts


@pytest.fixture(scope="module")
def meshes():
    tg, _, jouts = _graphs()
    return tg, [jg for jg, _ in jouts]


@pytest.mark.parametrize("corners", [False, True])
def test_pixelwise_graph_matches_jax(corners):
    tg, data, jouts = _graphs(corners)
    n_valid = int((~_mask()).sum())
    assert tg.n_max == SHAPE[0] * SHAPE[1] and not tg.mapping_identity
    assert int(tg.n_nodes[0]) == n_valid and int(tg.overflow.max()) == 0
    for b, (jg, jdata) in enumerate(jouts):
        for name in ("pixel_node", "counts", "n_nodes", "node_valid", "edge_src", "edge_dst",
                     "edge_valid", "n_edges", "node_xy"):
            np.testing.assert_array_equal(getattr(tg, name)[b].numpy(),
                                          np.asarray(getattr(jg, name)), err_msg=name)
        mine, ref = tg.edge_attr[b].numpy(), np.asarray(jg.edge_attr)
        np.testing.assert_array_equal(mine[..., 1], ref[..., 1])
        np.testing.assert_allclose(mine[..., 0], ref[..., 0], rtol=0, atol=2.0**-23)
        np.testing.assert_allclose(tg.sym_coeff[b].numpy(), np.asarray(jg.sym_coeff),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(data[b].numpy(), np.asarray(jdata))
    # within a destination the slots keep the shift order, not the src order
    dst, src = tg.edge_dst[0].numpy(), tg.edge_src[0].numpy()
    same = (dst[1:] == dst[:-1]) & (dst[1:] < tg.n_max)
    assert (src[1:][same] < src[:-1][same]).any()


def _feats(seed, width, n, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((B, n, width))).astype(np.float32)


def _jax_attention(q, k, v, we, jg, heads, d, keep):
    """The JAX package's edge-list branch (``models/conv.py``): the
    function itself without dropout, else its own primitives with the
    keep-scales (E, heads) injected where it draws them."""
    if keep is None:
        return jconv.multi_stream_attention(q, k, v, we, jg, heads, d)[0]
    n = jg.n_max
    e = (jg.edge_attr @ we).reshape(-1, heads, d)
    kj = jseg.gather_src(k.reshape(n, heads, d), jg) + e
    vj = jseg.gather_src(v.reshape(n, heads, d), jg) + e
    logits = jnp.sum(jseg.gather_dst(q.reshape(n, heads, d), jg) * kj, axis=-1) / jnp.sqrt(
        jnp.asarray(d, q.dtype))
    alpha = jseg.edge_softmax_graph(logits, jg)
    return jseg.aggregate_to_dst((alpha * keep)[..., None] * vj, jg)


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("heads,d", [(8, 4), (1, 4), (1, 1)])
def test_edge_list_attention_matches_jax(meshes, heads, d, with_keep):
    tg, jgs = meshes
    n, hd = tg.n_max, heads * d
    q, k, v = (_feats(s, hd, n) for s in (1, 2, 3))
    we = _feats(4, hd, 2)[0]
    cot = _feats(5, hd, n)
    keep = None
    if with_keep:
        e_max = tg.edge_src.shape[1]
        u = np.random.default_rng(6).random((B, e_max, heads))
        keep = ((u < 0.9) / 0.9).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, we)]
    out = tconv.edge_attention(*leaves, tg, heads, d,
                               None if keep is None else torch.from_numpy(keep))
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(cot).reshape(B, n, heads, d))
    out = out.detach().numpy().reshape(B, n, hd)
    jwe = 0.0  # dWₑ sums over the batch
    for b, jg in enumerate(jgs):
        kb = None if keep is None else jnp.asarray(keep[b])

        def loss(q_, k_, v_, we_, b=b, jg=jg, kb=kb):
            o = _jax_attention(q_, k_, v_, we_, jg, heads, d, kb)
            return jnp.sum(o.reshape(n, hd) * cot[b]), o

        (_, ref), jgrads = jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True)(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]), jnp.asarray(we))
        np.testing.assert_allclose(out[b], np.asarray(ref).reshape(n, hd), rtol=0, atol=FWD_TOL)
        for name, mine, r in zip("qkv", grads[:3], jgrads[:3]):
            r = np.asarray(r)
            err = float(np.abs(mine[b].numpy() - r).max())
            assert err <= GRAD_TOL * max(1.0, float(np.abs(r).max())), (name, err)
        jwe = jwe + np.asarray(jgrads[3])
    err = float(np.abs(grads[3].numpy() - jwe).max())
    assert err <= GRAD_TOL * max(1.0, float(np.abs(jwe).max())), err


def test_dropout_without_a_keep_is_the_attention_of_eval_mode(meshes):
    """Eval mode draws no keep: ``multi_stream_attention`` is
    ``edge_attention`` without keep-scales (up to the order in which the
    CPU's threads add the segment sums)."""
    tg, _ = meshes
    q = torch.from_numpy(_feats(7, 8, tg.n_max))
    a = tconv.multi_stream_attention(q, q, q, None, tg, 2, 4, dropout=0.1, training=False)
    b = tconv.edge_attention(q, q, q, q.new_zeros((2, 8)), tg, 2, 4)
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_dropout_keys_by_node_ids(meshes):
    """The keep-scales of a call are keyed by (sample, src, dst, head):
    permuting the edge slots permutes them with the edges, the same
    generator seed gives the same scales, another seed others; about 10 %
    zeros, the rest 1/0.9."""
    tg, _ = meshes
    keep = tconv.edge_keep(tg, 8, 0.1, torch.Generator().manual_seed(0))
    perm = torch.from_numpy(np.random.default_rng(0).permutation(tg.edge_src.shape[1]))
    shuffled = tg.replace(edge_src=tg.edge_src[:, perm], edge_dst=tg.edge_dst[:, perm])
    again = tconv.edge_keep(shuffled, 8, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(again, keep[:, perm])
    assert torch.equal(tconv.edge_keep(tg, 8, 0.1, torch.Generator().manual_seed(0)), keep)
    assert not torch.equal(tconv.edge_keep(tg, 8, 0.1, torch.Generator().manual_seed(1)), keep)
    assert not torch.equal(keep[0], keep[1])  # samples differ
    zero, kept = keep.unique().tolist()
    assert zero == 0.0 and kept == pytest.approx(1 / 0.9)
    assert abs(float((keep == 0).float().mean()) - 0.1) < 0.01


# ------------------------------------------------------------ quadtree predict

QT_SHAPE = (16, 16)
QT_MODEL = dict(hidden_size=8, n_layers=1, n_conv_layers=2, convolution_type="TransformerConv")
QT_GRAPH = dict(max_grid_size=4, n_max=256, e_max=2048, aggregation="xla")


def test_transformer_conv_on_an_xla_quadtree_mesh_matches_jax():
    """The same branch on quadtree meshes with a remesh every decoder step:
    ``predict`` against the JAX predictor (≤1e-4 per pixel), on meshes
    asserted identical at every step first."""
    ds = ModMovingMNISTDataset(2, 3, 3, canvas_size=QT_SHAPE, digit_size=(8, 8),
                               pixel_noise=0.02, velocity_noise=0.0, seed=4)
    jp = JPredictor(QT_SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                    model_kwargs=dict(QT_MODEL), graph_kwargs=dict(QT_GRAPH))
    jp._ensure_params()
    jout = jp.predict(JDataLoader(JArrayDataset(ds.x, ds.y, ds.launch_dates), batch_size=2))
    tp = NextFramePredictorS2S(QT_SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                               device="cpu", model_kwargs=dict(QT_MODEL),
                               graph_kwargs=dict(QT_GRAPH))
    assert tp.gcfg.aggregation == "xla" and not tp.gcfg.attn_windows and tp.gcfg.carry_edges
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    y_hat, overflow, meshes = tp.forecast(ds.x)
    mesh = jax.jit(lambda frames: j_image_to_graph(j_posenc(frames), jp.gcfg)[0].pixel_node)
    for b in range(2):
        want = [mesh(jnp.asarray(ds.x[b]))] + [mesh(jnp.asarray(f[None])) for f in jout[b, :-1]]
        for t in range(3):
            np.testing.assert_array_equal(meshes[t, b].numpy(), np.asarray(want[t]))
    assert int(overflow.max()) == 0 and len(np.unique(meshes[0, 0].numpy())) > 20
    np.testing.assert_allclose(y_hat.numpy(), jout, rtol=0, atol=1e-4)
