"""PyTorch port vs JAX package: the CSR degree cap (``GraphConfig.max_degree``,
the JAX package's ``ops/csr.py`` backend) and bf16 aggregation messages
(``GraphConfig.message_dtype``).

Degree cap, on quadtree edge lists of two samples (f32, one torch thread):

* the build charges the edges ranked past the cap, on the worse of the
  destination and the source side, to ``overflow`` as the JAX package does
  (a cap of 3 truncates; the degree bound truncates nothing);
* the capped sum over each destination's first ``max_degree`` edges
  (``aggregate_to_dst``, the JAX ``csr_segment_sum``) ≤1e-5, and its
  backward gathers the cotangent to *every* edge, truncated ones included
  (exact); ``gather_src``'s backward is the capped sum over the
  source-sorted view, whose order is the JAX package's stable ``src_perm``
  (exact), and ``gather_dst``'s the capped sum over destinations;
* the capped edge softmax (``edge_softmax_graph``: segment max with fill
  −1e30 and sum over the capped edges) ≤1e-6 with gradients ≤1e-5, and a
  truncated edge keeps a non-zero α while its message is dropped;
* the symmetric normalisation (capped degrees), GCN's ``Â z`` and the
  edge-list TransformerConv attention with their gradients ≤1e-5 / ≤1e-4
  × max(1, max|g|);
* a cap at the degree bound gives the uncapped results bit for bit.

Messages in bf16 (``message_dtype="bfloat16"``) under an f32 model: the
edge-list ``Â z`` sums bf16 messages (K7's bf16 instance on a card, its
plain version here) and returns f32; the sum is the f32 sum of the bf16
messages rounded once, bit for bit, and within 1e-2 × max(1, max|ref|) of
the JAX package's, whose XLA rounds at every add (the bound
``tests/test_torch_bf16_edge_list.py`` states for bf16 sums); a ChebConv
forecast on the pixelwise edge list (one fixed mesh) within 2e-2 of the
JAX package's on average and 0.15 everywhere, that file's bounds (the JAX
package's own bf16-message forecast lies 0.078 from its f32-message one
here, the port's 0.085 from its own; with f32 messages the two agree to
4e-6).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.config import GraphConfig as JGraphConfig
from quadtree_mpnnlstm_tpu.graph.build import image_to_graph as j_image_to_graph
from quadtree_mpnnlstm_tpu.models import conv as jconv
from quadtree_mpnnlstm_tpu.ops import segment as jseg
from quadtree_mpnnlstm_tpu.train import NextFramePredictorS2S as JPredictor
from quadtree_mpnnlstm_tpu.utils.posenc import add_positional_encoding as j_posenc
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.models import conv as tconv
from quadtree_mpnnlstm_tpu_torch.ops import segment as tseg
from quadtree_mpnnlstm_tpu_torch.ops import segment_sum as tsegsum
from quadtree_mpnnlstm_tpu_torch.ops.segment_sum import segment_sum_plain, segment_view
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (24, 32)
B, F = 2, 5
CAP = 3
MESH = dict(image_shape=SHAPE, max_grid_size=4, thresh=0.3, n_max=768, e_max=4096,
            aggregation="xla")
OP_TOL, GRAD_TOL = 1e-5, 1e-4


def _frames(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((B, 1, *SHAPE, 1)) ** 3).astype(np.float32)


def _graphs(cap, **kw):
    """(port graph of both samples, [JAX graph of each sample])."""
    frames = _frames()
    cfg = dict(MESH, max_degree=cap, **kw)
    tg, _ = image_to_graph(add_positional_encoding(torch.from_numpy(frames)),
                           GraphConfig(**cfg))
    jgs = [j_image_to_graph(j_posenc(jnp.asarray(frames[b])), JGraphConfig(**cfg))[0]
           for b in range(B)]
    for b, jg in enumerate(jgs):
        for name in ("edge_src", "edge_dst", "edge_valid"):
            np.testing.assert_array_equal(getattr(tg, name)[b].numpy(),
                                          np.asarray(getattr(jg, name)), err_msg=name)
    return tg, jgs


def _rng_arr(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _jax_vjp(fn, x, g):
    out, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(g))[0])


def _port_vjp(fn, x, g):
    xt = torch.from_numpy(x).requires_grad_(True)
    out = fn(xt)
    (grad,) = torch.autograd.grad(out, xt, torch.from_numpy(g))
    return out.detach().numpy(), grad.numpy()


def test_overflow_counts_the_worse_side_as_jax():
    tg, jgs = _graphs(CAP)
    assert tg.max_degree == CAP and (tg.overflow > 0).all()
    for b, jg in enumerate(jgs):
        assert int(tg.overflow[b]) == int(jg.overflow)
    bound = GraphConfig(**MESH).degree_bound
    tg, jgs = _graphs(bound)
    assert int(tg.overflow.max()) == 0 and all(int(jg.overflow) == 0 for jg in jgs)


def test_capped_sum_and_its_backward_to_every_edge():
    tg, jgs = _graphs(CAP)
    e, n = tg.edge_dst.shape[1], tg.n_max
    m = _rng_arr((B, e, F), 1)
    g = _rng_arr((B, n, F), 2)
    out, grad = _port_vjp(lambda v: tseg.aggregate_to_dst(v, tg), m, g)
    truncated = (tg.edge_dst_cap == n) & tg.edge_valid
    assert bool(truncated.any())
    for b, jg in enumerate(jgs):
        jout, jgrad = _jax_vjp(lambda v, jg=jg: jseg.aggregate_to_dst(v, jg), m[b], g[b])
        np.testing.assert_allclose(out[b], jout, rtol=0, atol=OP_TOL)
        np.testing.assert_array_equal(grad[b], jgrad)
        # the quirk: a truncated edge's message is dropped, its gradient is g[dst]
        t = truncated[b].numpy()
        np.testing.assert_array_equal(grad[b][t], g[b][tg.edge_dst[b].numpy()[t]])
    # the entry-ordered capped sum, which K7 gives on the capped view
    want = segment_sum_plain(torch.from_numpy(m), tg.edge_dst_cap, n)
    assert torch.equal(torch.from_numpy(out), want)


@pytest.mark.parametrize("side", ["src", "dst"])
def test_capped_gather_backwards(side):
    tg, jgs = _graphs(CAP)
    e, n = tg.edge_dst.shape[1], tg.n_max
    x = _rng_arr((B, n, F), 3)
    g = _rng_arr((B, e, F), 4)
    port = tseg.gather_src if side == "src" else tseg.gather_dst
    jfn = jseg.gather_src if side == "src" else jseg.gather_dst
    out, grad = _port_vjp(lambda v: port(v, tg), x, g)
    ids = tg.edge_src if side == "src" else tg.edge_dst
    for b, jg in enumerate(jgs):
        _, jgrad = _jax_vjp(lambda v, jg=jg: jfn(v, jg), x[b], g[b])
        valid = tg.edge_valid[b].numpy()
        np.testing.assert_array_equal(out[b][valid], x[b][ids[b].numpy()[valid]])
        np.testing.assert_allclose(grad[b], jgrad, rtol=0, atol=OP_TOL)
    if side == "src":
        # the source-sorted view's order is the JAX package's stable src_perm
        view = segment_view(tg.edge_src, n)
        order = view.order.reshape(B, e).long() - torch.arange(B)[:, None] * e
        for b, jg in enumerate(jgs):
            np.testing.assert_array_equal(order[b].numpy(), np.asarray(jg.src_perm))


def test_capped_edge_softmax_keeps_truncated_alpha():
    tg, jgs = _graphs(CAP)
    e, h = tg.edge_dst.shape[1], 3
    logits = _rng_arr((B, e, h), 5)
    g = _rng_arr((B, e, h), 6)
    alpha, grad = _port_vjp(lambda v: tseg.edge_softmax_graph(v, tg), logits, g)
    truncated = ((tg.edge_dst_cap == tg.n_max) & tg.edge_valid).numpy()
    assert (alpha[truncated] > 0).all()
    for b, jg in enumerate(jgs):
        jalpha, jgrad = _jax_vjp(lambda v, jg=jg: jseg.edge_softmax_graph(v, jg), logits[b],
                                 g[b])
        np.testing.assert_allclose(alpha[b], jalpha, rtol=0, atol=1e-6)
        np.testing.assert_allclose(grad[b], jgrad, rtol=0, atol=OP_TOL)


def test_capped_convs_match_jax():
    """compute_sym_norm (capped degrees), GCN's Â z and the edge-list
    attention, forward and gradients."""
    tg, jgs = _graphs(CAP, use_edge_attrs=True)
    n = tg.n_max
    for b, jg in enumerate(jgs):
        np.testing.assert_allclose(tg.sym_coeff[b].numpy(), np.asarray(jg.sym_coeff), rtol=0,
                                   atol=1e-6)
    z = _rng_arr((B, n, F), 7)
    g = _rng_arr((B, n, F), 8)
    out, grad = _port_vjp(lambda v: tconv.a_mul(v, tg), z, g)
    for b, jg in enumerate(jgs):
        jout, jgrad = _jax_vjp(lambda v, jg=jg: jconv.a_mul(v, jg), z[b], g[b])
        np.testing.assert_allclose(out[b], jout, rtol=0, atol=OP_TOL)
        np.testing.assert_allclose(grad[b], jgrad, rtol=0,
                                   atol=GRAD_TOL * max(1.0, np.abs(jgrad).max()))
    heads, d = 2, 4
    qkv = _rng_arr((3, B, n, heads * d), 9)
    we = _rng_arr((2, heads * d), 10)
    go = _rng_arr((B, n, heads, d), 11)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (*qkv, we)]
    out = tconv.multi_stream_attention(*leaves, tg, heads, d)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(go))
    for b, jg in enumerate(jgs):
        def fn(q, k, v, w, jg=jg):
            return jconv.multi_stream_attention(q, k, v, w, jg, heads, d)[0]
        jout, vjp = jax.vjp(fn, *(jnp.asarray(x[b]) for x in qkv), jnp.asarray(we))
        np.testing.assert_allclose(out[b].detach().numpy(), np.asarray(jout), rtol=0,
                                   atol=OP_TOL)
        jgrads = vjp(jnp.asarray(go[b]))
        for i, (mine, ref) in enumerate(zip(grads, jgrads)):
            ref = np.asarray(ref)
            mine = mine[b].numpy() if i < 3 else None
            if mine is not None:
                np.testing.assert_allclose(mine, ref, rtol=0,
                                           atol=GRAD_TOL * max(1.0, np.abs(ref).max()))
    # dWₑ sums over the batch on the port's side
    jwe = sum(np.asarray(jax.vjp(lambda q, k, v, w, jg=jg: jconv.multi_stream_attention(
        q, k, v, w, jg, heads, d)[0], *(jnp.asarray(x[b]) for x in qkv),
        jnp.asarray(we))[1](jnp.asarray(go[b]))[3]) for b, jg in enumerate(jgs))
    np.testing.assert_allclose(grads[3].numpy(), jwe, rtol=0,
                               atol=GRAD_TOL * max(1.0, np.abs(jwe).max()))


def test_cap_at_the_degree_bound_is_uncapped_bit_for_bit():
    bound = GraphConfig(**MESH).degree_bound
    frames = torch.from_numpy(_frames())
    capped, _ = image_to_graph(add_positional_encoding(frames),
                               GraphConfig(**MESH, max_degree=bound, use_edge_attrs=True))
    plain, _ = image_to_graph(add_positional_encoding(frames),
                              GraphConfig(**MESH, use_edge_attrs=True))
    assert capped.max_degree == bound and plain.max_degree == 0
    assert torch.equal(capped.sym_coeff, plain.sym_coeff)
    n = plain.n_max
    z = torch.from_numpy(_rng_arr((B, n, F), 12))
    heads, d = 2, 4
    qkv = [torch.from_numpy(x) for x in _rng_arr((3, B, n, heads * d), 13)]
    we = torch.from_numpy(_rng_arr((2, heads * d), 14))

    def run(graph):
        leaves = [t.clone().requires_grad_(True) for t in (z, *qkv, we)]
        out = (tconv.a_mul(leaves[0], graph).sum()
               + tconv.multi_stream_attention(*leaves[1:], graph, heads, d).square().sum())
        return [out.detach()] + list(torch.autograd.grad(out, leaves))

    for a, b in zip(run(capped), run(plain)):
        assert torch.equal(a, b)


def test_bf16_messages_sum_in_bf16_under_f32():
    tg, jgs = _graphs(0, message_dtype="bfloat16")
    assert tg.msg_dtype == "bfloat16"
    z = _rng_arr((B, tg.n_max, F), 15)
    seen = []
    real = tsegsum.SegmentSum.apply

    def spy(values, *args):
        seen.append(values.dtype)
        return real(values, *args)

    tsegsum.SegmentSum.apply = spy
    try:
        out, grad = _port_vjp(lambda v: tconv.a_mul(v, tg), z, _rng_arr(z.shape, 16))
    finally:
        tsegsum.SegmentSum.apply = real
    assert out.dtype == np.float32 and grad.dtype == np.float32
    assert seen[0] == torch.bfloat16  # the aggregation's operand
    msg = (tg.sym_coeff[..., None] * tseg.gather_src(torch.from_numpy(z), tg)).to(torch.bfloat16)
    exact = segment_sum_plain(msg.float(), tg.edge_dst, tg.n_max).to(torch.bfloat16).float()
    assert torch.equal(torch.from_numpy(out), exact)
    for b, jg in enumerate(jgs):
        ref = np.asarray(jconv.a_mul(jnp.asarray(z[b]), jg), np.float32)
        assert np.abs(out[b] - ref).max() <= 1e-2 * max(1.0, np.abs(ref).max())


def test_bf16_message_forecast_matches_jax():
    """A ChebConv forecast on the pixelwise edge list (one mesh, no flips)
    with bf16 messages in an f32 model."""
    shape, t_in, t_out = (12, 16), 2, 3
    graph = dict(aggregation="xla", message_dtype="bfloat16")
    model = dict(hidden_size=8, n_layers=1, n_conv_layers=1, dropout=0.0,
                 convolution_type="ChebConv", remat=False)
    jp = JPredictor(shape, float("-inf"), decompose=False, input_timesteps=t_in,
                    output_timesteps=t_out, model_kwargs=dict(model), graph_kwargs=dict(graph))
    jp._ensure_params()
    x = np.random.default_rng(17).random((2, t_in, *shape, 1)).astype(np.float32)
    jy = np.asarray(jax.jit(jax.vmap(lambda xb: jp.eval_model.apply(jp.params, xb)))(
        jnp.asarray(x)))
    tp = NextFramePredictorS2S(shape, float("-inf"), decompose=False, input_timesteps=t_in,
                               output_timesteps=t_out, device="cpu", model_kwargs=dict(model),
                               graph_kwargs=dict(graph))
    tp.load_jax_params(jax.tree.map(np.asarray, jp.params))
    assert tp.gcfg.message_dtype == "bfloat16" and tp.cfg.compute_dtype == "float32"
    y, overflow, _ = tp.forecast(x)
    assert int(overflow.max()) == 0 and y.dtype == torch.float32
    diff = np.abs(y.numpy() - jy)
    assert float(diff.mean()) <= 2e-2 and float(diff.max()) <= 0.15
