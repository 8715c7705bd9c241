"""PyTorch port vs JAX package: the segment sum (K7).

``segment_sum_plain`` (K7's plain version, what the kernel is held to on
the card) against the JAX package's ``segment_sum_pallas`` (Pallas
interpret mode on the CPU) and ``jax.ops.segment_sum``, on seeded numpy
inputs: sorted and unsorted ids, sentinel ids, F = 1, 33 and 256, empty
buckets, E ≤ 2048 and n_out ≤ 300. The tolerance is 1e-6 × max(1,
max|out|): the one-hot product sums each bucket in another order than an
entry-ordered sum. The backward (a row gather) is exact against JAX's VJP.
Also: the CSR view the kernel reads gives, summed in its order, the
entry-ordered sum bit for bit, CPU tensors take the plain version through
every entry point of ``ops/segment.py``, and the builders' ``edge_dst`` is
sorted, as the offsets-only view assumes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from quadtree_mpnnlstm_tpu.ops.pallas_segment import segment_sum_pallas
from quadtree_mpnnlstm_tpu_torch.ops import segment, segment_sum

E, N_OUT, B = 2048, 300, 2
TOL = 1e-6


def _case(f, sorted_ids, seed=0):
    """values (B, E, F) and ids (B, E): every tenth entry a sentinel
    (n_out), a band of empty buckets, sorted ids with the sentinels last."""
    rng = np.random.default_rng(seed)
    values = rng.standard_normal((B, E, f)).astype(np.float32)
    ids = rng.integers(0, N_OUT, (B, E))
    ids[(ids > 100) & (ids < 140)] = 0  # buckets 101..139 stay empty
    ids[:, ::10] = N_OUT
    if sorted_ids:
        ids = np.sort(ids, axis=1)
    return values, ids


def _check_close(mine, ref):
    ref = np.asarray(ref)
    err = float(np.abs(mine - ref).max())
    assert err <= TOL * max(1.0, float(np.abs(ref).max())), err


@pytest.mark.parametrize("sorted_ids", [True, False])
@pytest.mark.parametrize("f", [1, 33, 256])
def test_segment_sum_plain_matches_jax(f, sorted_ids):
    values, ids = _case(f, sorted_ids, seed=f)
    out = segment_sum.segment_sum_plain(torch.from_numpy(values), torch.from_numpy(ids),
                                        N_OUT).numpy()
    assert out.shape == (B, N_OUT, f)
    assert (out[:, 101:140] == 0).all()
    for b in range(B):
        v, i = jnp.asarray(values[b]), jnp.asarray(ids[b], jnp.int32)
        _check_close(out[b], segment_sum_pallas(v, i, N_OUT))
        _check_close(out[b], jax.ops.segment_sum(v, i, num_segments=N_OUT + 1)[:N_OUT])


@pytest.mark.parametrize("f", [1, 33])
def test_segment_sum_backward_is_jax_vjp(f):
    """``SegmentSum``'s backward gathers the cotangent at each entry's
    bucket, 0 at a sentinel: exactly ``segment_sum_pallas``'s VJP."""
    values, ids = _case(f, sorted_ids=False, seed=10 + f)
    g = np.random.default_rng(f).standard_normal((B, N_OUT, f)).astype(np.float32)
    v = torch.from_numpy(values).requires_grad_(True)
    out = segment_sum.segment_sum(v, torch.from_numpy(ids), N_OUT)
    (grad,) = torch.autograd.grad(out, v, torch.from_numpy(g))
    for b in range(B):
        i = jnp.asarray(ids[b], jnp.int32)
        _, vjp = jax.vjp(lambda x, i=i: segment_sum_pallas(x, i, N_OUT), jnp.asarray(values[b]))
        np.testing.assert_array_equal(grad[b].numpy(), np.asarray(vjp(jnp.asarray(g[b]))[0]))
    assert (grad.numpy()[:, ::10] == 0).all()


@pytest.mark.parametrize("sorted_ids", [True, False])
def test_view_order_gives_the_entry_ordered_sum(sorted_ids):
    """Summing each bucket's entries in the order of its CSR view, from 0,
    as the kernel does, gives the entry-ordered sum (``np.add.at``) bit for
    bit, and so does the plain version when its ``index_put_`` runs
    serially (on the CPU, several threads add large inputs with atomics);
    a negative id is dropped like the sentinel."""
    values, ids = _case(33, sorted_ids, seed=3)
    if not sorted_ids:
        ids[:, 5] = -1
    view = segment_sum.segment_view(torch.from_numpy(ids), N_OUT, sorted_ids=sorted_ids)
    assert (view.order is None) == sorted_ids
    order = np.arange(B * E) if view.order is None else view.order.numpy()
    offsets = view.offsets.numpy()
    flat = values.reshape(B * E, -1)
    mine = np.zeros((B, N_OUT, 33), np.float32)
    ref = np.zeros((B, N_OUT, 33), np.float32)
    for b in range(B):
        for n in range(N_OUT):
            entries = order[offsets[b, n]:offsets[b, n + 1]]
            assert (np.diff(entries) > 0).all() and (entries // E == b).all()
            for e in entries:
                mine[b, n] += flat[e]
        inside = (ids[b] >= 0) & (ids[b] < N_OUT)
        np.add.at(ref[b], ids[b][inside], values[b][inside])
    assert (offsets[:, -1] - offsets[:, 0]).tolist() == [
        int(((i >= 0) & (i < N_OUT)).sum()) for i in ids]
    np.testing.assert_array_equal(mine, ref)
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        plain = segment_sum.segment_sum_plain(torch.from_numpy(values), torch.from_numpy(ids),
                                              N_OUT)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    np.testing.assert_array_equal(plain.numpy(), ref)


@pytest.mark.parametrize("entry", ["segment_sum_nodes", "gather_nodes", "plain_gather"])
def test_backend_switch_keeps_cpu_tensors_on_the_plain_version(entry):
    """The tensor's device is the backend switch: on the CPU the segment
    sum of ``ops/segment.py`` and the backward of its gathers (``routed``
    or not) are the plain versions bit for bit, and no kernel launches."""
    values, ids = _case(4, sorted_ids=False, seed=4)
    v = torch.from_numpy(values).requires_grad_(True)
    i = torch.from_numpy(ids)
    launches = dict(segment_sum.LAUNCHES)
    plain = segment_sum.segment_sum_plain(v.detach(), i, N_OUT)
    if entry == "segment_sum_nodes":
        out = segment.segment_sum_nodes(v, i, N_OUT)
        cot = torch.from_numpy(np.random.default_rng(0).standard_normal(out.shape)
                               .astype(np.float32))
        (grad,) = torch.autograd.grad(out, v, cot)
        np.testing.assert_array_equal(out.detach().numpy(), plain.numpy())
        np.testing.assert_array_equal(grad.numpy(),
                                      segment_sum.gather_rows_plain(cot, i, N_OUT).numpy())
    else:
        nodes = torch.from_numpy(values[:, :N_OUT]).requires_grad_(True)
        picked = segment.gather_nodes(nodes, i, N_OUT, routed=entry == "gather_nodes")
        (grad,) = torch.autograd.grad(picked, nodes, v.detach())
        np.testing.assert_array_equal(picked.detach().numpy(),
                                      segment_sum.gather_rows_plain(nodes.detach(), i,
                                                                    N_OUT).numpy())
        np.testing.assert_array_equal(grad.numpy(), plain.numpy())
    assert segment_sum.LAUNCHES == launches


@pytest.mark.parametrize("thresh", [float("-inf"), 0.1])
def test_edge_dst_view_needs_only_offsets(thresh):
    """A graph built on the CPU carries no CSR views (the plain version
    reads none). The builders' ``edge_dst`` (pixelwise and quadtree edge
    lists) is sorted per sample with the sentinels last, so the view a
    build on the card makes of it from offsets alone is the view of a
    stable sort, with the identity order."""
    from quadtree_mpnnlstm_tpu_torch.config import GraphConfig
    from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
    from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding

    shape = (16, 16)
    x = np.random.default_rng(5).random((B, 2, *shape, 1)).astype(np.float32)
    mask = np.zeros(shape, bool)
    mask[:3, :5] = True
    cfg = GraphConfig(image_shape=shape, thresh=thresh, max_grid_size=8, aggregation="xla")
    graph, _ = image_to_graph(add_positional_encoding(torch.from_numpy(x)), cfg,
                              mask=torch.from_numpy(mask))
    assert graph.pixel_view is graph.dst_view is graph.src_view is None
    n_max = graph.n_max
    offsets_only = segment_sum.segment_view(graph.edge_dst, n_max, sorted_ids=True)
    stable = segment_sum.segment_view(graph.edge_dst, n_max)
    assert offsets_only.order is None
    np.testing.assert_array_equal(stable.order.numpy(), np.arange(graph.edge_dst.numel()))
    np.testing.assert_array_equal(offsets_only.offsets.numpy(), stable.offsets.numpy())
    assert int(graph.edge_valid.sum()) == int(offsets_only.offsets[:, -1].sum()
                                               - offsets_only.offsets[:, 0].sum())
