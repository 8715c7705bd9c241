"""PyTorch port vs JAX package: the configuration dataclasses field for field.

Every field of the JAX package's ``GraphConfig``, ``ModelConfig`` and
``TrainConfig`` exists in the port's with the same default (and, for the
fields that ``__post_init__`` resolves, the same resolved value); the
checks the JAX package asserts raise ``ValueError`` in the port; and the
``graph_kwargs`` that the JAX package's ``cli/ice_exp.py`` and
``bench.py`` pass (``grid_attn`` among them) build a predictor.
"""

import dataclasses

import pytest

from quadtree_mpnnlstm_tpu import config as jconfig
from quadtree_mpnnlstm_tpu_torch import config as tconfig
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S

CLASSES = ("GraphConfig", "ModelConfig", "TrainConfig")


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
        else:
            out[f.name] = dataclasses.MISSING
    return out


@pytest.mark.parametrize("name", CLASSES)
def test_every_jax_field_exists_with_its_default(name):
    jax_fields = _defaults(getattr(jconfig, name))
    port_fields = _defaults(getattr(tconfig, name))
    missing = sorted(set(jax_fields) - set(port_fields))
    assert not missing, f"{name} lacks {missing}"
    for field, default in jax_fields.items():
        assert port_fields[field] == default, (name, field, port_fields[field], default)


@pytest.mark.parametrize("kw", [
    dict(image_shape=(16, 16)),
    dict(image_shape=(20, 28), thresh=float("-inf")),
    dict(image_shape=(16, 16), edges_at_corners=True, max_degree=7),
    dict(image_shape=(8, 8), thresh=float("-inf"), aggregation="grid", grid_attn="pallas"),
], ids=["quadtree", "pixelwise", "corners-capped", "grid-pallas"])
def test_resolved_graph_config_matches_jax(kw):
    """The fields ``__post_init__`` fills (capacities, the degree cap) and
    the derived properties take the JAX package's values."""
    j, t = jconfig.GraphConfig(**kw), tconfig.GraphConfig(**kw)
    for f in dataclasses.fields(j):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
    for prop in ("num_pixels", "num_dirs", "depth", "padded_shape", "pixelwise", "degree_bound",
                 "edge_dim"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("field,value", [
    ("grid_attn", "triton"), ("message_dtype", "float16"), ("adjacency", "dense"),
    ("max_degree", -1), ("aggregation", "cuda"),
])
def test_unknown_values_raise(field, value):
    with pytest.raises(ValueError, match=field):
        tconfig.GraphConfig(image_shape=(8, 8), **{field: value})


def test_new_fields_build_and_replace():
    g = tconfig.GraphConfig(image_shape=(8, 8), grid_attn="pallas", message_dtype="bfloat16",
                            max_degree=12, adjacency="csum")
    assert (g.grid_attn, g.message_dtype, g.max_degree, g.adjacency) == (
        "pallas", "bfloat16", 12, "csum")
    m = tconfig.ModelConfig(concat_layers_dim=3)
    assert m.concat_layers_dim == 3 and m.replace(hidden_size=4).concat_layers_dim == 3
    tc = tconfig.TrainConfig(shared_mesh=True, clip_norm=5.0)
    assert tc.replace(lr=0.1).shared_mesh and tc.clip_norm == 5.0


def test_jax_style_graph_kwargs_build_a_predictor():
    """``cli/ice_exp.py`` and ``bench.py`` pass ``grid_attn`` (and
    ``bench.py`` ``adjacency``) in ``graph_kwargs``; the port keeps them."""
    tp = NextFramePredictorS2S((8, 8), float("-inf"), decompose=False, device="cpu",
                               graph_kwargs=dict(aggregation="grid", grid_attn="pallas"))
    assert tp.gcfg.grid_attn == "pallas"
    tq = NextFramePredictorS2S((16, 16), 0.1, device="cpu",
                               model_kwargs=dict(convolution_type="TransformerConv"),
                               graph_kwargs=dict(max_grid_size=8, aggregation="pallas",
                                                 adjacency="csum", grid_attn="xla",
                                                 message_dtype="float32"))
    assert tq.gcfg.adjacency == "csum" and tq.gcfg.attn_windows


def test_shared_mesh_resolution_matches_the_jax_predictor():
    """Explicit argument > ``train_config.shared_mesh`` > off."""
    kw = dict(device="cpu", model_kwargs=dict(hidden_size=4, n_layers=1, n_conv_layers=1),
              graph_kwargs=dict(max_grid_size=4))
    assert not NextFramePredictorS2S((8, 8), 0.1, **kw).shared_mesh
    on = tconfig.TrainConfig(shared_mesh=True)
    assert NextFramePredictorS2S((8, 8), 0.1, train_config=on, **kw).shared_mesh
    assert not NextFramePredictorS2S((8, 8), 0.1, train_config=on, shared_mesh=False,
                                     **kw).shared_mesh
    assert NextFramePredictorS2S((8, 8), 0.1, shared_mesh=True, **kw).shared_mesh
