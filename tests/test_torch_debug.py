"""The debug modes of the port: NaN localisation (``debug=True`` on the
predictor, ``ModelConfig.debug_nan`` on the model) and
``GraphConfig.debug_overflow``.

As ``tests/test_debug_nan.py`` does for the JAX package: a NaN put into a
decoder weight is named at the decoder module and rollout step t=0, one
put into an encoder weight at the encoder, and a clean debug step equals
a plain one bit for bit. The port's train step runs unchecked and, when
its loss comes back non-finite, replays its forward with the checks on
before the update (the JAX package's checkified replay), so the weights
stay as they were. The messages are the JAX package's. The overflow
check raises the JAX package's ``RuntimeError`` on an undersized
``n_max`` and stays silent otherwise.
"""

import inspect
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from quadtree_mpnnlstm_tpu.models import seq2seq as jseq2seq
from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, ModelConfig
from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding
from torch_threads import one_torch_thread  # noqa: F401  (torch on one thread)

SHAPE = (16, 16)
GRAPH = dict(max_grid_size=4, n_max=256, e_max=1024, node_budget=256)


def _predictor(debug, run_dir, **kw):
    return NextFramePredictorS2S(
        SHAPE, 0.1, debug=debug, input_timesteps=2, output_timesteps=3, device="cpu",
        run_dir=str(run_dir),
        model_kwargs=dict(hidden_size=8, n_layers=1, n_conv_layers=1,
                          convolution_type="GCNConv", **kw.pop("model", {})),
        graph_kwargs=dict(GRAPH), **kw)


def _batch():
    rng = np.random.default_rng(0)
    return (rng.random((2, 2, *SHAPE, 1), np.float32),
            rng.random((2, 3, *SHAPE, 1), np.float32))


@pytest.mark.parametrize("needle,message", [
    ("decoder", "non-finite output in module=decoder at rollout step t=0"),
    ("encoder", "non-finite hidden state in module=encoder (fixed-mesh scan step); "
                "inputs or encoder weights went NaN"),
])
@pytest.mark.parametrize("truncated", [0, 2])
def test_nan_weight_is_named_by_module_and_step(needle, message, truncated, tmp_path):
    tp = _predictor(True, tmp_path)
    tp.initiate_training(lr=0.01, lr_decay=0.95)
    hit = 0
    with torch.no_grad():
        for name, p in tp.model.named_parameters():
            if name.startswith(needle + "."):
                p.fill_(float("nan"))
                hit += 1
    assert hit > 0
    before = {n: p.detach().clone() for n, p in tp.model.named_parameters()}
    x, y = _batch()
    with pytest.raises(ValueError, match=re.escape(message)):
        tp.train_step(x, y, truncated_backprop=truncated)
    assert tp.model.check_finite is False  # the checks are off again
    for n, p in tp.model.named_parameters():  # the update did not run
        assert torch.equal(p, before[n]) or torch.isnan(before[n]).all(), n


def test_nan_input_is_named_at_encode(tmp_path):
    tp = _predictor(True, tmp_path)
    tp.initiate_training(lr=0.01, lr_decay=0.95)
    x, y = _batch()
    x[1, 0, 3, 4, 0] = np.nan
    with pytest.raises(ValueError, match=re.escape("NaN in graph input x (module=encode")):
        tp.train_step(x, y)


def test_remesh_input_encoder_nan_names_its_scan_step(tmp_path):
    tp = _predictor(True, tmp_path, remesh_input=True, model=dict(remesh_every=2))
    tp.initiate_training(lr=0.01, lr_decay=0.95)
    with torch.no_grad():
        tp.model.encoder.norm_h.weight.fill_(float("nan"))
    x, y = _batch()
    with pytest.raises(ValueError, match=re.escape("module=encoder (remesh_input scan step)")):
        tp.train_step(x, y)


def test_messages_are_the_jax_packages():
    src = inspect.getsource(jseq2seq)
    for text in ("non-finite output in module=decoder at rollout step t={t}",
                 "non-finite hidden state in module=encoder (fixed-mesh scan ",
                 "non-finite hidden state in module=encoder (remesh_input scan ",
                 "NaN in graph input x (module=encode; ref "):
        assert text in src, text


@pytest.mark.parametrize("remat", [False, True])
def test_clean_debug_step_equals_plain_step(remat, tmp_path):
    """The debug step syncs on its loss and logs the gradient norms, and
    its loss, gradients and updated weights equal the plain step's."""
    x, y = _batch()
    out = {}
    for debug in (False, True):
        tp = _predictor(debug, tmp_path, teacher_forcing_ratio=0.5,
                        model=dict(dropout=0.1, remat=remat))
        tp.initiate_training(lr=0.01, lr_decay=0.95)
        loss, overflow = tp.train_step(x, y, truncated_backprop=2)
        grads = {n: p.grad.clone() for n, p in tp.model.named_parameters()}
        out[debug] = (loss, overflow, grads, tp.model.state_dict(), tp.generator.get_state())
        assert tp.cfg.debug_nan is debug and tp.model.check_finite is False
    assert torch.equal(out[True][0], out[False][0]) and torch.equal(out[True][1], out[False][1])
    for part in (2, 3):
        for n, v in out[False][part].items():
            assert torch.equal(out[True][part][n], v), n
    assert torch.equal(out[True][4], out[False][4])


def test_debug_train_logs_the_gradient_norms(tmp_path):
    x, y = _batch()
    tp = _predictor(True, tmp_path)
    loader = DataLoader(ArrayDataset(x, y, np.array([20160601, 20160602])), batch_size=1)
    tp.train(loader, loader, n_epochs=1, divergence_threshold=float("inf"))
    rows = [json.loads(line) for path in Path(tmp_path).glob("*/scalars.jsonl")
            for line in path.read_text().splitlines()]
    tags = [r["tag"] for r in rows]
    for side in ("encoder", "decoder"):
        values = [r["value"] for r in rows if r["tag"] == f"Grad/{side}/grad_norms"]
        assert len(values) == 2 and all(np.isfinite(values)) and min(values) > 0, side
    assert tags.count("Loss/train") == 2


def test_debug_nan_on_the_model_checks_its_forecast():
    """``ModelConfig.debug_nan`` alone turns the checks on in the model's
    own forward; without it a NaN passes through unchecked."""
    cfg = ModelConfig(hidden_size=4, input_timesteps=2, output_timesteps=2, n_layers=1,
                      n_conv_layers=1, debug_nan=True)
    gcfg = GraphConfig(image_shape=SHAPE, thresh=0.1, **GRAPH)
    x = torch.rand(1, 2, *SHAPE, 1)
    model = Seq2Seq(cfg, gcfg).eval()
    assert model.check_finite
    with torch.no_grad():
        assert torch.isfinite(model(x)).all()
        model.decoder.fc_out2.bias.fill_(float("nan"))
        with pytest.raises(ValueError, match=re.escape("module=decoder at rollout step t=0")):
            model(x)
        model.check_finite = False
        assert torch.isnan(model(x)).any()


def test_debug_overflow_raises_on_an_undersized_mesh():
    img = add_positional_encoding(torch.rand(2, 1, *SHAPE, 1))
    cfg = GraphConfig(image_shape=SHAPE, thresh=0.1, max_grid_size=4, debug_overflow=True)
    graph, _ = image_to_graph(img, cfg)  # exact capacities: silent
    assert int(graph.overflow.max()) == 0
    small = cfg.replace(n_max=16, e_max=64)
    with pytest.raises(RuntimeError, match=r"graph capacity overflow: \d+ dropped nodes/edges/"
                                           r"window slots — raise n_max/e_max/agg_\* caps"):
        image_to_graph(img, small)
    graph, _ = image_to_graph(img, small.replace(debug_overflow=False))
    assert int(graph.overflow.max()) > 0
    blocks = cfg.replace(aggregation="pallas", agg_nt=16, agg_eb=8, agg_sw=16)
    with pytest.raises(RuntimeError, match="graph capacity overflow"):
        image_to_graph(img, blocks)
