"""The port's trainer on its own, on the CPU: dropout, generators, the
epoch loop with its StepLR, checkpoints, the guards, and the two repairs
that make its autograd graph match the JAX package's (Â carries no
gradient; ``unflatten``'s backward is a fixed-order segment sum). The
parity of loss, gradient and Adam steps with the JAX package is in
tests/test_torch_train_grads.py and tests/test_torch_train_steps.py."""

import numpy as np
import pytest
import torch

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, TrainConfig
from quadtree_mpnnlstm_tpu_torch.data.loader import ArrayDataset, DataLoader
from quadtree_mpnnlstm_tpu_torch.data.moving_mnist import ModMovingMNISTDataset
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.state import unflatten
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import dropout
from quadtree_mpnnlstm_tpu_torch.ops import spmm
from quadtree_mpnnlstm_tpu_torch.ops.segment import gather_nodes, segment_sum_nodes
from quadtree_mpnnlstm_tpu_torch.train.predictor import NextFramePredictorS2S
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding

SHAPE = (16, 16)
MODEL = dict(hidden_size=8, n_layers=2, n_conv_layers=2)
GRAPH = dict(max_grid_size=8, n_max=256, e_max=2048, node_budget=256,
             aggregation="pallas", agg_nt=128, agg_eb=1024, agg_sw=256)


@pytest.fixture(scope="module")
def data():
    return ModMovingMNISTDataset(4, 3, 3, canvas_size=SHAPE, digit_size=(8, 8),
                                 pixel_noise=0.02, velocity_noise=0.0, seed=1)


def _port(tmp_path, seed=4, **kw):
    return NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                                 device="cpu", run_dir=str(tmp_path), seed=seed,
                                 model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH), **kw)


def test_dropout_drops_a_tenth_and_rescales():
    x = torch.ones(64, 1000)
    out = dropout(x, 0.1, True, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(1.0 - float(kept.float().mean()) - 0.1) < 0.01
    torch.testing.assert_close(out[kept], torch.full_like(out[kept], 1 / 0.9))
    assert dropout(x, 0.1, False, None) is x  # identity outside training
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.1, True, None)


def test_eval_mode_is_deterministic_and_skips_dropout(tmp_path, data):
    tp = _port(tmp_path)
    tp.model.train()
    first, _, _ = tp.forecast(data.x[:2])  # forecast switches to eval mode
    assert not tp.model.training
    again, _, _ = tp.forecast(data.x[:2])
    assert torch.equal(first, again)


def test_train_step_is_seeded_by_its_generator(tmp_path, data):
    def loss(seed):
        tp = _port(tmp_path)
        tp.initiate_training(lr=0.01, lr_decay=0.95)
        out, overflow = tp.train_step(data.x[:2], data.y[:2],
                                      generator=torch.Generator().manual_seed(seed))
        assert out.dim() == 0 and int(overflow) == 0
        return float(out)

    assert loss(7) == loss(7)
    assert loss(7) != loss(8)  # the dropout masks differ


def test_train_runs_epochs_with_step_lr(tmp_path, data):
    tp = _port(tmp_path)
    loader = DataLoader(ArrayDataset(data.x, data.y, data.launch_dates), batch_size=2)
    lrs = []
    step = tp.train_step

    def recording_step(*args, **kw):
        lrs.append(tp.optimizer.param_groups[0]["lr"])
        return step(*args, **kw)

    tp.train_step = recording_step
    tp.train(loader, loader, n_epochs=4, lr=0.01, lr_decay=0.5, divergence_threshold=100.0)
    assert lrs == pytest.approx([0.01] * 6 + [0.005] * 2)  # γ^(epoch // 3), 2 steps an epoch
    assert len(tp.loss["train_loss"]) == len(tp.loss["test_loss"]) == 4
    assert np.isfinite(tp.loss["train_loss"]).all() and np.isfinite(tp.loss["test_loss"]).all()
    lines = (tmp_path.glob("experiment_*/scalars.jsonl")).__next__().read_text().splitlines()
    assert sum('"Loss/train"' in ln for ln in lines) == 8
    score = tp.score(loader)
    assert score["RMSE"] == pytest.approx(np.sqrt(score["MSE"]))
    assert tp.get_n_params() == sum(p.numel() for p in tp.model.parameters())


def test_train_takes_its_defaults_from_a_train_config(tmp_path, data):
    tc = TrainConfig(lr=0.02, lr_decay=0.5, n_epochs=1, seed=9)
    tp = NextFramePredictorS2S(SHAPE, 0.1, input_timesteps=3, output_timesteps=3,
                               device="cpu", run_dir=str(tmp_path), train_config=tc,
                               model_kwargs=dict(MODEL), graph_kwargs=dict(GRAPH))
    for p, q in zip(tp.model.parameters(), _port(tmp_path, seed=9).model.parameters()):
        assert torch.equal(p, q)  # seeded from the config when no seed is given
    loader = DataLoader(ArrayDataset(data.x[:2], data.y[:2], data.launch_dates[:2]), batch_size=2)
    tp.train(loader, loader, divergence_threshold=100.0)
    assert len(tp.loss["train_loss"]) == 1
    assert tp.optimizer.param_groups[0]["lr"] == 0.02


def test_checkpoint_round_trips_weights_optimizer_and_epoch(tmp_path, data):
    tp = _port(tmp_path)
    loader = DataLoader(ArrayDataset(data.x, data.y, data.launch_dates), batch_size=2)
    tp.train(loader, loader, n_epochs=1, lr=0.01, lr_decay=0.95, divergence_threshold=100.0)
    tp.save_checkpoint(str(tmp_path / "ckpt"))
    tp.save(str(tmp_path / "weights"))

    other = _port(tmp_path, seed=5)
    other.restore_checkpoint(str(tmp_path / "ckpt"))
    assert other._epoch == tp._epoch == 1
    for p, q in zip(tp.model.parameters(), other.model.parameters()):
        assert torch.equal(p, q)
        for key in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(tp.optimizer.state[p][key], other.optimizer.state[q][key])
    weights_only = _port(tmp_path, seed=6)
    weights_only.load(str(tmp_path / "weights"))
    for p, q in zip(tp.model.parameters(), weights_only.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("bad,message", [("nan", "NaN loss :("), ("diverged", "Diverged :(")])
def test_train_guards_raise(tmp_path, data, bad, message):
    tp = _port(tmp_path)
    train = DataLoader(ArrayDataset(data.x[:2], data.y[:2], data.launch_dates[:2]), batch_size=2)
    x_test = data.x[2:].copy()
    threshold = 100.0
    if bad == "nan":
        x_test[:, :, :4, :4] = np.nan
    else:
        threshold = 0.0  # any test loss exceeds it
    test = DataLoader(ArrayDataset(x_test, data.y[2:], data.launch_dates[2:]), batch_size=2)
    with pytest.raises(ValueError, match=message.replace("(", r"\(")):
        tp.train(train, test, n_epochs=1, lr=0.01, lr_decay=0.95,
                 divergence_threshold=threshold)


def test_teacher_forcing_needs_targets_and_generator(tmp_path, data):
    tp = _port(tmp_path, teacher_forcing_ratio=0.5)
    state = tp.model.encode(torch.from_numpy(data.x[:2]))
    with pytest.raises(ValueError, match="teacher forcing"):
        tp.model.decode(state, 3, teacher_forcing_ratio=0.5)


def _graph(requires_grad):
    cfg = GraphConfig(image_shape=SHAPE, max_grid_size=8, thresh=0.1, n_max=256, e_max=2048,
                      use_edge_attrs=False, aggregation="pallas", agg_nt=128, agg_eb=1024,
                      agg_sw=256)
    rng = np.random.default_rng(0)
    img = torch.from_numpy((rng.random((2, 1, *SHAPE, 1)) ** 4).astype(np.float32))
    img.requires_grad_(requires_grad)
    return image_to_graph(add_positional_encoding(img), cfg)


def test_blocks_carry_no_gradient():
    """Â is built from detached windows, as the JAX package stop-gradients
    them, even when the frame it is built from requires grad."""
    graph, data = _graph(requires_grad=True)
    assert data.requires_grad
    assert graph.agg_meta.blocks.grad_fn is None and not graph.agg_meta.blocks.requires_grad
    w, _ = spmm.spmm_tile_meta(torch.zeros(1, 4, dtype=torch.long), torch.zeros(1, 4, dtype=torch.long),
                               torch.rand(1, 4, requires_grad=True), 128, 128, 8, 128)
    assert w.coeff.requires_grad
    meta = spmm.spmm_build_blocks(w, 128, 128, torch.tensor([3]))
    assert meta.blocks.grad_fn is None


def _backward_nodes(t):
    seen, todo = set(), [t.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is not None and type(fn).__name__ not in seen:
            seen.add(type(fn).__name__)
            todo.extend(f for f, _ in fn.next_functions)
    return seen


def test_unflatten_backward_is_a_segment_sum():
    graph, _ = _graph(requires_grad=False)
    rng = np.random.default_rng(1)
    nodes = torch.from_numpy(rng.standard_normal((2, 256, 3)).astype(np.float32))
    nodes.requires_grad_(True)
    img = unflatten(nodes, graph, SHAPE)
    cot = torch.from_numpy(rng.standard_normal(img.shape).astype(np.float32))
    (grad,) = torch.autograd.grad(img, nodes, cot)
    want = segment_sum_nodes(cot.reshape(2, -1, 3), graph.pixel_node, 256)
    assert torch.equal(grad, want)
    # torch.gather's backward (an atomic scatter on CUDA) is not in the graph
    names = _backward_nodes(img)
    assert "_GatherNodesBackward" in names and "GatherBackward0" not in names
    # ids past n_max read zeros and pass no gradient
    ids = torch.tensor([[0, 5, 256, 300]])
    vals = torch.arange(256.0).reshape(1, 256, 1).requires_grad_(True)
    out = gather_nodes(vals, ids, 256)
    assert out.flatten().tolist() == [0.0, 5.0, 0.0, 0.0]
    (g,) = torch.autograd.grad(out.sum(), vals)
    assert g.sum() == 2 and g[0, 0, 0] == 1 and g[0, 5, 0] == 1


def test_metrics_logger_writes_jsonl_and_optional_tensorboard(tmp_path, monkeypatch):
    import json
    import sys
    import types

    from quadtree_mpnnlstm_tpu_torch.train.metrics import MetricsLogger

    written = []

    class Writer:  # stands in for torch.utils.tensorboard.SummaryWriter
        def __init__(self, log_dir):
            self.log_dir = log_dir

        def add_scalar(self, tag, value, step):
            written.append((tag, value, step))

        def flush(self):
            pass

        def close(self):
            pass

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    for tensorboard in (False, True):
        log = MetricsLogger(str(tmp_path / str(tensorboard)), "run", tensorboard=tensorboard)
        log.scalar("Loss/train", 0.5, 3)
        log.close()
        (path,) = (tmp_path / str(tensorboard)).glob("run_*/scalars.jsonl")
        assert json.loads(path.read_text()) == {"tag": "Loss/train", "value": 0.5, "step": 3}
    assert written == [("Loss/train", 0.5, 3)]
