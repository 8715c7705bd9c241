"""Graph seq2seq encoder–decoder with per-step remeshing.

Counterpart of ``quadtree_mpnnlstm_tpu/models/seq2seq.py``: the fixed-mesh
encoder and the decoder rollout with a remesh at every step, for
inference and training. The JAX package runs both as ``nn.scan``s vmapped
over samples; here they are Python loops over time with an explicit batch
axis, each sample on its own mesh.

Reference quirks kept from the JAX package:
  * encoder layer 0 receives the *top* layer's (H, C) from the previous
    timestep; upper layers restart from zeros each step;
  * one shared LayerNorm pair is applied to every layer's H and C;
  * decoder conv stacks are 1 layer deep regardless of config;
  * decoder head: ``tanh(gnn_out(relu(norm(top_O)) ⧺ value)) + X[..., 0]``
    — a residual on the previous value map; the "top output" is the LSTM's
    output-gate activation;
  * decoder input is ``[value, pos_x, pos_y, node_size]`` seeded from the
    last encoder frame, and the concat channel is the current value at
    every step including t=0;
  * the remesh also runs after the last decoder step, and the mesh
    overflow is a running max over the whole rollout.

Training mode (``model.train()``) turns on the decoder head's dropout;
``decode`` takes a scheduled-sampling ratio. Both draw from the caller's
``torch.Generator`` only, never from torch's global RNG, so a step is
reproducible from its generator's seed. ``remesh_input``, climatology,
preset meshes and the shared-mesh batched layout are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, ModelConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors, flatten, unflatten
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.conv import ChebConv
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding


@dataclasses.dataclass
class Seq2SeqState:
    """Rollout state: current meshes, node input, per-layer recurrent state."""

    graph: GraphTensors
    x: torch.Tensor                   # (B, n_max, F) current node input
    hidden: Tuple[torch.Tensor, ...]  # n_layers × (B, n_max, hidden)
    cell: Tuple[torch.Tensor, ...]    # n_layers × (B, n_max, hidden)


class LayerNorm(nn.Module):
    """LayerNorm with flax's statistics: variance as E[x²] − E[x]², clipped
    at 0 (flax's ``use_fast_variance``). Rows of near-constant hidden state
    (padding nodes, coarse cells) make the two variance formulas differ far
    above f32 rounding once normalised, so the port uses the reference's."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        var = ((x * x).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def _transfer_state(hc, old_graph, new_graph, shape):
    """Carry per-layer recurrent state across a remesh through pixel space:
    unflatten on the old mapping, flatten on the new."""
    return tuple(
        flatten(unflatten(h, old_graph, shape)[:, None], new_graph)[:, 0] for h in hc
    )


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each entry with probability 1 − rate and
    scale it by 1/(1 − rate); the identity outside training or at rate 0.
    The mask is drawn from ``generator``, on ``x``'s device."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs an explicit torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def _check_supported(cfg: ModelConfig) -> None:
    supported = dict(convolution_type="ChebConv", rnn_type="LSTM", fused_gates=True,
                     remesh_every=1, compute_dtype="float32")
    for field, value in supported.items():
        if getattr(cfg, field) != value:
            raise ValueError(
                f"ModelConfig.{field}={getattr(cfg, field)!r} is not ported; "
                f"this path runs {field}={value!r}"
            )
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"ModelConfig.dropout={cfg.dropout!r} must lie in [0, 1)")


def _make_cells(module: nn.Module, in_channels: int, hidden: int,
                n_layers: int, n_conv_layers: int) -> None:
    for i in range(n_layers):
        module.add_module(
            f"rnn_{i}", GConvLSTM(in_channels if i == 0 else hidden, hidden, n_conv_layers)
        )


class Encoder(nn.Module):
    """One encoder timestep over stacked cells."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.n_layers = cfg.n_layers
        h = cfg.hidden_size
        _make_cells(self, cfg.node_input_features, h, cfg.n_layers, cfg.n_conv_layers)
        self.norm_h = LayerNorm(h)
        self.norm_c = LayerNorm(h)

    def rnn(self, i: int) -> GConvLSTM:
        return getattr(self, f"rnn_{i}")

    def forward(self, x_t, graph, prev_hidden, prev_cell):
        # Layer 0 consumes the previous timestep's TOP layer state.
        _, h, c = self.rnn(0)(x_t, graph, prev_hidden[-1], prev_cell[-1])
        hs, cs = [self.norm_h(h)], [self.norm_c(c)]
        zero = torch.zeros_like(hs[0])
        for i in range(1, self.n_layers):
            _, h, c = self.rnn(i)(hs[-1], graph, zero, zero)
            hs.append(self.norm_h(h))
            cs.append(self.norm_c(c))
        return tuple(hs), tuple(cs)


class Decoder(nn.Module):
    """One decoder timestep + output head."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.n_layers = cfg.n_layers
        self.binary = cfg.binary
        self.dropout = cfg.dropout
        h = cfg.hidden_size
        # decoder input is [value, pos_x, pos_y, node_size]; conv stacks are
        # 1 layer deep
        _make_cells(self, 4, h, cfg.n_layers, 1)
        self.fc_out1 = ChebConv(h + 1, h)  # + the concat (value) channel
        self.fc_out2 = ChebConv(h, 1)
        self.norm_o = LayerNorm(h)
        self.norm_h = LayerNorm(h)
        self.norm_c = LayerNorm(h)

    def rnn(self, i: int) -> GConvLSTM:
        return getattr(self, f"rnn_{i}")

    def forward(self, x, graph, concat, hidden, cell, generator=None):
        out, h, c = self.rnn(0)(x, graph, hidden[0], cell[0])
        hs, cs = [self.norm_h(h)], [self.norm_c(c)]
        for i in range(1, self.n_layers):
            out, h, c = self.rnn(i)(hs[-1], graph, hidden[i], cell[i])
            hs.append(self.norm_h(h))
            cs.append(self.norm_c(c))
        output = torch.relu(self.norm_o(out))
        output = torch.cat([output, concat], dim=-1)
        output = self.fc_out2(torch.relu(self.fc_out1(output, graph)), graph)
        output = dropout(output, self.dropout, self.training, generator)
        output = torch.tanh(output) + x[..., :1]  # residual on previous value
        if self.binary:
            output = torch.sigmoid(output)
        return output, tuple(hs), tuple(cs)


class Seq2Seq(nn.Module):
    """Full forecast model: ``forward(x)`` → (B, T_out, rows, cols, 1)."""

    def __init__(self, cfg: ModelConfig, gcfg: GraphConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg, self.gcfg = cfg, gcfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)

    def encode(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> Seq2SeqState:
        """x: (B, T_in, rows, cols, C) → state after the last input frame,
        on the mesh of the inputs (criterion: max over the input frames)."""
        cfg, gcfg = self.cfg, self.gcfg
        if x.shape[1] != cfg.input_timesteps:
            raise ValueError(f"expected {cfg.input_timesteps} input frames, got {x.shape[1]}")
        b = x.shape[0]
        zeros = tuple(
            torch.zeros((b, gcfg.n_max, cfg.hidden_size), device=x.device)
            for _ in range(cfg.n_layers)
        )
        graph, data = image_to_graph(add_positional_encoding(x.float()), gcfg, mask=mask)
        hidden, cell = zeros, zeros
        for t in range(cfg.input_timesteps):
            hidden, cell = self.encoder(data[:, t], graph, hidden, cell)
        # decoder seed [value, pos_x, pos_y, node_size]: slices, not an index
        # list, whose backward would scatter
        last = data[:, -1]
        return Seq2SeqState(graph=graph, x=torch.cat([last[..., :1], last[..., -3:]], dim=-1),
                            hidden=hidden, cell=cell)

    def decode(
        self,
        state: Seq2SeqState,
        n_steps: int,
        y: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        teacher_forcing_ratio: float = 0.0,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[Seq2SeqState, torch.Tensor, torch.Tensor]:
        """Roll out ``n_steps`` frames, remeshing after each.

        Scheduled sampling: with ``teacher_forcing_ratio`` > 0, one coin per
        sample and step, drawn from ``generator``, decides whether the next
        mesh and input are built from the true frame ``y[:, t]`` (B, n_steps,
        rows, cols, 1) instead of the prediction.

        Returns (state, y_hat (B, n_steps, rows, cols, 1), pixel_nodes
        (n_steps, B, P) — the mesh each step ran on)."""
        shape = self.gcfg.image_shape
        forcing = teacher_forcing_ratio > 0.0
        if forcing and (y is None or generator is None):
            raise ValueError("teacher forcing needs the targets y and a generator")
        frames, meshes = [], []
        for t in range(n_steps):
            graph = state.graph
            output, hidden, cell = self.decoder(
                state.x, graph, state.x[..., :1], state.hidden, state.cell, generator
            )
            y_hat_t = unflatten(output, graph, shape, fill=0.0)  # (B, rows, cols, 1)
            frames.append(y_hat_t)
            meshes.append(graph.pixel_node)

            base = y_hat_t
            if forcing:
                coin = torch.rand(y_hat_t.shape[0], generator=generator,
                                  device=y_hat_t.device) < teacher_forcing_ratio
                base = torch.where(coin[:, None, None, None], y[:, t].to(y_hat_t.dtype), y_hat_t)
            new_graph, data = image_to_graph(
                add_positional_encoding(base[:, None]), self.gcfg, mask=mask
            )
            # running max overflow across the rollout
            new_graph = new_graph.replace(
                overflow=torch.maximum(new_graph.overflow, graph.overflow)
            )
            state = Seq2SeqState(
                graph=new_graph,
                x=data[:, 0],
                hidden=_transfer_state(hidden, graph, new_graph, shape),
                cell=_transfer_state(cell, graph, new_graph, shape),
            )
        return state, torch.stack(frames, dim=1), torch.stack(meshes)

    def rollout(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None):
        """(y_hat, final state, per-step pixel_node maps) for inputs x."""
        state = self.encode(x, mask=mask)
        state, y_hat, meshes = self.decode(state, self.cfg.output_timesteps, mask=mask)
        return y_hat, state, meshes

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rollout(x, mask=mask)[0]
