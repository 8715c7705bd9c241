"""Graph seq2seq encoder–decoder with per-step remeshing.

Counterpart of ``quadtree_mpnnlstm_tpu/models/seq2seq.py``: the fixed-mesh
encoder and the decoder rollout (a remesh at every step on quadtree meshes,
one fixed mesh when every pixel is a node, as an edge list or a grid),
for inference and training. The JAX package runs both as ``nn.scan``s vmapped
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
    last encoder frame;
  * the decoder's concat channel is the day's climatology with
    ``use_climatology``; else, on remeshing meshes, the current value at
    every step including t=0; else (pixelwise) there is none;
  * on quadtree meshes the remesh also runs after the last decoder step,
    and the mesh overflow is a running max over the whole rollout;
  * on the pixelwise mesh the next input is ``[prediction, pos_x, pos_y,
    node_size]`` on the same mesh, and a teacher-forced step appends the
    *raw pixel count* as the size channel, not ``resolution**2``.

``ModelConfig.compute_dtype="bfloat16"`` (every ported conv on every
mesh: Â blocks, attention windows, edge lists and the grid) casts the
inputs to bf16 before the positional encoding, as the JAX package's
compute boundary does; the graph build, node features,
convolutions, attention and recurrence then run in bf16 (f32 masters cast
at use), LayerNorm normalises in f32, and ``decode`` returns its frames in
f32.

Training mode (``model.train()``) turns on the decoder head's dropout and,
with TransformerConv, the attention dropout of every encoder and decoder
attention; ``decode`` takes a scheduled-sampling ratio. All of them draw
from the caller's ``torch.Generator`` only, never from torch's global
RNG, so a step is reproducible from its generator's seed.

Per-step remat (``remat``, the JAX package's ``Seq2Seq.remat`` and its
default): while gradients are recorded, every encoder step and every
decoder step (the cell and head, ``unflatten``, the coin and the remesh
with its state transfer) runs under non-reentrant
``torch.utils.checkpoint``, so a rollout keeps each step's inputs and not
its activations, and the backward replays the step. ``"mesh"`` checkpoints
only the decoder's cell and head: the next mesh, its pooled node features
and the state transfer are built once, outside, and their autograd
history (indices only) is kept, so the backward replays no mesh build
(``save_only_these_names("mesh")`` in the JAX package); their gradients
still flow into the prediction the mesh was built from. ``"dots"`` saves
the outputs of the matrix products (``aten.mm``/``addmm``/``bmm``/
``baddbmm``) in a selective checkpoint and replays the rest, the hand-
written kernels included (``dots_saveable``). A replay draws its dropout
masks and coins from a copy of the caller's generator set to the state
the forward started from, so it sees the forward's masks, and the
caller's generator advances only once. The replay launches the step's
kernels again (their launch counters count it) and repeats no host
synchronisation: the mesh build has none on a CUDA tensor.
``remesh_input``, preset meshes and the shared-mesh batched layout are not
ported.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from quadtree_mpnnlstm_tpu_torch.config import GraphConfig, ModelConfig
from quadtree_mpnnlstm_tpu_torch.graph.build import image_to_graph
from quadtree_mpnnlstm_tpu_torch.graph.state import GraphTensors, flatten, unflatten
from quadtree_mpnnlstm_tpu_torch.models.cells import GConvLSTM
from quadtree_mpnnlstm_tpu_torch.models.conv import CONVOLUTION_KWARGS, CONVOLUTIONS
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
    above f32 rounding once normalised, so the port uses the reference's.
    As flax's ``LayerNorm(dtype=…)``, the statistics and the normalisation
    run in float32 whatever the input's dtype, and the result is returned
    in the input's dtype (bf16 in a bf16 model)."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(x.dtype)


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


# the matrix products a "dots" replay keeps (jax.checkpoint_policies.dots_saveable)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default]


def remat_mode(remat) -> str:
    """``"full"``, ``"mesh"``, ``"dots"`` or ``"none"`` for a value of the
    JAX package's ``remat`` (True and False are ``"full"`` and
    ``"none"``)."""
    if isinstance(remat, bool):
        return "full" if remat else "none"
    if remat in ("full", "mesh", "dots", "none"):
        return remat
    raise ValueError(f"remat={remat!r}: expected one of True, False, 'full', 'mesh', 'dots', "
                     "'none'")


class _Replay:
    """The generator a checkpointed step draws from: the caller's on the
    forward, and on every recomputation a fresh generator set to the state
    the forward started from, so a replay draws the same masks and coins
    and leaves the caller's generator where the forward left it."""

    def __init__(self, generator: Optional[torch.Generator]):
        self.generator, self.calls = generator, 0
        self.state = None if generator is None else generator.get_state()

    def __call__(self) -> Optional[torch.Generator]:
        self.calls += 1
        if self.generator is None or self.calls == 1:
            return self.generator
        replay = torch.Generator(device=self.generator.device)
        replay.set_state(self.state)
        return replay


def _check_supported(cfg: ModelConfig) -> None:
    supported = dict(convolution_type=tuple(CONVOLUTIONS), rnn_type=("LSTM",),
                     fused_gates=(True, False), remesh_every=(1,),
                     compute_dtype=("float32", "bfloat16"))
    # the ROADMAP Queue 1 item that ports the other values
    item = dict(convolution_type=7, rnn_type=7, remesh_every=8)
    for field, values in supported.items():
        if getattr(cfg, field) not in values:
            raise ValueError(
                f"ModelConfig.{field}={getattr(cfg, field)!r} is not ported"
                + (f" (ROADMAP Queue 1 item {item[field]})" if field in item else "")
                + f"; this path runs {field} in {values!r}"
            )
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"ModelConfig.dropout={cfg.dropout!r} must lie in [0, 1)")


def _make_cells(module: nn.Module, cfg: ModelConfig, in_channels: int,
                n_conv_layers: int) -> None:
    hidden = cfg.hidden_size
    for i in range(cfg.n_layers):
        module.add_module(
            f"rnn_{i}", GConvLSTM(in_channels if i == 0 else hidden, hidden, n_conv_layers,
                                  cfg.convolution_type, dtype=cfg.cdtype,
                                  fused_gates=cfg.fused_gates)
        )


class Encoder(nn.Module):
    """One encoder timestep over stacked cells."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.n_layers = cfg.n_layers
        h = cfg.hidden_size
        _make_cells(self, cfg, cfg.node_input_features, cfg.n_conv_layers)
        self.norm_h = LayerNorm(h)
        self.norm_c = LayerNorm(h)

    def rnn(self, i: int) -> GConvLSTM:
        return getattr(self, f"rnn_{i}")

    def forward(self, x_t, graph, prev_hidden, prev_cell, generator=None):
        # Layer 0 consumes the previous timestep's TOP layer state.
        _, h, c = self.rnn(0)(x_t, graph, prev_hidden[-1], prev_cell[-1], generator)
        hs, cs = [self.norm_h(h)], [self.norm_c(c)]
        zero = torch.zeros_like(hs[0])
        for i in range(1, self.n_layers):
            _, h, c = self.rnn(i)(hs[-1], graph, zero, zero, generator)
            hs.append(self.norm_h(h))
            cs.append(self.norm_c(c))
        return tuple(hs), tuple(cs)


class Decoder(nn.Module):
    """One decoder timestep + output head. ``concat_channels`` (0 or 1) is
    the width of the channel the head appends to the top output."""

    def __init__(self, cfg: ModelConfig, concat_channels: int = 1):
        super().__init__()
        self.n_layers = cfg.n_layers
        self.binary = cfg.binary
        self.dropout = cfg.dropout
        h = cfg.hidden_size
        # decoder input is [value, pos_x, pos_y, node_size]; conv stacks are
        # 1 layer deep
        _make_cells(self, cfg, 4, 1)
        conv_cls = CONVOLUTIONS[cfg.convolution_type]
        kwargs = dict(CONVOLUTION_KWARGS[cfg.convolution_type], dtype=cfg.cdtype)
        self.fc_out1 = conv_cls(h + concat_channels, h, **kwargs)
        self.fc_out2 = conv_cls(h, 1, **kwargs)
        self.norm_o = LayerNorm(h)
        self.norm_h = LayerNorm(h)
        self.norm_c = LayerNorm(h)

    def rnn(self, i: int) -> GConvLSTM:
        return getattr(self, f"rnn_{i}")

    def forward(self, x, graph, concat, hidden, cell, generator=None):
        out, h, c = self.rnn(0)(x, graph, hidden[0], cell[0], generator)
        hs, cs = [self.norm_h(h)], [self.norm_c(c)]
        for i in range(1, self.n_layers):
            out, h, c = self.rnn(i)(hs[-1], graph, hidden[i], cell[i], generator)
            hs.append(self.norm_h(h))
            cs.append(self.norm_c(c))
        output = torch.relu(self.norm_o(out))
        if concat is not None:
            output = torch.cat([output, concat], dim=-1)
        output = self.fc_out1(output, graph, generator)
        output = self.fc_out2(torch.relu(output), graph, generator)
        output = dropout(output, self.dropout, self.training, generator)
        output = torch.tanh(output) + x[..., :1]  # residual on previous value
        if self.binary:
            output = torch.sigmoid(output)
        return output, tuple(hs), tuple(cs)


class Seq2Seq(nn.Module):
    """Full forecast model: ``forward(x)`` → (B, T_out, rows, cols, 1).
    With ``use_climatology`` the decoder's concat channel is the day's
    climatology, passed to ``decode``/``rollout`` as (B, T_out, rows,
    cols, 1). ``remat`` is the per-step remat mode (module docstring);
    ``transform_func`` transforms every mesh's split criterion
    (``graph/quadtree.py`` ``decompose_levels``)."""

    def __init__(self, cfg: ModelConfig, gcfg: GraphConfig, use_climatology: bool = False,
                 remat=True, transform_func: Optional[Callable] = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg, self.gcfg = cfg, gcfg
        self.use_climatology = use_climatology
        self.remat = remat_mode(remat)
        self.transform_func = transform_func
        self.remeshing = not gcfg.pixelwise
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg, concat_channels=int(use_climatology or self.remeshing))

    def encode(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> Seq2SeqState:
        """x: (B, T_in, rows, cols, C) → state after the last input frame,
        on the mesh of the inputs (criterion: max over the input frames).
        ``generator`` feeds the attention dropout in training mode."""
        cfg, gcfg = self.cfg, self.gcfg
        if x.shape[1] != cfg.input_timesteps:
            raise ValueError(f"expected {cfg.input_timesteps} input frames, got {x.shape[1]}")
        b = x.shape[0]
        zeros = tuple(
            torch.zeros((b, gcfg.n_max, cfg.hidden_size), dtype=cfg.cdtype, device=x.device)
            for _ in range(cfg.n_layers)
        )
        # the compute-dtype boundary: the graph build, the node features and
        # the recurrence run in cfg.compute_dtype; decode() returns float32
        graph, data = image_to_graph(add_positional_encoding(x.to(cfg.cdtype)), gcfg, mask=mask,
                                     transform_func=self.transform_func)
        hidden, cell = zeros, zeros
        for t in range(cfg.input_timesteps):
            hidden, cell = self._step(self._encoder_step, generator, data[:, t], graph, hidden,
                                      cell)
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
        climatology: Optional[torch.Tensor] = None,
    ) -> Tuple[Seq2SeqState, torch.Tensor, torch.Tensor]:
        """Roll out ``n_steps`` frames; on quadtree meshes remesh after each.

        Scheduled sampling: with ``teacher_forcing_ratio`` > 0, one coin per
        sample and step, drawn from ``generator``, decides whether the next
        input (and mesh) is built from the true frame ``y[:, t]`` (B,
        n_steps, rows, cols, 1) instead of the prediction. ``climatology``
        (B, n_steps, rows, cols, 1) feeds the concat channel when the model
        uses it (zeros when None).

        Returns (state, y_hat (B, n_steps, rows, cols, 1) float32,
        pixel_nodes (n_steps, B, P) — the mesh each step ran on)."""
        shape = self.gcfg.image_shape
        forcing = teacher_forcing_ratio > 0.0
        if forcing and (y is None or generator is None):
            raise ValueError("teacher forcing needs the targets y and a generator")
        clim = None
        if self.use_climatology:
            b = state.x.shape[0]
            if climatology is None:
                climatology = state.x.new_zeros((b, n_steps) + tuple(shape) + (1,))
            clim = climatology.to(state.x.dtype)
            if not self.remeshing:  # fixed mesh: flatten every step's once
                clim = flatten(clim, state.graph)
        frames, meshes = [], []
        for t in range(n_steps):
            graph = state.graph
            if clim is None:
                concat = state.x[..., :1] if self.remeshing else None
            elif self.remeshing:
                concat = flatten(clim[:, t:t + 1], graph)[:, 0]
            else:
                concat = clim[:, t]
            y_t = None if y is None else y[:, t]
            if self.remat == "mesh":
                output, hidden, cell = self._step(self._decoder_cell, generator, state, concat)
                state, y_hat_t = self._advance(generator, state, output, hidden, cell, y_t, mask,
                                               teacher_forcing_ratio)
            else:
                state, y_hat_t = self._step(self._decoder_step, generator, state, concat, y_t,
                                            mask, teacher_forcing_ratio)
            frames.append(y_hat_t)
            meshes.append(graph.pixel_node)
        # predictions leave the compute-dtype region in float32
        return state, torch.stack(frames, dim=1).float(), torch.stack(meshes)

    def _step(self, fn, generator, *args):
        """``fn(generator, *args)``: one encoder or decoder step, under
        per-step remat while gradients are recorded."""
        if self.remat == "none" or not torch.is_grad_enabled():
            return fn(generator, *args)
        replay = _Replay(generator)
        kw = {}
        if self.remat == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts, _DOTS)
        # no draw comes from torch's global generators
        return checkpoint(lambda *a: fn(replay(), *a), *args, use_reentrant=False,
                          preserve_rng_state=False, **kw)

    def _encoder_step(self, generator, x_t, graph, hidden, cell):
        return self.encoder(x_t, graph, hidden, cell, generator)

    def _decoder_cell(self, generator, state, concat):
        """(output, hidden, cell) of the decoder's cells and head."""
        return self.decoder(state.x, state.graph, concat, state.hidden, state.cell, generator)

    def _decoder_step(self, generator, state, concat, y_t, mask, teacher_forcing_ratio):
        return self._advance(generator, state, *self._decoder_cell(generator, state, concat),
                             y_t, mask, teacher_forcing_ratio)

    def _advance(self, generator, state, output, hidden, cell, y_t, mask,
                 teacher_forcing_ratio) -> Tuple[Seq2SeqState, torch.Tensor]:
        """(next state, the frame (B, rows, cols, 1)) from a decoder
        output: on quadtree meshes the remesh, else the next input on the
        same mesh; with scheduled sampling, one coin per sample from
        ``generator`` picks the true frame ``y_t`` instead."""
        graph = state.graph
        y_hat_t = unflatten(output, graph, self.gcfg.image_shape, fill=0.0)
        coin = None
        if teacher_forcing_ratio > 0.0:
            coin = torch.rand(y_hat_t.shape[0], generator=generator,
                              device=y_hat_t.device) < teacher_forcing_ratio
        if self.remeshing:
            return self._remesh(state, y_hat_t, hidden, cell, coin, y_t, mask), y_hat_t
        x_new = torch.cat([output, state.x[..., 1:]], dim=-1)
        if coin is not None:
            # the true frame on the same mesh, with the raw pixel count
            # (not resolution**2) as its size channel
            teach = flatten(add_positional_encoding(y_t[:, None].to(output.dtype)), graph)[:, 0]
            x_teach = torch.cat([teach, graph.counts[..., None].to(output.dtype)], dim=-1)
            x_new = torch.where(coin[:, None, None], x_teach, x_new)
        return Seq2SeqState(graph=graph, x=x_new, hidden=hidden, cell=cell), y_hat_t

    def _remesh(self, state, y_hat_t, hidden, cell, coin, y_t, mask) -> Seq2SeqState:
        """The next state on the mesh of the prediction (or, where the coin
        says so, of the true frame), with (H, C) carried through pixel
        space."""
        shape = self.gcfg.image_shape
        graph = state.graph
        base = y_hat_t
        if coin is not None:
            base = torch.where(coin[:, None, None, None], y_t.to(y_hat_t.dtype), y_hat_t)
        new_graph, data = image_to_graph(add_positional_encoding(base[:, None]), self.gcfg,
                                         mask=mask, transform_func=self.transform_func)
        # running max overflow across the rollout
        new_graph = new_graph.replace(overflow=torch.maximum(new_graph.overflow, graph.overflow))
        return Seq2SeqState(
            graph=new_graph,
            x=data[:, 0],
            hidden=_transfer_state(hidden, graph, new_graph, shape),
            cell=_transfer_state(cell, graph, new_graph, shape),
        )

    def rollout(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                climatology: Optional[torch.Tensor] = None):
        """(y_hat, final state, per-step pixel_node maps) for inputs x."""
        state = self.encode(x, mask=mask)
        state, y_hat, meshes = self.decode(state, self.cfg.output_timesteps, mask=mask,
                                           climatology=climatology)
        return y_hat, state, meshes

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                climatology: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.rollout(x, mask=mask, climatology=climatology)[0]
