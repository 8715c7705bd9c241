"""Graph seq2seq encoder–decoder with per-step remeshing.

Counterpart of ``quadtree_mpnnlstm_tpu/models/seq2seq.py``: the fixed-mesh
encoder and the decoder rollout (a remesh every ``remesh_every`` steps on
quadtree meshes, one fixed mesh when every pixel is a node, as an edge
list or a grid, or when a preset mesh is given), the ``remesh_input``
encoder, for inference and training. The JAX package runs both as ``nn.scan``s vmapped
over samples; here they are Python loops over time with an explicit batch
axis, each sample on its own mesh, or, with a shared mesh, the whole batch
on one.

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
  * on quadtree meshes a remesh due after the last decoder step runs too,
    and the mesh overflow is a running max over the whole rollout;
  * on a mesh a step keeps (the pixelwise mesh, a preset, a quadtree step
    between remeshes) the next input is ``[prediction, pos_x, pos_y,
    node_size]`` on the same mesh, and a teacher-forced step appends the
    *raw pixel count* as the size channel, not the mesh's own.

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
Cells: ``rnn_type`` picks ``models/cells.py`` ``RNN_CELLS`` (LSTM, GRU,
SimpleLSTM, SplitLSTM, Dummy); only LSTM and GRU take ``fused_gates``, and
the GRU's state has no cell norm (its C passes through). ``dummy=True``
(the JAX package's ablation) skips the recurrence: the encoder returns
the state it was given and the decoder runs only its head on ``[x ‖
concat]``, with no tanh and no residual. On an edge-list mesh the GAT
convolutions' self-loop list (``models/conv.py`` ``with_self_loops``) is
built once per mesh, with the mesh.

Remeshing modes: the decoder remeshes after step ``t`` (global, from
``decode``'s ``t0``) when ``(t + 1) % remesh_every == 0``; on the other
steps it keeps the mesh and takes ``[prediction, pos_x, pos_y,
node_size]`` (a teacher-forced step the true frame with the raw pixel
count) as its next input, with the current value as the concat channel.
``remesh_input`` builds the first encoder mesh from input frame 0 alone;
each encoder step then remeshes onto the next frame and carries (H, C)
through pixel space, and the last step keeps its mesh (the JAX package's
documented deviation: the reference reads one frame past the end). The
overflow is a running max. Under ``"mesh"`` remat the encoder's new
meshes are built outside the replay, as the decoder's are. A preset mesh
(``graph_structure``: one mesh, ``graph/static.py``) replaces the
encoder's mesh for every sample; its size channel is ``counts /
(PRESET_NODE_SIZE_BASE / 2)²`` = ``counts / 4``, not the builder's (the
reference hard-codes the base cell 4), and its tensors ride
the batch as views (``expand_graph``, once per preset and batch size).
``high_interest_region`` reaches every mesh build.

``ModelConfig.debug_nan`` (``check_finite``) checks the encoder input,
every encoder step's hidden state and every decoder step's output and
raises ``ValueError`` naming the module (and the step ``t``), with the
JAX package's messages; each check syncs with the host, and without the
flag nothing is checked.

Shared mesh (``encode(..., shared_mesh=True)``, the JAX package's
``TrainConfig.shared_mesh``; the predictor turns it on for training only):
the whole batch rides one mesh a step. The encoder builds it from the max
of the split criterion over every sample and input frame (the JAX
package's batch of T·B frames), each ``remesh_input`` step from the next
frame of every sample, and each decoder remesh from the B frames of the
step; a preset mesh is one mesh anyway. The batch draws one
scheduled-sampling coin a step, so the frame a mesh is built from is the
batch's. The mesh is built once (kernel K1 once a build, not B times) as
a graph of batch 1 and then stands in for the batch as views
(``graph/static.py`` ``expand_graph``): node tensors keep the (B, n_max,
F) layout, and the Â-block and attention kernels read the one mesh's
metadata for every sample. The JAX package moves node tensors to a
batch-middle (n_max, B, F) layout and folds the batch into the features
or heads of each aggregation; each sample's results are the same sums in
the same order. Every remat mode, TBPTT chunk, remesh mode, region and
debug mode composes with it, as in the JAX package.
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
from quadtree_mpnnlstm_tpu_torch.graph.static import expand_graph
from quadtree_mpnnlstm_tpu_torch.models.cells import RNN_CELLS
from quadtree_mpnnlstm_tpu_torch.models.conv import CONVOLUTIONS, make_conv, with_self_loops
from quadtree_mpnnlstm_tpu_torch.utils.posenc import add_positional_encoding


@dataclasses.dataclass
class Seq2SeqState:
    """Rollout state: current meshes, node input, per-layer recurrent state."""

    graph: GraphTensors
    x: torch.Tensor                   # (B, n_max, F) current node input
    hidden: Tuple[torch.Tensor, ...]  # n_layers × (B, n_max, hidden)
    cell: Tuple[torch.Tensor, ...]    # n_layers × (B, n_max, hidden)
    shared: bool = False              # one mesh for the whole batch


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


GAT_CONVS = ("GATConv", "GATv2Conv")
PRESET_NODE_SIZE_BASE = 4  # the base cell a preset mesh's size channel divides by


def _check_supported(cfg: ModelConfig) -> None:
    supported = dict(convolution_type=tuple(CONVOLUTIONS), rnn_type=tuple(RNN_CELLS),
                     fused_gates=(True, False), compute_dtype=("float32", "bfloat16"))
    for field, values in supported.items():
        if getattr(cfg, field) not in values:
            raise ValueError(
                f"ModelConfig.{field}={getattr(cfg, field)!r} is not ported"
                f"; this path runs {field} in {values!r}"
            )
    if cfg.convolution_type == "Dummy":
        raise ValueError("ModelConfig.convolution_type='Dummy' makes every conv the identity: "
                         "the gates then need inputs as wide as the hidden state and the head "
                         "returns hidden_size + 1 channels, not one frame (the JAX package's "
                         "Seq2Seq fails on it too); GraphConv('Dummy') runs inside cells")
    if not 0.0 <= cfg.dropout < 1.0:
        raise ValueError(f"ModelConfig.dropout={cfg.dropout!r} must lie in [0, 1)")


def _make_cells(module: nn.Module, cfg: ModelConfig, in_channels: int, n_conv_layers: int,
                attr_dim: int) -> None:
    hidden = cfg.hidden_size
    kw = dict(fused_gates=cfg.fused_gates) if cfg.rnn_type in ("LSTM", "GRU") else {}
    for i in range(cfg.n_layers):
        module.add_module(
            f"rnn_{i}", RNN_CELLS[cfg.rnn_type](in_channels if i == 0 else hidden, hidden,
                                                n_conv_layers, cfg.convolution_type,
                                                dtype=cfg.cdtype, attr_dim=attr_dim, **kw)
        )


class Encoder(nn.Module):
    """One encoder timestep over stacked cells; with ``dummy`` the identity
    on the state (no cells, no norms)."""

    def __init__(self, cfg: ModelConfig, attr_dim: int = 2):
        super().__init__()
        self.n_layers, self.dummy = cfg.n_layers, cfg.dummy
        self.norm_cell = cfg.rnn_type != "GRU"  # a GRU's C passes through unnormalised
        if cfg.dummy:
            return
        h = cfg.hidden_size
        _make_cells(self, cfg, cfg.node_input_features, cfg.n_conv_layers, attr_dim)
        self.norm_h = LayerNorm(h)
        if self.norm_cell:
            self.norm_c = LayerNorm(h)

    def rnn(self, i: int) -> nn.Module:
        return getattr(self, f"rnn_{i}")

    def _norm(self, h, c):
        return self.norm_h(h), (self.norm_c(c) if self.norm_cell else c)

    def forward(self, x_t, graph, prev_hidden, prev_cell, generator=None):
        if self.dummy:
            return prev_hidden, prev_cell
        # Layer 0 consumes the previous timestep's TOP layer state.
        _, h, c = self.rnn(0)(x_t, graph, prev_hidden[-1], prev_cell[-1], generator)
        h, c = self._norm(h, c)
        hs, cs = [h], [c]
        zero = torch.zeros_like(hs[0])
        for i in range(1, self.n_layers):
            _, h, c = self.rnn(i)(hs[-1], graph, zero, zero, generator)
            h, c = self._norm(h, c)
            hs.append(h)
            cs.append(c)
        return tuple(hs), tuple(cs)


class Decoder(nn.Module):
    """One decoder timestep + output head. ``concat_channels`` (0 or 1) is
    the width of the channel the head appends to the top output. With
    ``dummy`` only the head runs, on ``[x ‖ concat]``, with no tanh and no
    residual."""

    def __init__(self, cfg: ModelConfig, concat_channels: int = 1, attr_dim: int = 2):
        super().__init__()
        self.n_layers = cfg.n_layers
        self.binary, self.dummy = cfg.binary, cfg.dummy
        self.dropout = cfg.dropout
        self.norm_cell = cfg.rnn_type != "GRU"
        h = cfg.hidden_size
        # decoder input is [value, pos_x, pos_y, node_size]; conv stacks are
        # 1 layer deep. The top output is the cells' (hidden wide), or the
        # input itself where one Dummy cell passes it through.
        x_width = 4
        out_width = x_width if cfg.rnn_type == "Dummy" and cfg.n_layers == 1 else h
        if cfg.dummy:
            out_width = x_width
        else:
            _make_cells(self, cfg, x_width, 1, attr_dim)
        head = partial(make_conv, cfg.convolution_type, attr_dim=attr_dim, dtype=cfg.cdtype)
        self.fc_out1 = head(out_width + concat_channels, h)
        self.fc_out2 = head(h, 1)
        if not cfg.dummy:
            self.norm_o = LayerNorm(out_width)
            self.norm_h = LayerNorm(h)
            if self.norm_cell:
                self.norm_c = LayerNorm(h)

    def rnn(self, i: int) -> nn.Module:
        return getattr(self, f"rnn_{i}")

    def _norm(self, h, c):
        return self.norm_h(h), (self.norm_c(c) if self.norm_cell else c)

    def _head(self, output, graph, generator):
        output = self.fc_out1(output, graph, generator)
        output = self.fc_out2(torch.relu(output), graph, generator)
        return dropout(output, self.dropout, self.training, generator)

    def forward(self, x, graph, concat, hidden, cell, generator=None):
        if self.dummy:
            inp = x if concat is None else torch.cat([x, concat.to(x.dtype)], dim=-1)
            return self._head(inp, graph, generator), hidden, cell
        out, h, c = self.rnn(0)(x, graph, hidden[0], cell[0], generator)
        h, c = self._norm(h, c)
        hs, cs = [h], [c]
        for i in range(1, self.n_layers):
            out, h, c = self.rnn(i)(hs[-1], graph, hidden[i], cell[i], generator)
            h, c = self._norm(h, c)
            hs.append(h)
            cs.append(c)
        output = torch.relu(self.norm_o(out))
        if concat is not None:
            output = torch.cat([output, concat], dim=-1)
        output = self._head(output, graph, generator)
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
    (``graph/quadtree.py`` ``decompose_levels``). ``check_finite``
    (``cfg.debug_nan`` unless set) turns the NaN checks on."""

    def __init__(self, cfg: ModelConfig, gcfg: GraphConfig, use_climatology: bool = False,
                 remat=True, transform_func: Optional[Callable] = None):
        super().__init__()
        _check_supported(cfg)
        self.cfg, self.gcfg = cfg, gcfg
        self.use_climatology = use_climatology
        self.remat = remat_mode(remat)
        self.transform_func = transform_func
        self.check_finite = cfg.debug_nan
        self.remeshing = not gcfg.pixelwise
        self.self_loops = cfg.convolution_type in GAT_CONVS and gcfg.aggregation != "grid"
        self.encoder = Encoder(cfg, gcfg.edge_dim)
        self.decoder = Decoder(cfg, concat_channels=int(use_climatology or self.remeshing),
                               attr_dim=gcfg.edge_dim)
        # (preset graph, batch size, its graph for that batch)
        self._preset_cache = None

    def _graph(self, frames: torch.Tensor, mask: Optional[torch.Tensor],
               hir: Optional[torch.Tensor] = None, shared: bool = False):
        """(graph, node features (B, T, n_max, C + 1)) of ``frames`` (B, T,
        rows, cols, C), with the GAT convolutions' self-loop list where the
        model has them. ``shared``: one mesh from the B·T frames (the
        criterion's max over all of them), built as a graph of batch 1 and
        expanded to the batch."""
        b, t = frames.shape[:2]
        if shared:
            frames = frames.reshape((1, b * t) + frames.shape[2:])
        graph, data = image_to_graph(add_positional_encoding(frames), self.gcfg, mask=mask,
                                     high_interest_region=hir,
                                     transform_func=self.transform_func)
        if self.self_loops:
            graph = graph.replace(self_loops=with_self_loops(graph))
        if shared:
            graph = expand_graph(graph, b)
            data = data.reshape((b, t) + data.shape[2:])
        return graph, data

    def _preset(self, graph_structure: GraphTensors, b: int, device) -> GraphTensors:
        """The preset mesh as the graph of a batch of ``b`` (views of its
        tensors), with its self-loop list where the model has one; built
        once per preset and batch size."""
        cached = self._preset_cache
        if cached is not None and cached[0] is graph_structure and cached[1] == b:
            return cached[2]
        gcfg = self.gcfg
        e_max = None if graph_structure.edge_src is None else graph_structure.edge_src.shape[-1]
        if graph_structure.n_max != gcfg.n_max or e_max not in (None, gcfg.e_max):
            raise ValueError(f"the preset mesh has n_max={graph_structure.n_max}, "
                             f"e_max={e_max}; the model's GraphConfig has n_max={gcfg.n_max}, "
                             f"e_max={gcfg.e_max}: build the preset with the model's capacities")
        if graph_structure.pixel_node.shape[-1] != gcfg.num_pixels:
            raise ValueError(f"the preset mesh maps {graph_structure.pixel_node.shape[-1]} "
                             f"pixels; the model's image has {gcfg.num_pixels}")
        if graph_structure.pixel_node.device != torch.device(device):
            raise ValueError(f"the preset mesh lives on {graph_structure.pixel_node.device}, "
                             f"the inputs on {device}: build it on the model's device")
        graph = expand_graph(graph_structure, b)
        if self.self_loops:
            graph = graph.replace(self_loops=with_self_loops(graph))
        self._preset_cache = (graph_structure, b, graph)
        return graph

    def _check(self, tensors, message: str) -> None:
        """``debug_nan``: raise ``message`` unless every tensor is finite
        (one host sync)."""
        if self.check_finite and not bool(torch.stack([torch.isfinite(t).all()
                                                       for t in tensors]).all()):
            raise ValueError(message)

    def encode(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               high_interest_region: Optional[torch.Tensor] = None,
               graph_structure: Optional[GraphTensors] = None,
               shared_mesh: bool = False) -> Seq2SeqState:
        """x: (B, T_in, rows, cols, C) → state after the last input frame,
        on the mesh of the inputs (criterion: max over the input frames),
        on the preset ``graph_structure`` (one mesh for every sample), or
        with ``remesh_input`` on the mesh of the last frame.
        ``generator`` feeds the attention dropout in training mode.
        ``shared_mesh``: one mesh for the whole batch at every step (module
        docstring); the state carries the choice to ``decode``."""
        cfg, gcfg = self.cfg, self.gcfg
        if x.shape[1] != cfg.input_timesteps:
            raise ValueError(f"expected {cfg.input_timesteps} input frames, got {x.shape[1]}")
        b = x.shape[0]
        zeros = tuple(
            torch.zeros((b, gcfg.n_max, cfg.hidden_size), dtype=cfg.cdtype, device=x.device)
            for _ in range(cfg.n_layers)
        )
        self._check([x], "NaN in graph input x (module=encode; ref graph_functions.py:626)")
        # the compute-dtype boundary: the graph build, the node features and
        # the recurrence run in cfg.compute_dtype; decode() returns float32
        xc = x.to(cfg.cdtype)
        hir = high_interest_region
        if graph_structure is None and cfg.remesh_input:
            graph, data = self._graph(xc[:, :1], mask, hir, shared_mesh)
            state = Seq2SeqState(graph=graph, x=data[:, 0], hidden=zeros, cell=zeros,
                                 shared=shared_mesh)
            for t in range(cfg.input_timesteps):
                # frame t's step remeshes onto frame t + 1; the last keeps its mesh
                nxt = None if t == cfg.input_timesteps - 1 else xc[:, t + 1:t + 2]
                if self.remat == "mesh" and torch.is_grad_enabled():
                    hidden, cell = self._step(self._encoder_step, generator, state.x,
                                              state.graph, state.hidden, state.cell, True)
                    state = self._remesh_input(state, hidden, cell, nxt, mask, hir)
                else:
                    state = self._step(self._encoder_remesh_step, generator, state, nxt, mask,
                                       hir)
        else:
            if graph_structure is not None:
                graph = self._preset(graph_structure, b, x.device)
                flat = flatten(add_positional_encoding(xc), graph)  # (B, T, n_max, C + 2)
                sizes = graph.counts / ((PRESET_NODE_SIZE_BASE / 2.0) ** 2)
                sizes = sizes[:, None, :, None].expand(flat.shape[:-1] + (1,))
                data = torch.cat([flat, sizes.to(flat.dtype)], dim=-1)
            else:
                graph, data = self._graph(xc, mask, hir, shared_mesh)
            hidden, cell = zeros, zeros
            for t in range(cfg.input_timesteps):
                hidden, cell = self._step(self._encoder_step, generator, data[:, t], graph,
                                          hidden, cell)
            state = Seq2SeqState(graph=graph, x=data[:, -1], hidden=hidden, cell=cell,
                                 shared=shared_mesh)
        # decoder seed [value, pos_x, pos_y, node_size] of the last frame:
        # slices, not an index list, whose backward would scatter
        last = state.x
        return dataclasses.replace(state, x=torch.cat([last[..., :1], last[..., -3:]], dim=-1))

    def decode(
        self,
        state: Seq2SeqState,
        n_steps: int,
        y: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        teacher_forcing_ratio: float = 0.0,
        generator: Optional[torch.Generator] = None,
        climatology: Optional[torch.Tensor] = None,
        t0: int = 0,
        high_interest_region: Optional[torch.Tensor] = None,
    ) -> Tuple[Seq2SeqState, torch.Tensor, torch.Tensor]:
        """Roll out ``n_steps`` frames, steps ``t0`` … ``t0 + n_steps − 1``
        of the forecast (a truncated-BPTT chunk starts past 0); on quadtree
        meshes remesh after each step ``t`` with ``(t + 1) % remesh_every
        == 0``.

        Scheduled sampling: with ``teacher_forcing_ratio`` > 0, one coin per
        sample and step (one per step for the batch on a shared mesh),
        drawn from ``generator``, decides whether the next
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
        every = self.cfg.remesh_every
        for i in range(n_steps):
            t = t0 + i
            graph = state.graph
            if clim is None:
                concat = state.x[..., :1] if self.remeshing else None
            elif self.remeshing:
                concat = flatten(clim[:, i:i + 1], graph)[:, 0]
            else:
                concat = clim[:, i]
            y_t = None if y is None else y[:, i]
            remesh = self.remeshing and (t + 1) % every == 0
            step = (y_t, mask, teacher_forcing_ratio, remesh, high_interest_region)
            if self.remat == "mesh":
                output, hidden, cell = self._step(self._decoder_cell, generator, state, concat,
                                                  t)
                state, y_hat_t = self._advance(generator, state, output, hidden, cell, *step)
            else:
                state, y_hat_t = self._step(self._decoder_step, generator, state, concat, t,
                                            *step)
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

    def _encoder_step(self, generator, x_t, graph, hidden, cell, remesh_input=False):
        hidden, cell = self.encoder(x_t, graph, hidden, cell, generator)
        self._check(hidden, "non-finite hidden state in module=encoder ("
                    + ("remesh_input" if remesh_input else "fixed-mesh")
                    + " scan step); inputs or encoder weights went NaN")
        return hidden, cell

    def _encoder_remesh_step(self, generator, state, nxt, mask, hir) -> Seq2SeqState:
        """A ``remesh_input`` encoder step: the cells on the current frame's
        mesh, then the next frame's mesh (none after the last frame)."""
        hidden, cell = self._encoder_step(generator, state.x, state.graph, state.hidden,
                                          state.cell, True)
        return self._remesh_input(state, hidden, cell, nxt, mask, hir)

    def _remesh_input(self, state, hidden, cell, nxt, mask, hir) -> Seq2SeqState:
        """The state on the mesh of the next input frame ``nxt`` (B, 1,
        rows, cols, C), (H, C) carried through pixel space; the current
        mesh when there is no next frame."""
        if nxt is None:
            return dataclasses.replace(state, hidden=hidden, cell=cell)
        shape = self.gcfg.image_shape
        new_graph, data = self._graph(nxt, mask, hir, state.shared)
        new_graph = new_graph.replace(overflow=torch.maximum(new_graph.overflow,
                                                             state.graph.overflow))
        return Seq2SeqState(graph=new_graph, x=data[:, 0],
                            hidden=_transfer_state(hidden, state.graph, new_graph, shape),
                            cell=_transfer_state(cell, state.graph, new_graph, shape),
                            shared=state.shared)

    def _decoder_cell(self, generator, state, concat, t):
        """(output, hidden, cell) of the decoder's cells and head at step ``t``."""
        out = self.decoder(state.x, state.graph, concat, state.hidden, state.cell, generator)
        self._check([out[0]], f"non-finite output in module=decoder at rollout step t={t}")
        return out

    def _decoder_step(self, generator, state, concat, t, *step):
        return self._advance(generator, state, *self._decoder_cell(generator, state, concat, t),
                             *step)

    def _advance(self, generator, state, output, hidden, cell, y_t, mask,
                 teacher_forcing_ratio, remesh, hir) -> Tuple[Seq2SeqState, torch.Tensor]:
        """(next state, the frame (B, rows, cols, 1)) from a decoder
        output: with ``remesh`` the state on a new mesh, else the next
        input on the same mesh; with scheduled sampling, one coin per sample
        (per batch on a shared mesh) from ``generator`` picks the true frame
        ``y_t`` instead."""
        graph = state.graph
        y_hat_t = unflatten(output, graph, self.gcfg.image_shape, fill=0.0)
        coin = None
        if teacher_forcing_ratio > 0.0:
            coins = 1 if state.shared else y_hat_t.shape[0]
            coin = torch.rand(coins, generator=generator,
                              device=y_hat_t.device) < teacher_forcing_ratio
        if remesh:
            return self._remesh(state, y_hat_t, hidden, cell, coin, y_t, mask, hir), y_hat_t
        x_new = torch.cat([output, state.x[..., 1:]], dim=-1)
        if coin is not None:
            # the true frame on the same mesh, with the raw pixel count
            # (not the mesh's size channel) as its size channel
            teach = flatten(add_positional_encoding(y_t[:, None].to(output.dtype)), graph)[:, 0]
            x_teach = torch.cat([teach, graph.counts[..., None].to(output.dtype)], dim=-1)
            x_new = torch.where(coin[:, None, None], x_teach, x_new)
        return dataclasses.replace(state, x=x_new, hidden=hidden, cell=cell), y_hat_t

    def _remesh(self, state, y_hat_t, hidden, cell, coin, y_t, mask, hir) -> Seq2SeqState:
        """The next state on the mesh of the prediction (or, where the coin
        says so, of the true frame), with (H, C) carried through pixel
        space."""
        shape = self.gcfg.image_shape
        graph = state.graph
        base = y_hat_t
        if coin is not None:
            base = torch.where(coin[:, None, None, None], y_t.to(y_hat_t.dtype), y_hat_t)
        new_graph, data = self._graph(base[:, None], mask, hir, state.shared)
        # running max overflow across the rollout
        new_graph = new_graph.replace(overflow=torch.maximum(new_graph.overflow, graph.overflow))
        return Seq2SeqState(
            graph=new_graph,
            x=data[:, 0],
            hidden=_transfer_state(hidden, graph, new_graph, shape),
            cell=_transfer_state(cell, graph, new_graph, shape),
            shared=state.shared,
        )

    def rollout(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                climatology: Optional[torch.Tensor] = None,
                high_interest_region: Optional[torch.Tensor] = None,
                graph_structure: Optional[GraphTensors] = None):
        """(y_hat, final state, per-step pixel_node maps) for inputs x."""
        state = self.encode(x, mask=mask, high_interest_region=high_interest_region,
                            graph_structure=graph_structure)
        state, y_hat, meshes = self.decode(state, self.cfg.output_timesteps, mask=mask,
                                           climatology=climatology,
                                           high_interest_region=high_interest_region)
        return y_hat, state, meshes

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                climatology: Optional[torch.Tensor] = None,
                high_interest_region: Optional[torch.Tensor] = None,
                graph_structure: Optional[GraphTensors] = None) -> torch.Tensor:
        return self.rollout(x, mask=mask, climatology=climatology,
                            high_interest_region=high_interest_region,
                            graph_structure=graph_structure)[0]
