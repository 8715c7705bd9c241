"""Configuration dataclasses (PyTorch port).

Own copy of ``quadtree_mpnnlstm_tpu/config.py``: every field of its three
dataclasses, with the JAX package's defaults and meanings
(``tests/test_torch_config_fields.py`` holds them field for field). The
backend knobs run in the port too: the ``"csum"`` adjacency, the CSR
degree cap ``max_degree``, bf16 aggregation messages (``message_dtype``)
and shared-mesh batched training (``TrainConfig.shared_mesh``);
``grid_attn`` is checked and the port launches its grid attention kernels
for either value. ``ModelConfig.concat_layers_dim`` and
``TrainConfig.lr_decay_every_epochs``, ``clip_norm`` and
``teacher_forcing_ratio`` are read by neither package's predictor (which
keep StepLR every 3 epochs, a clip at 10 and their own
``teacher_forcing_ratio`` argument). Per-step remat is not a config field
either: as in the JAX package it is an argument of ``Seq2Seq``
(``remat=``, ``model_kwargs["remat"]`` on the predictor).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

CONDITIONS = (
    "max_larger_than",
    "max_smaller_than",
    "min_larger_than",
    "min_smaller_than",
)

NEG_INF = float("-inf")


def _is_power_of_two(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    """Static-shape description of the quadtree graph program.

    Every graph tensor has a fixed capacity: ``n_max`` node slots and
    ``e_max`` directed-edge slots, with validity masks, so meshes of a batch
    stack into one tensor and overflow is counted instead of reshaping.

    Attributes:
      image_shape: (rows, cols) of the field.
      max_grid_size: base-grid cell size, power of two.
      thresh: split threshold.
      condition: split criterion name.
      padding: extra halo when evaluating split criteria.
      edges_at_corners: 8-neighbour adjacency.
      use_edge_attrs: (bearing, distance) edge attributes vs distance alone.
      resolution: physical size of one pixel.
      n_max / e_max: node / edge capacities (default: exact worst cases).
      node_budget: coarsen the finest level until the mesh has at most
        this many nodes (None = unbounded).
      aggregation: ``"pallas"`` packs the per-tile Â blocks that the SpMM
        kernels read (the name is kept from the JAX package); ``"xla"``
        keeps the gather → scale → scatter edge-list path (ops/segment.py;
        on the pixelwise mesh ``thresh=-inf`` the nodes are the unmasked
        pixels in raster order); ``"grid"`` is the pixelwise mesh as an
        identity-mapped raster with shift-stencil aggregation
        (ops/grid.py), ``n_max = rows·cols``.
      agg_nt / agg_eb / agg_sw: node-tile rows, edge-window slots and
        source-window rows of the Â blocks (or attention windows).
      attn_windows: with ``aggregation="pallas"``, pack the per-tile
        attention windows that the TransformerConv kernels read
        (ops/attn.py) instead of the Â blocks.
      carry_edges: keep the edge list on built graphs; with Â blocks or
        attention windows the convolutions never read it after the build.
      max_degree: the CSR degree cap of the edge-list aggregation (the
        JAX package's ``ops/csr.py`` backend): 0 (the default, None) is
        off; above 0 each node sums at most its first ``max_degree``
        incoming edges (and a gather's backward its first ``max_degree``
        outgoing ones, in source-sorted order), and the edges ranked past
        the cap on the worse side are counted into ``overflow``
        (``graph/build.py``, ``ops/segment.py``).
      grid_attn: ``"xla"`` or ``"pallas"``, the JAX package's choice of
        its grid-attention chain or kernel; the port launches its grid
        attention kernels (ops/grid_attn.py) for either value.
      message_dtype: ``"float32"`` or ``"bfloat16"``: with bf16 the
        per-edge messages of the edge-list ``Â z`` (GCN/Cheb on
        ``aggregation="xla"``) are cast to bf16, summed (kernel K7's bf16
        instance on a card: f32 sums, each output rounded once) and cast
        back to the compute dtype.
      adjacency: the adjacency builder, ``"sort"`` (the default, a sort
        of the shifted pixel pairs) or ``"csum"`` (sort-free: each cell
        pair emitted once from a canonical boundary pixel and packed by a
        counting scatter, ``graph/adjacency.py``
        ``build_adjacency_canonical``; quadtree meshes with 4-neighbour
        edges only, else the build takes ``"sort"``).
      debug_overflow: raise ``RuntimeError`` from the build when a mesh
        dropped nodes, edges or window slots; it reads the overflow
        counter on the host, so only a build with the flag on syncs.
    """

    image_shape: Tuple[int, int]
    max_grid_size: int = 8
    thresh: float = 0.05
    condition: str = "max_larger_than"
    padding: int = 0
    edges_at_corners: bool = False
    use_edge_attrs: bool = True
    resolution: float = 0.25
    n_max: Optional[int] = None
    e_max: Optional[int] = None
    max_degree: Optional[int] = None
    node_budget: Optional[int] = None
    aggregation: str = "xla"
    agg_nt: int = 128
    agg_eb: int = 1024
    agg_sw: int = 512
    attn_windows: bool = False
    grid_attn: str = "xla"
    message_dtype: str = "float32"
    debug_overflow: bool = False
    carry_edges: bool = True
    adjacency: str = "sort"

    def __post_init__(self):
        if not _is_power_of_two(self.max_grid_size):
            raise ValueError(
                f"max_grid_size must be a power of two, got {self.max_grid_size}"
            )
        if self.condition not in CONDITIONS:
            raise ValueError(f"unknown condition {self.condition!r}")
        if self.aggregation not in ("xla", "pallas", "grid"):
            raise ValueError(f"unknown aggregation {self.aggregation!r}")
        if self.grid_attn not in ("xla", "pallas"):
            raise ValueError(f"unknown grid_attn {self.grid_attn!r}; expected 'xla' or 'pallas'")
        if self.message_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown message_dtype {self.message_dtype!r}; expected "
                             "'float32' or 'bfloat16'")
        if self.aggregation == "grid":
            if not self.pixelwise:
                raise ValueError("aggregation='grid' needs the pixelwise mesh (thresh=-inf); "
                                 "quadtree meshes use 'xla' or 'pallas'")
            if self.n_max not in (None, self.num_pixels):
                raise ValueError("grid aggregation uses the identity node mapping: n_max must be "
                                 f"rows*cols={self.num_pixels}, got {self.n_max}")
        elif self.pixelwise and self.aggregation == "pallas":
            raise ValueError("the pixelwise mesh runs as an edge list (aggregation='xla') or "
                             "a grid ('grid'); its Â blocks are not ported")
        if self.adjacency not in ("sort", "csum"):
            raise ValueError(f"unknown adjacency {self.adjacency!r}")
        if self.attn_windows and self.aggregation != "pallas":
            raise ValueError("attn_windows=True needs aggregation='pallas'")
        if not self.carry_edges and self.aggregation != "pallas":
            raise ValueError("carry_edges=False needs aggregation='pallas'")
        if self.n_max is None:
            object.__setattr__(self, "n_max", self.num_pixels)
        if self.e_max is None:
            object.__setattr__(self, "e_max", self.num_pixels * self.num_dirs)
        if self.max_degree is None:  # the CSR cap is opt-in, as in the JAX package
            object.__setattr__(self, "max_degree", 0)
        if (isinstance(self.max_degree, bool) or not isinstance(self.max_degree, int)
                or self.max_degree < 0):
            raise ValueError(f"max_degree must be an int >= 0, got {self.max_degree!r}")

    @property
    def rows(self) -> int:
        return self.image_shape[0]

    @property
    def cols(self) -> int:
        return self.image_shape[1]

    @property
    def num_pixels(self) -> int:
        return self.rows * self.cols

    @property
    def num_dirs(self) -> int:
        return 8 if self.edges_at_corners else 4

    @property
    def depth(self) -> int:
        """Number of split levels: cells go max_grid_size → 1."""
        return int(math.log2(self.max_grid_size))

    @property
    def padded_shape(self) -> Tuple[int, int]:
        g = self.max_grid_size
        return (-(-self.rows // g) * g, -(-self.cols // g) * g)

    @property
    def pixelwise(self) -> bool:
        return self.thresh == NEG_INF

    @property
    def degree_bound(self) -> int:
        """Provable per-node degree bound: a size-s cell has at most s
        neighbours a side (+ its self-loop, + corner cells with 8-neighbour
        edges); the pixelwise mesh has degree 4 (8 with corners)."""
        if self.pixelwise:
            deg = 8 if self.edges_at_corners else 4
        else:
            deg = 4 * self.max_grid_size + 5
            if self.edges_at_corners:
                deg += 4
        return min(deg, self.e_max)

    @property
    def edge_dim(self) -> int:
        return 2 if self.use_edge_attrs else 1

    def replace(self, **kw) -> "GraphConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Seq2Seq architecture hyper-parameters.

    ``input_features`` counts raw channels only; positional encoding (2)
    and node size (1) are appended internally. The port runs every conv
    of the JAX package's registry (``models/conv.py`` ``CONVOLUTIONS``)
    and every cell (``rnn_type``: LSTM, GRU, SimpleLSTM, SplitLSTM,
    Dummy). On quadtree meshes the decoder remeshes after every
    ``remesh_every``-th step and ``remesh_input`` remeshes the encoder onto
    each input frame; the pixelwise mesh and a preset mesh stay fixed.
    ``debug_nan`` raises ``ValueError`` naming the module (and decoder
    step) whose output first went non-finite, with a host sync at each
    check. ``dummy=True`` skips the recurrence
    (the decoder runs only its head). LSTM and GRU take ``fused_gates``:
    False keeps the JAX package's per-gate parameter layout
    (``models/fused.py``); GATConv and GATv2Conv always take it.
    :class:`~quadtree_mpnnlstm_tpu_torch.models.seq2seq.Seq2Seq` rejects
    a ``Dummy`` conv, whose identity head gives no one-channel frame (the
    JAX package's Seq2Seq fails on it too). GCNConv and ChebConv run on
    quadtree Â blocks (``aggregation="pallas"``), quadtree or pixelwise edge lists
    (``"xla"``) and the pixelwise grid (``"grid"``); TransformerConv and
    MHTransformerConv on quadtree attention windows (``"pallas"``), edge
    lists and the grid; GATConv and GATv2Conv on edge lists only (with
    ``"pallas"`` the quadtree keeps its edge list; the predictor takes
    ``"grid"`` to ``"xla"``, as the JAX predictor does).
    ``compute_dtype="bfloat16"`` is mixed precision: the graph pipeline,
    the convolutions and the recurrence run in bf16, the master parameters
    stay float32 and are cast at use, and LayerNorm statistics, the
    predictions leaving the model and the loss are float32. It runs every
    one of those convs and cells on every one of those meshes, fused or
    per-gate. ``dropout`` is the decoder head's; attention convolutions
    drop attention weights at their own fixed rate (``models/conv.py``
    ``CONVOLUTION_KWARGS``).
    """

    hidden_size: int = 32
    dropout: float = 0.1  # decoder head, training mode only
    input_features: int = 1
    input_timesteps: int = 3
    output_timesteps: int = 5
    n_layers: int = 1
    n_conv_layers: int = 3
    convolution_type: str = "GCNConv"  # the JAX package's default
    rnn_type: str = "LSTM"
    binary: bool = False
    dummy: bool = False
    remesh_input: bool = False
    remesh_every: int = 1
    concat_layers_dim: int = 1  # read by neither package's model
    fused_gates: bool = True
    debug_nan: bool = False
    compute_dtype: str = "float32"

    def __post_init__(self):
        if (isinstance(self.remesh_every, bool) or not isinstance(self.remesh_every, int)
                or self.remesh_every < 1):
            raise ValueError(f"ModelConfig.remesh_every must be a positive int, got "
                             f"{self.remesh_every!r}")

    @property
    def cdtype(self) -> torch.dtype:
        """The compute dtype as a torch dtype."""
        return {"float32": torch.float32, "bfloat16": torch.bfloat16}[self.compute_dtype]

    @property
    def node_input_features(self) -> int:
        # +2 positional encoding +1 node size
        return self.input_features + 3

    @property
    def uses_edge_attrs(self) -> bool:
        # Only attention convs consume 2-dim edge attributes.
        return self.convolution_type in (
            "MHTransformerConv",
            "TransformerConv",
            "GATConv",
        )

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Defaults of ``NextFramePredictorS2S.train`` when the predictor is
    given one: Adam at ``lr`` decayed by ``lr_decay`` every 3 epochs;
    ``truncated_backprop`` is the decoder chunk length (0 = full BPTT);
    ``dtype`` is the model's compute dtype when the predictor is given no
    ``compute_dtype`` (``"bfloat16"``: mixed precision, float32 masters).

    ``shared_mesh`` (read by the predictor unless its ``shared_mesh``
    argument says otherwise): the whole batch of a training step rides one
    mesh per step, built from the max over the batch of the split
    criterion (over the batch and the input frames in the encoder); the
    batch draws one scheduled-sampling coin a step. Eval and ``predict``
    stay per-sample (``models/seq2seq.py``). ``lr_decay_every_epochs``,
    ``clip_norm`` and ``teacher_forcing_ratio`` carry the JAX package's
    values and are read by neither package's predictor."""

    lr: float = 0.01
    lr_decay: float = 0.95
    lr_decay_every_epochs: int = 3
    n_epochs: int = 20
    clip_norm: float = 10.0
    teacher_forcing_ratio: float = 0.0
    truncated_backprop: int = 0
    seed: int = 21
    dtype: str = "float32"
    shared_mesh: bool = False

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
