"""Parameters: the port's seeded init and the bridge to and from flax trees.

``params_from_jax`` maps the flax parameter tree of the JAX package's
``Seq2Seq`` (nested dicts of numpy arrays, e.g. ``params/enc/encoder/
rnn_0/gates/w_x_0``) onto this package's ``Seq2Seq`` ``state_dict`` leaf
for leaf, for every conv and cell, in the fused or the per-gate gate
layout alike (``fused_gates=False``: vmapped ``conv_x``/``conv_h``
stacks, every leaf with a leading gate axis, as the JAX package's sea-ice
experiments train pixelwise meshes; GAT cells always); ``params_to_jax`` is
its inverse, so a port checkpoint loads into the JAX package's model of
the same layout. A flax ``OptimizedLSTMCell`` (``lstm/{ii,if,ig,io}/
kernel``, ``lstm/{hi,hf,hg,ho}/{kernel,bias}``) maps onto ``torch.nn.LSTM``'s
``weight_ih_l0`` and ``weight_hh_l0`` (gates i, f, g, o in both),
``bias_hh_l0`` and a zero ``bias_ih_l0``. ``fuse_cell_gates`` stacks a
per-gate LSTM or GRU cell of GCNConv, ChebConv, TransformerConv or
MHTransformerConv into the fused layout (``fuse_attn_gates`` and
``fuse_gcn_gates`` are its LSTM cases), for loading a per-gate tree into a
fused model (``params_from_jax(..., fuse_gates=True)``). They read numpy
arrays only. The baselines' trees (``models/mpnnlstm.py``: ``MPNNLSTM``'s
``convolution{i}``, ``bn{i}``, ``lstm{layer}``, ``lin1``, ``lin2``;
``MPNNLSTMI``'s ``recurrent{i}``, ``bn1``, ``lin1``, ``lin2``) map leaf for
leaf without the scans; a flax ``BatchNorm``'s ``batch_stats`` (no
running statistics are kept) is not read. The CNN-LSTM family's variables
(``models/cnnlstm.py``: ``CNNLSTMSeq2Seq``'s ``encoder``, ``decoder``,
``encoder_lstm``, ``decoder_lstm``; ``CNNLSTM``'s ``encoder``, ``lstm``,
``decoder``) map both ways with their ``batch_stats``
(:func:`cnnlstm_state_dict_from_jax`, :func:`cnnlstm_variables_to_jax`):
a conv's HWIO ``kernel`` is the OIHW ``weight``, each BatchNorm's running
``mean``/``var`` are its buffers of the same names, and the position
LSTMs' ``OptimizedLSTMCell`` s map as above.

``init_params`` is the port's own init with the JAX package's rules:
glorot-uniform with fan-in/fan-out on the last two axes of the stacked
gate weights (GCN and Chebyshev ``w_x_0``…, attention ``w_q_x_0``,
``w_e_1``, ``w_mix_0``…; leading axes are batch axes, as
``_glorot_batched``), on (in, out) of every Dense kernel (GCN's ``lin``,
``lin_0``…, ``lin_query``, ``lin_edge``, ``lin_skip``, ``lin_l``…, per gate
slice in the per-gate layout, as the flax vmap initialises each gate) and
on (heads, d) of GAT's ``att`` vectors; an LSTM's input kernels
lecun-normal and its recurrent kernels orthogonal, per gate; the
baselines' ``lin1``/``lin2`` (flax ``Dense``'s default) and the CNN
family's conv kernels (fan-in in · kh · kw) lecun-normal; zero biases and
peepholes; LayerNorm and BatchNorm scale 1, bias 0. It
draws from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_GATE_WEIGHT = re.compile(r"\.(gates|gates_zr|gate_candidate)\.w_[a-z0-9_]+$")
_LIN_WEIGHT = re.compile(r"\.lin(_[a-z0-9]+)?\.weight$")
_ATT = re.compile(r"\.att(_src|_dst|_edge)?$")
_NORM_WEIGHT = re.compile(r"(^|\.)(norm_[a-z]+|bn\d+)\.weight$")  # LayerNorm / BatchNorm
_HEAD_WEIGHT = re.compile(r"^lin\d+\.weight$")  # the baselines' flax Dense
_LSTM = re.compile(r"^lstm\d*$")  # an OptimizedLSTMCell's module name
_CONV = re.compile(r"^conv\d+$")  # a flax Conv of the CNN-LSTM family
_CONV_WEIGHT = re.compile(r"(^|\.)conv\d+\.weight$")
_LSTM_GATES = "ifgo"  # flax OptimizedLSTMCell and torch.nn.LSTM: i, f, g, o


def _glorot_(p: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(p.shape, generator=gen, dtype=torch.float32)
    p.copy_((2.0 * u - 1.0) * limit)


def _lecun_normal_(p: torch.Tensor, fan_in: int, gen: torch.Generator) -> None:
    """flax's lecun-normal: a normal truncated at ±2σ, rescaled to the
    variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    cpu = torch.empty(p.shape)
    nn.init.trunc_normal_(cpu, std=std, a=-2 * std, b=2 * std, generator=gen)
    p.copy_(cpu)


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> None:
    """Initialise every parameter of ``model`` in place from ``gen`` (a CPU
    generator; values are copied to the parameters' device)."""
    for name, p in model.named_parameters():
        if _GATE_WEIGHT.search(name) or _ATT.search(name):
            _glorot_(p, p.shape[-2], p.shape[-1], gen)
        elif name.endswith(".weight_ih_l0"):  # lecun-normal, per gate (4d, in)
            _lecun_normal_(p, p.shape[-1], gen)
        elif _HEAD_WEIGHT.search(name):  # torch (out, in) layout
            _lecun_normal_(p, p.shape[-1], gen)
        elif _CONV_WEIGHT.search(name) and p.ndim == 4:  # OIHW, fan-in I·kh·kw
            _lecun_normal_(p, p[0].numel(), gen)
        elif name.endswith(".weight_hh_l0"):  # orthogonal, per gate (d, d)
            cpu = torch.empty(p.shape)
            for gate in cpu.chunk(4):
                nn.init.orthogonal_(gate, generator=gen)
            p.copy_(cpu)
        elif _LIN_WEIGHT.search(name):  # torch (…, out, in) layout
            _glorot_(p, p.shape[-1], p.shape[-2], gen)
        elif _NORM_WEIGHT.search(name):
            p.fill_(1.0)
        else:
            p.zero_()


def _flat(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flat(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = np.asarray(v)
    return out


def _tensor(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Any flax sub-tree of the ported modules → the matching torch
    state_dict: ``kernel`` (…, in, out) → ``weight`` (…, out, in), LayerNorm
    ``scale`` → ``weight``, an ``OptimizedLSTMCell`` → ``torch.nn.LSTM``'s
    leaves, every other leaf by its own name."""
    out = {}
    for path, arr in _flat(tree).items():
        if len(path) >= 3 and _LSTM.match(path[-3]):  # lstm/{ii…ho}/{kernel,bias}
            continue
        value = _tensor(arr)
        names = list(path)
        if names[-1] == "kernel" and value.ndim == 4 and _CONV.match(names[-2]):
            names[-1] = "weight"  # Conv HWIO → nn.Conv2d OIHW
            value = value.permute(3, 2, 0, 1).contiguous()
        elif names[-1] == "kernel":  # Dense (…, in, out) → nn.Linear (…, out, in)
            names[-1] = "weight"
            value = value.transpose(-1, -2).contiguous()
        elif names[-1] == "scale":
            names[-1] = "weight"
        out[".".join(names)] = value
    for prefix, cell in _lstm_cells(tree):
        out[prefix + "weight_ih_l0"] = torch.cat(
            [_tensor(cell[f"i{g}"]["kernel"]).t() for g in _LSTM_GATES]).contiguous()
        out[prefix + "weight_hh_l0"] = torch.cat(
            [_tensor(cell[f"h{g}"]["kernel"]).t() for g in _LSTM_GATES]).contiguous()
        out[prefix + "bias_hh_l0"] = torch.cat([_tensor(cell[f"h{g}"]["bias"])
                                                for g in _LSTM_GATES])
        out[prefix + "bias_ih_l0"] = torch.zeros_like(out[prefix + "bias_hh_l0"])
    return out


def _lstm_cells(tree: Mapping, prefix: str = ""):
    """(state_dict prefix, flax cell) of every ``lstm`` sub-tree."""
    for k, v in tree.items():
        if not isinstance(v, Mapping):
            continue
        if _LSTM.match(k) and "ii" in v:
            yield f"{prefix}{k}.", v
        else:
            yield from _lstm_cells(v, f"{prefix}{k}.")


_ATTN_LINEARS = (("q", "lin_query"), ("k", "lin_key"), ("v", "lin_value"), ("s", "lin_skip"))


def _fuse_sides(cx: Mapping, ch: Mapping) -> Dict:
    """A per-gate pair of conv stacks (``conv_l/…`` leaves with a leading
    gate axis) → the fused stack's ``gates`` tree: layer 0 keeps the X and
    H sides apart, deeper layers stack the X streams before the H streams
    (the JAX package's ``tests/test_fused.py`` transplant). GCNConv
    (``lin``, ``bias``), ChebConv (``lin_k``, stacked on a tap axis),
    TransformerConv (``lin_query`` …) and MHTransformerConv (``conv/…`` and
    the mixing ``lin``)."""
    first = cx["conv_0"]
    layers = sum(1 for k in cx if k.startswith("conv_"))

    def both(get, layer):
        return np.concatenate([np.asarray(get(cx[f"conv_{layer}"])),
                               np.asarray(get(ch[f"conv_{layer}"]))], 0)

    if "att" in first or "att_src" in first:
        raise ValueError("a per-gate GAT cell has no fused layout (the JAX package's neither): "
                         "it loads as it is")
    fused = {}
    if "bias" in first:  # GCN or Chebyshev
        taps = sorted(k for k in first if k.startswith("lin_"))

        def weight(conv):
            if "lin" in conv:
                return np.asarray(conv["lin"]["kernel"])
            return np.stack([np.asarray(conv[k]["kernel"]) for k in taps], 1)

        for side, tree in (("x", cx), ("h", ch)):
            fused[f"w_{side}_0"] = weight(tree["conv_0"])
            fused[f"b_{side}_0"] = np.asarray(tree["conv_0"]["bias"])
        for layer in range(1, layers):
            fused[f"w_{layer}"] = both(weight, layer)
            fused[f"b_{layer}"] = both(lambda c: c["bias"], layer)
        return fused
    mh = "conv" in first

    def attn(conv):
        return conv["conv"] if mh else conv

    for short, lin in _ATTN_LINEARS:
        for side, tree in (("x", cx), ("h", ch)):
            fused[f"w_{short}_{side}_0"] = np.asarray(attn(tree["conv_0"])[lin]["kernel"])
            fused[f"b_{short}_{side}_0"] = np.asarray(attn(tree["conv_0"])[lin]["bias"])
    fused["w_e_x_0"] = np.asarray(attn(cx["conv_0"])["lin_edge"]["kernel"])
    fused["w_e_h_0"] = np.asarray(attn(ch["conv_0"])["lin_edge"]["kernel"])
    for layer in range(layers):
        if layer:
            for short, lin in _ATTN_LINEARS:
                fused[f"w_{short}_{layer}"] = both(lambda c: attn(c)[lin]["kernel"], layer)
                fused[f"b_{short}_{layer}"] = both(lambda c: attn(c)[lin]["bias"], layer)
            fused[f"w_e_{layer}"] = both(lambda c: attn(c)["lin_edge"]["kernel"], layer)
        if mh:
            fused[f"w_mix_{layer}"] = both(lambda c: c["lin"]["kernel"], layer)
            fused[f"b_mix_{layer}"] = both(lambda c: c["lin"]["bias"], layer)
    return fused


def _gates(tree: Mapping, sl: slice) -> Dict:
    """Gates ``sl`` of every leaf of a per-gate stack."""
    return {k: (_gates(v, sl) if isinstance(v, Mapping) else np.asarray(v)[sl])
            for k, v in tree.items()}


def _one_gate(tree: Mapping) -> Dict:
    """A plain stack's leaves with a leading gate axis of 1."""
    return {k: (_one_gate(v) if isinstance(v, Mapping) else np.asarray(v)[None])
            for k, v in tree.items()}


def fuse_cell_gates(cell: Mapping) -> Dict:
    """A per-gate ``GConvLSTM`` tree (``conv_x``/``conv_h``, 4 gates each)
    → the fused ``gates`` layout; a per-gate ``GConvGRU`` tree
    (``conv_x`` with gates z, r and the candidate, ``conv_h`` with z and r,
    ``conv_h_candidate``) → ``gates_zr`` (the z and r gates of both sides)
    and ``gate_candidate`` (the X candidate gate beside
    ``conv_h_candidate``). Peepholes and gate biases pass through."""
    cx, ch = cell["conv_x"], cell["conv_h"]
    out = {k: v for k, v in cell.items()
           if k not in ("conv_x", "conv_h", "conv_h_candidate")}
    if "conv_h_candidate" in cell:
        out["gates_zr"] = _fuse_sides(_gates(cx, slice(0, 2)), ch)
        out["gate_candidate"] = _fuse_sides(_gates(cx, slice(2, 3)),
                                            _one_gate(cell["conv_h_candidate"]))
    else:
        out["gates"] = _fuse_sides(cx, ch)
    return out


def fuse_attn_gates(cell: Mapping) -> Dict:
    """A per-gate TransformerConv or MHTransformerConv ``GConvLSTM`` tree →
    the fused ``gates`` layout of ``FusedAttnGateStack`` (:func:`fuse_cell_gates`)."""
    if "lin_query" not in cell["conv_x"]["conv_0"] and "conv" not in cell["conv_x"]["conv_0"]:
        raise ValueError("fuse_attn_gates converts TransformerConv cells (fuse_gcn_gates "
                         "GCNConv cells); a per-gate cell of another convolution loads as it is "
                         "into a fused_gates=False model (params_from_jax)")
    return fuse_cell_gates(cell)


def fuse_gcn_gates(cell: Mapping) -> Dict:
    """A per-gate GCNConv ``GConvLSTM`` tree (``conv_x``/``conv_h``:
    ``conv_l/lin/kernel`` (4, in, d) and ``conv_l/bias`` (4, d)) → the
    fused ``gates`` layout of ``FusedGateConvStack`` (:func:`fuse_cell_gates`):
    ``w_x_0`` (4, fx, d), ``b_x_0``, the same for H, and deeper layers with
    the X streams before the H streams (``w_l`` (8, d, d), ``b_l``)."""
    if "lin" not in cell["conv_x"]["conv_0"]:
        raise ValueError("fuse_gcn_gates converts GCNConv cells; a per-gate TransformerConv "
                         "cell is stacked by fuse_attn_gates")
    return fuse_cell_gates(cell)


def _per_gate_fusable(cell: Mapping) -> bool:
    """A per-gate LSTM or GRU cell of a conv with a fused stack (GAT
    cells, plain-stack SimpleLSTM cells and parameterless Dummy convs are
    not)."""
    if "conv_x" not in cell or not ("w_c_i" in cell or "conv_h_candidate" in cell):
        return False
    first = cell["conv_x"].get("conv_0", {})
    return "att" not in first and "att_src" not in first and bool(first)


def _fused_layout(tree: Mapping) -> Dict:
    """``tree`` with every per-gate cell (``rnn_i`` holding ``conv_x``)
    that has a fused layout stacked into it (:func:`fuse_cell_gates`)."""
    return {k: (fuse_cell_gates(v) if k.startswith("rnn_") and _per_gate_fusable(v) else v)
            for k, v in tree.items()}


_SCANS = (("enc", "encoder"), ("dec", "decoder"))


def _is_baseline(tree: Mapping) -> bool:
    """An ``MPNNLSTM`` or ``MPNNLSTMI`` tree (no encoder/decoder scans)."""
    return "lin1" in tree and "lin2" in tree


def params_from_jax(tree: Mapping, fuse_gates: bool = False) -> Dict[str, torch.Tensor]:
    """flax ``Seq2Seq`` variables (or their ``params`` sub-tree) → port
    ``Seq2Seq`` state_dict (f32 CPU tensors), leaf for leaf in the tree's
    gate layout; with ``fuse_gates`` every per-gate cell is stacked into
    the fused layout (:func:`fuse_attn_gates`, :func:`fuse_gcn_gates`),
    for a fused model. An ``MPNNLSTM`` or ``MPNNLSTMI`` tree maps onto
    the port's model of the same name."""
    if "params" in tree:
        tree = tree["params"]
    if _is_baseline(tree):
        return state_dict_from_flax(tree)
    # a dummy model's encoder has no parameters, and flax leaves it out
    if "dec" not in tree or not set(tree) <= {"enc", "dec"}:
        raise KeyError(f"expected a Seq2Seq tree with enc/dec, got {sorted(tree)}")
    out = {}
    for scan, name in _SCANS:
        if scan not in tree:
            continue
        inner = tree[scan][name]
        if fuse_gates:
            inner = _fused_layout(inner)
        for key, value in state_dict_from_flax(inner).items():
            out[f"{name}.{key}"] = value
    return out


def flax_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`state_dict_from_flax`: ``weight`` →
    ``kernel`` with its last two axes swapped, a LayerNorm's or
    BatchNorm's ``weight`` → ``scale``, ``torch.nn.LSTM`` leaves → the
    flax cell's (one bias: ``bias_hh`` + ``bias_ih``), every other leaf by
    its own name (numpy f32 leaves)."""
    tree: Dict = {}
    lstm = {k: v.detach().float().cpu() for k, v in state_dict.items()
            if len(k.split(".")) >= 2 and _LSTM.match(k.split(".")[-2])}
    for key, value in state_dict.items():
        names = key.split(".")
        arr = value.detach().float().cpu()
        node = tree
        for part in names[:-1]:
            node = node.setdefault(part, {})
        if key in lstm:
            if names[-1] != "weight_ih_l0":
                continue
            prefix = key.removesuffix("weight_ih_l0")
            w_ih, w_hh = arr.chunk(4), lstm[prefix + "weight_hh_l0"].chunk(4)
            # the flax cell has one bias, on the recurrent side
            bias = (lstm[prefix + "bias_hh_l0"] + lstm[prefix + "bias_ih_l0"]).chunk(4)
            for g, wi, wh, bh in zip(_LSTM_GATES, w_ih, w_hh, bias):
                node[f"i{g}"] = {"kernel": wi.t().contiguous().numpy()}
                node[f"h{g}"] = {"kernel": wh.t().contiguous().numpy(),
                                 "bias": bh.contiguous().numpy()}
            continue
        if _NORM_WEIGHT.search(key):
            names[-1] = "scale"
        elif names[-1] == "weight" and arr.ndim == 4 and _CONV.match(names[-2]):
            names[-1] = "kernel"  # nn.Conv2d OIHW → Conv HWIO
            arr = arr.permute(2, 3, 1, 0)
        elif names[-1] == "weight":
            names[-1] = "kernel"
            arr = arr.transpose(-1, -2)
        node[names[-1]] = arr.contiguous().numpy()
    return tree


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Port ``Seq2Seq`` state_dict → the flax variables ``{"params": {"enc":
    {"encoder": …}, "dec": {"decoder": …}}}`` of the JAX package's model
    in the same gate layout (numpy f32 leaves), leaf by leaf as
    :func:`flax_from_state_dict`; an ``MPNNLSTM`` or ``MPNNLSTMI``
    state_dict → ``{"params": …}`` of the JAX model of the same name. The
    inverse of :func:`params_from_jax`."""
    scans = dict((name, scan) for scan, name in _SCANS)
    flat = flax_from_state_dict(state_dict)
    if _is_baseline(flat):
        return {"params": flat}
    return {"params": {scans[name]: {name: inner} for name, inner in flat.items()}}


_RUNNING = ("mean", "var")  # a RunningBatchNorm's buffers, flax's batch_stats


def cnnlstm_state_dict_from_jax(variables: Mapping) -> Dict[str, torch.Tensor]:
    """flax variables of the JAX package's ``CNNLSTMSeq2Seq`` or
    ``CNNLSTM`` (``{"params": …, "batch_stats": …}``) → the port model's
    state_dict, parameters and running statistics (f32 CPU tensors)."""
    out = state_dict_from_flax(variables["params"])
    for path, arr in _flat(variables.get("batch_stats", {})).items():
        out[".".join(path)] = _tensor(arr)
    return out


def cnnlstm_variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of :func:`cnnlstm_state_dict_from_jax`: a port
    CNN-LSTM state_dict → ``{"params": …, "batch_stats": …}`` of the JAX
    model (numpy f32 leaves)."""
    params = {k: v for k, v in state_dict.items() if k.split(".")[-1] not in _RUNNING}
    stats: Dict = {}
    for key, value in state_dict.items():
        names = key.split(".")
        if names[-1] not in _RUNNING:
            continue
        node = stats
        for part in names[:-1]:
            node = node.setdefault(part, {})
        node[names[-1]] = value.detach().float().cpu().numpy()
    return {"params": flax_from_state_dict(params), "batch_stats": stats}
