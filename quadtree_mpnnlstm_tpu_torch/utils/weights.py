"""Parameters: the port's seeded init and the bridge to and from flax trees.

``params_from_jax`` maps the flax parameter tree of the JAX package's
``Seq2Seq`` (nested dicts of numpy arrays, e.g. ``params/enc/encoder/
rnn_0/gates/w_x_0``) onto this package's ``Seq2Seq`` ``state_dict`` leaf
for leaf, in the fused or the per-gate gate layout alike (``fused_gates=
False``: vmapped ``conv_x``/``conv_h`` stacks, every leaf with a leading
gate axis, as the JAX package's sea-ice experiments train pixelwise
meshes); ``params_to_jax`` is its inverse, so a port checkpoint loads
into the JAX package's model of the same layout. ``fuse_attn_gates``
stacks a per-gate TransformerConv cell into the fused layout and
``fuse_gcn_gates`` a per-gate GCNConv cell, for loading a per-gate tree
into a fused model (``params_from_jax(..., fuse_gates=
True)``). They read numpy arrays only.

``init_params`` is the port's own init with the JAX package's rules:
glorot-uniform with fan-in/fan-out on the last two axes of the stacked
gate weights (GCN and Chebyshev ``w_x_0``…, attention ``w_q_x_0``,
``w_e_1``…; leading axes are batch axes, as ``_glorot_batched``) and on
(in, out) of every Dense kernel (GCN's ``lin``, ``lin_0``…, ``lin_query``,
``lin_edge``, ``lin_skip``…, per gate slice in the per-gate layout, as the
flax vmap initialises each gate); zero biases and peepholes; LayerNorm
scale 1, bias 0. It draws from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_GATE_WEIGHT = re.compile(r"\.gates\.w_[a-z0-9_]+$")
_LIN_WEIGHT = re.compile(r"\.lin(_[a-z0-9]+)?\.weight$")
_NORM_WEIGHT = re.compile(r"norm_[a-z]+\.weight$")


def _glorot_(p: torch.Tensor, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(p.shape, generator=gen, dtype=torch.float32)
    p.copy_((2.0 * u - 1.0) * limit)


@torch.no_grad()
def init_params(model: nn.Module, gen: torch.Generator) -> None:
    """Initialise every parameter of ``model`` in place from ``gen`` (a CPU
    generator; values are copied to the parameters' device)."""
    for name, p in model.named_parameters():
        if _GATE_WEIGHT.search(name):
            _glorot_(p, p.shape[-2], p.shape[-1], gen)
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


def state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Any flax sub-tree of the ported modules → the matching torch
    state_dict: ``kernel`` (…, in, out) → ``weight`` (…, out, in), LayerNorm
    ``scale`` → ``weight``, every other leaf by its own name."""
    out = {}
    for path, arr in _flat(tree).items():
        value = torch.from_numpy(np.array(arr, dtype=np.float32))
        names = list(path)
        if names[-1] == "kernel":  # Dense (…, in, out) → nn.Linear (…, out, in)
            names[-1] = "weight"
            value = value.transpose(-1, -2).contiguous()
        elif names[-1] == "scale":
            names[-1] = "weight"
        out[".".join(names)] = value
    return out


_ATTN_LINEARS = (("q", "lin_query"), ("k", "lin_key"), ("v", "lin_value"), ("s", "lin_skip"))


def fuse_attn_gates(cell: Mapping) -> Dict:
    """A per-gate TransformerConv ``GConvLSTM`` tree (``conv_x``/``conv_h``:
    ``conv_l/lin_*`` leaves with a leading gate axis, (4, in, d) kernels)
    → the fused ``gates`` layout of ``FusedAttnGateStack``: layer 0 keeps
    the X and H sides apart (``w_q_x_0`` …, ``w_e_x_0``), deeper layers
    stack the X streams before the H streams (``w_q_l`` (8, d, d) …).
    Peepholes and gate biases pass through."""
    cx, ch = cell["conv_x"], cell["conv_h"]
    if "lin_query" not in cx["conv_0"]:
        raise ValueError("fuse_attn_gates converts TransformerConv cells (fuse_gcn_gates "
                         "GCNConv cells); a per-gate cell of another convolution loads as it is "
                         "into a fused_gates=False model (params_from_jax)")
    fused = {}
    for short, lin in _ATTN_LINEARS:
        for side, tree in (("x", cx), ("h", ch)):
            fused[f"w_{short}_{side}_0"] = np.asarray(tree["conv_0"][lin]["kernel"])
            fused[f"b_{short}_{side}_0"] = np.asarray(tree["conv_0"][lin]["bias"])
    fused["w_e_x_0"] = np.asarray(cx["conv_0"]["lin_edge"]["kernel"])
    fused["w_e_h_0"] = np.asarray(ch["conv_0"]["lin_edge"]["kernel"])
    layer = 1
    while f"conv_{layer}" in cx:
        both = lambda lin, part: np.concatenate(  # noqa: E731
            [np.asarray(cx[f"conv_{layer}"][lin][part]),
             np.asarray(ch[f"conv_{layer}"][lin][part])], 0)
        for short, lin in _ATTN_LINEARS:
            fused[f"w_{short}_{layer}"] = both(lin, "kernel")
            fused[f"b_{short}_{layer}"] = both(lin, "bias")
        fused[f"w_e_{layer}"] = both("lin_edge", "kernel")
        layer += 1
    out = {k: v for k, v in cell.items() if k not in ("conv_x", "conv_h")}
    out["gates"] = fused
    return out


def fuse_gcn_gates(cell: Mapping) -> Dict:
    """A per-gate GCNConv ``GConvLSTM`` tree (``conv_x``/``conv_h``:
    ``conv_l/lin/kernel`` (4, in, d) and ``conv_l/bias`` (4, d)) → the
    fused ``gates`` layout of ``FusedGateConvStack``, as the JAX package's
    ``tests/test_fused.py`` transplants it: ``w_x_0`` (4, fx, d),
    ``b_x_0``, the same for H, and deeper layers with the X streams before
    the H streams (``w_l`` (8, d, d), ``b_l``). Peepholes and gate biases
    pass through."""
    cx, ch = cell["conv_x"], cell["conv_h"]
    if "lin" not in cx["conv_0"]:
        raise ValueError("fuse_gcn_gates converts GCNConv cells; a per-gate TransformerConv "
                         "cell is stacked by fuse_attn_gates")
    fused = {}
    for side, tree in (("x", cx), ("h", ch)):
        fused[f"w_{side}_0"] = np.asarray(tree["conv_0"]["lin"]["kernel"])
        fused[f"b_{side}_0"] = np.asarray(tree["conv_0"]["bias"])
    layer = 1
    while f"conv_{layer}" in cx:
        lx, lh = cx[f"conv_{layer}"], ch[f"conv_{layer}"]
        fused[f"w_{layer}"] = np.concatenate([np.asarray(lx["lin"]["kernel"]),
                                              np.asarray(lh["lin"]["kernel"])], 0)
        fused[f"b_{layer}"] = np.concatenate([np.asarray(lx["bias"]), np.asarray(lh["bias"])], 0)
        layer += 1
    out = {k: v for k, v in cell.items() if k not in ("conv_x", "conv_h")}
    out["gates"] = fused
    return out


def _fuse_cell(cell: Mapping) -> Dict:
    if "lin" in cell["conv_x"]["conv_0"]:
        return fuse_gcn_gates(cell)
    return fuse_attn_gates(cell)


def _fused_layout(tree: Mapping) -> Dict:
    """``tree`` with every per-gate cell (``rnn_i`` holding ``conv_x``)
    stacked into the fused layout (:func:`fuse_attn_gates`,
    :func:`fuse_gcn_gates`)."""
    return {k: (_fuse_cell(v) if k.startswith("rnn_") and "conv_x" in v else v)
            for k, v in tree.items()}


_SCANS = (("enc", "encoder"), ("dec", "decoder"))


def params_from_jax(tree: Mapping, fuse_gates: bool = False) -> Dict[str, torch.Tensor]:
    """flax ``Seq2Seq`` variables (or their ``params`` sub-tree) → port
    ``Seq2Seq`` state_dict (f32 CPU tensors), leaf for leaf in the tree's
    gate layout; with ``fuse_gates`` every per-gate cell is stacked into
    the fused layout (:func:`fuse_attn_gates`, :func:`fuse_gcn_gates`),
    for a fused model."""
    if "params" in tree:
        tree = tree["params"]
    if set(tree) != {"enc", "dec"}:
        raise KeyError(f"expected a Seq2Seq tree with enc/dec, got {sorted(tree)}")
    out = {}
    for scan, name in _SCANS:
        inner = tree[scan][name]
        if fuse_gates:
            inner = _fused_layout(inner)
        for key, value in state_dict_from_flax(inner).items():
            out[f"{name}.{key}"] = value
    return out


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Port ``Seq2Seq`` state_dict → the flax variables ``{"params": {"enc":
    {"encoder": …}, "dec": {"decoder": …}}}`` of the JAX package's model
    in the same gate layout (numpy f32 leaves): ``weight`` → ``kernel``
    with its last two axes swapped, LayerNorm ``weight`` → ``scale``, every
    other leaf by its own name. The inverse of :func:`params_from_jax`."""
    scans = dict((name, scan) for scan, name in _SCANS)
    params: Dict = {}
    for key, value in state_dict.items():
        names = key.split(".")
        arr = value.detach().float().cpu()
        if names[-1] == "weight" and names[-2].startswith("norm_"):
            names[-1] = "scale"
        elif names[-1] == "weight":
            names[-1] = "kernel"
            arr = arr.transpose(-1, -2)
        node = params.setdefault(scans[names[0]], {}).setdefault(names[0], {})
        for part in names[1:-1]:
            node = node.setdefault(part, {})
        node[names[-1]] = arr.contiguous().numpy()
    return {"params": params}
