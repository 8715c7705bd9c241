"""Parameters: the port's seeded init and the bridge from flax trees.

``params_from_jax`` maps the flax parameter tree of the JAX package's
``Seq2Seq`` (nested dicts of numpy arrays, e.g. ``params/enc/encoder/
rnn_0/gates/w_x_0``) onto this package's ``Seq2Seq`` ``state_dict``. It
reads numpy arrays only.

``init_params`` is the port's own init with the JAX package's rules:
glorot-uniform with fan-in/fan-out on the last two axes of the stacked
gate weights (leading axes are batch axes, as ``_glorot_batched``) and
on (in, out) of every Dense kernel; zero biases and peepholes; LayerNorm
scale 1, bias 0. It draws from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_GATE_WEIGHT = re.compile(r"\.gates\.w_(x_0|h_0|\d+)$")
_LIN_WEIGHT = re.compile(r"\.lin_\d+\.weight$")
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
        elif _LIN_WEIGHT.search(name):  # torch (out, in) layout
            _glorot_(p, p.shape[1], p.shape[0], gen)
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
    state_dict: ``kernel`` (in, out) → ``weight`` (out, in), LayerNorm
    ``scale`` → ``weight``, every other leaf by its own name."""
    out = {}
    for path, arr in _flat(tree).items():
        value = torch.from_numpy(np.array(arr, dtype=np.float32))
        names = list(path)
        if names[-1] == "kernel":  # Dense (in, out) → nn.Linear (out, in)
            names[-1] = "weight"
            value = value.T.contiguous()
        elif names[-1] == "scale":
            names[-1] = "weight"
        out[".".join(names)] = value
    return out


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``Seq2Seq`` variables (or their ``params`` sub-tree) → port
    ``Seq2Seq`` state_dict (f32 CPU tensors)."""
    if "params" in tree:
        tree = tree["params"]
    if set(tree) != {"enc", "dec"}:
        raise KeyError(f"expected a Seq2Seq tree with enc/dec, got {sorted(tree)}")
    out = {}
    for scan, inner, name in (("enc", "encoder", "encoder"), ("dec", "decoder", "decoder")):
        for key, value in state_dict_from_flax(tree[scan][inner]).items():
            out[f"{name}.{key}"] = value
    return out
