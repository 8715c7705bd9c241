"""Forecast entry point: ``NextFramePredictorS2S.predict``.

Counterpart of the inference side of
``quadtree_mpnnlstm_tpu/train/predictor.py``: the constructor's config
resolution (eval model only) and ``predict``. The JAX package vmaps the
model over the samples of a batch; here the batch axis is explicit and
each sample keeps its own mesh. Training (optimizer, loss, checkpoints)
comes with a later slice of the port.

Runs on ``device="cuda"`` unless the caller passes ``device="cpu"``; on
the card the Â-block kernels (ops/spmm.py) carry every aggregation.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from quadtree_mpnnlstm_tpu_torch.config import NEG_INF, GraphConfig, ModelConfig
from quadtree_mpnnlstm_tpu_torch.models.seq2seq import Seq2Seq
from quadtree_mpnnlstm_tpu_torch.utils.weights import init_params, params_from_jax


class NextFramePredictorS2S:
    """Seq2Seq forecaster over quadtree meshes."""

    def __init__(
        self,
        image_shape,
        thresh: float,
        decompose: bool = True,
        input_features: int = 1,
        input_timesteps: int = 3,
        output_timesteps: int = 3,
        device: str = "cuda",
        condition: str = "max_larger_than",
        binary: bool = False,
        seed: int = 21,
        model_kwargs: Optional[Dict[str, Any]] = None,
        graph_kwargs: Optional[Dict[str, Any]] = None,
    ):
        self.thresh = thresh if decompose else NEG_INF
        self.device = torch.device(device)

        mk = dict(model_kwargs or {})
        self.cfg = ModelConfig(
            hidden_size=mk.pop("hidden_size", 32),
            input_features=input_features,
            input_timesteps=input_timesteps,
            output_timesteps=output_timesteps,
            n_layers=mk.pop("n_layers", 4),
            n_conv_layers=mk.pop("n_conv_layers", 2),
            convolution_type=mk.pop("convolution_type", "ChebConv"),
            rnn_type=mk.pop("rnn_type", "LSTM"),
            binary=binary,
            remesh_every=mk.pop("remesh_every", 1),
            fused_gates=mk.pop("fused_gates", True),
            compute_dtype=mk.pop("compute_dtype", "float32"),
        )
        if mk:
            raise TypeError(f"unknown model_kwargs: {sorted(mk)}")

        gk = dict(graph_kwargs or {})
        carry_edges_explicit = "carry_edges" in gk
        self.gcfg = GraphConfig(
            image_shape=tuple(image_shape),
            max_grid_size=gk.pop("max_grid_size", 64),
            thresh=self.thresh,
            condition=condition,
            use_edge_attrs=self.cfg.uses_edge_attrs,
            **gk,
        )
        if not carry_edges_explicit and self.gcfg.aggregation == "pallas":
            # aggregation rides the Â blocks; the edge list is dead weight
            self.gcfg = self.gcfg.replace(carry_edges=False)

        self.model = Seq2Seq(self.cfg, self.gcfg).to(self.device).eval()
        gen = torch.Generator().manual_seed(seed)
        init_params(self.model, gen)
        # worst capacity overflow of the last predict() (0 = nothing dropped)
        self.last_overflow = 0

    def load_jax_params(self, tree) -> None:
        """Load a flax parameter tree (numpy leaves) of the JAX package."""
        self.model.load_state_dict(params_from_jax(tree))

    @torch.no_grad()
    def forecast(self, x, mask=None):
        """One batch: x (B, T_in, rows, cols, C) array or tensor →
        (y_hat (B, T_out, rows, cols, 1) tensor, overflow (B,), per-step
        pixel_node maps (T_out, B, P))."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        m = None if mask is None else torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        y_hat, state, meshes = self.model.rollout(x, mask=m)
        return y_hat, state.graph.overflow, meshes

    def predict(self, loader, mask=None) -> np.ndarray:
        """→ (N, T_out, rows, cols, 1) for every batch of ``loader``, which
        yields (x, y, launch_date) numpy triplets."""
        outs, worst = [], 0
        for x, _y, _launch in loader:
            y_hat, overflow, _ = self.forecast(x, mask=mask)
            outs.append(y_hat.cpu().numpy())
            worst = max(worst, int(overflow.max()))
        self.last_overflow = worst
        if worst > 0:
            print(
                f"WARNING: mesh capacity overflow ({worst} dropped slots at the "
                "worst step) — raise n_max/e_max/agg_* (GraphConfig)"
            )
        return np.concatenate(outs, axis=0)
