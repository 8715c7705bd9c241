"""PyTorch/CUDA port of quadtree_mpnnlstm_tpu (forecast path).

A package of its own beside the JAX reference: it imports torch and numpy,
never JAX nor the JAX package. Entry point:
:class:`quadtree_mpnnlstm_tpu_torch.train.predictor.NextFramePredictorS2S`.
"""
