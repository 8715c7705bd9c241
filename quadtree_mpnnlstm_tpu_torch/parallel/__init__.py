from quadtree_mpnnlstm_tpu_torch.parallel.dp import all_reduce_step, launch, shard_batch
from quadtree_mpnnlstm_tpu_torch.parallel.mesh import make_mesh

__all__ = ["all_reduce_step", "launch", "make_mesh", "shard_batch"]
