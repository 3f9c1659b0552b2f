"""Multi-GPU parallelism: block-sharded elliptic smoothing over
``torch.distributed`` (one process per rank)."""

from .shard import ShardedSmoother

__all__ = ["ShardedSmoother"]
