"""Utilities: checkpointing and input-pipeline helpers."""

from . import checkpoint
from . import data
from .data import (shard_batch, prefetch_to_device, synthetic_batches,
                   host_shard, global_batch_from_local)

__all__ = ["checkpoint", "data", "shard_batch", "prefetch_to_device",
           "synthetic_batches", "host_shard", "global_batch_from_local"]
