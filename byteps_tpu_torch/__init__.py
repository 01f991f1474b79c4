"""byteps_tpu_torch — the PyTorch/CUDA port of byteps_tpu for NVIDIA Hopper.

The data-parallel face of the JAX package's API, on ``torch.distributed``,
with its Pallas kernels rewritten by hand for the H100 (``csrc/``):

    import byteps_tpu_torch as bps
    bps.init()
    opt = bps.DistributedOptimizer(torch.optim.AdamW(leaves, lr=1e-4))
    step = bps.build_train_step(loss_fn, opt)
    loss = step(params, batch)

Gradient compression per bucket (onebit, topk, randomk, dithering, with
error feedback and Nesterov momentum) is ``DistributedOptimizer(...,
inter_compressor=bps.compressor.create({"compressor": "onebit",
"ef": "vanilla"}))``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  The
package imports neither JAX nor ``byteps_tpu``.
"""

from .version import __version__

from .common.api import (
    init, shutdown, rank, size, local_rank, local_size,
)
from .common.fusion import get_stats as get_fusion_stats
from .ops.compression import Compression
from .ops import collectives, compressor
from .parallel.data_parallel import DistributedOptimizer, build_train_step

__all__ = [
    "__version__",
    "init", "shutdown", "rank", "size", "local_rank", "local_size",
    "get_fusion_stats",
    "Compression", "collectives", "compressor",
    "DistributedOptimizer", "build_train_step",
]
