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

The eager API (``push_pull``, ``push_pull_async`` + ``synchronize``/``poll``,
``push_pull_tree``, the broadcasts, ``mark_step``) is here too, and the
Horovod-style torch plugin is ``byteps_tpu_torch.torch``: a script written
for ``byteps_tpu.torch`` runs on the card by changing that import.

Entry points run on CUDA unless the caller passes ``device="cpu"``.  The
package imports neither JAX nor ``byteps_tpu``.
"""

from .version import __version__

from .common.api import (
    init, shutdown, suspend, resume,
    rank, size, local_rank, local_size,
    leave, get_membership, on_membership_change,
    get_ring, drain_ps_server,
    declare, declared_key, register_compressor, get_ps_session,
    push_pull, push_pull_async, push_pull_tree, push_pull_sparse,
    synchronize, poll,
    broadcast_parameters, broadcast_optimizer_state,
    get_pushpull_speed, get_codec_stats,
    get_transport_stats, get_metrics, get_server_stats,
    get_health, get_audit, get_key_signals, get_diagnosis,
    get_tuner, get_hierarchy, get_autoscaler, get_fleet,
    get_device_profile,
    mark_step, current_step,
)
from .common.fusion import get_stats as get_fusion_stats
from .ops.compression import Compression
from .ops import collectives, compressor, ring_attention
from .parallel.data_parallel import DistributedOptimizer, build_train_step



def __getattr__(name):
    # Lazy submodules, as in the JAX package.
    if name in ("models", "callbacks", "utils"):
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "__version__",
    "init", "shutdown", "suspend", "resume",
    "rank", "size", "local_rank", "local_size",
    "leave", "get_membership", "on_membership_change",
    "get_ring", "drain_ps_server",
    "declare", "declared_key", "register_compressor", "get_ps_session",
    "push_pull", "push_pull_async", "push_pull_tree", "push_pull_sparse",
    "synchronize", "poll",
    "broadcast_parameters", "broadcast_optimizer_state",
    "get_pushpull_speed", "get_codec_stats", "get_fusion_stats",
    "get_transport_stats", "get_metrics", "get_server_stats",
    "get_health", "get_audit", "get_key_signals", "get_diagnosis",
    "get_tuner", "get_hierarchy", "get_autoscaler", "get_fleet",
    "get_device_profile",
    "mark_step", "current_step",
    "Compression", "collectives", "compressor", "ring_attention",
    "DistributedOptimizer", "build_train_step",
    "models", "callbacks", "utils",
]
