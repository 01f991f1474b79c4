"""The data-parallel face of the user API over ``torch.distributed``.

Counterpart of ``init``/``shutdown``/``rank``/``size``/``local_rank``/
``local_size`` in ``byteps_tpu/common/api.py``.  A world of one needs no
process group: every collective is then the identity.  With
``DMLC_NUM_WORKER > 1``, ``init()`` joins the process group at
``tcp://DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT`` as rank ``DMLC_WORKER_ID`` —
NCCL when CUDA is present, gloo otherwise.  A caller that set up the
process group itself may skip ``init()``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .config import get_config
from .logging import get_logger, set_level, set_rank


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def init() -> None:
    cfg = get_config(refresh=True)
    set_level(cfg.log_level)
    if cfg.num_worker > 1 and not is_distributed():
        if torch.cuda.is_available():
            torch.cuda.set_device(cfg.local_rank)
        dist.init_process_group(
            backend="nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{cfg.scheduler_uri}:{cfg.scheduler_port}",
            world_size=cfg.num_worker, rank=cfg.worker_id)
    set_rank(rank() if size() > 1 else None)
    get_logger().info("byteps_tpu_torch initialized: rank=%d/%d "
                      "local_rank=%d", rank(), size(), local_rank())


def shutdown() -> None:
    if is_distributed():
        dist.destroy_process_group()
    set_rank(None)


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    return get_config().local_rank


def local_size() -> int:
    return get_config().local_size
