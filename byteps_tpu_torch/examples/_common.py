"""What the examples share: the ``--device`` flag, the process group a
mesh needs, and this rank's shard of a global batch."""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from ..common.device import resolve_device


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default) or "cpu"; without a CUDA device '
                         'the example stops unless given "cpu"')


def device(ap: argparse.ArgumentParser, args) -> torch.device:
    """The device asked for; an argparse error (exit 2) when it is CUDA
    and there is none."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))


def join_world(dev: torch.device) -> None:
    """A process group for the examples that build a mesh: the one
    ``bps.init()`` joined (``DMLC_NUM_WORKER`` > 1) or the caller made, else
    a world of one (an in-memory store; gloo on loopback for CPU tensors,
    NCCL for CUDA ones).  ``bps.shutdown()`` destroys it."""
    if dist.is_initialized():
        return
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    dist.init_process_group(
        "gloo" if dev.type == "cpu" else "cpu:gloo,cuda:nccl",
        store=dist.HashStore(), world_size=1, rank=0)


def shard(x: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """This rank's rows of a global batch (the data-parallel step takes
    each rank's shard, where the JAX step shards the global batch)."""
    return x.chunk(size, 0)[rank]
