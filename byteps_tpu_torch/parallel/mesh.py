"""Process meshes for the framework, on ``torch.distributed.DeviceMesh``.

Counterpart of ``byteps_tpu/parallel/mesh.py``.  The JAX package lays
devices out in a ``jax.sharding.Mesh`` whose axes name the parallelism
dimensions; here the same axes lay out global ranks, and each axis of the
``DeviceMesh`` owns a process group (``mesh.get_group(axis)``) that the
collectives of ``ops.collectives`` take:

  - ``pp``, ``dp``, ``ep``, ``sp``, ``tp`` (``AXIS_ORDER``, ``tp``
    innermost: the fastest wires);
  - ``dcn_dp`` / ``ici_dp``: the two-level split of dp for the
    hierarchical reduce — ranks of one node (NVLink) reduce among
    themselves, one shard per rank then crosses the network.

The rank layout is a pure function of the counts (``mesh_ranks``,
``hierarchical_ranks``, ``slice_ranks``): the numpy array of global ranks
behind each mesh, row-major over the axes, as the JAX package reshapes its
device list.  Building the ``DeviceMesh`` needs a process group of at
least the mesh's size (``bps.init()`` or ``torch.distributed``'s own), and
every rank of the group must build it: it creates one group per axis.
The device type is ``"cuda"`` unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from ..common.config import get_config
from ..common.device import resolve_device

# Canonical axis order: pp outermost, then dp, ep, sp, tp innermost.
AXIS_ORDER = ("pp", "dp", "ep", "sp", "tp")
TWO_LEVEL = ("dcn_dp", "ici_dp")

_mesh = None


def _world_ranks(devices: Optional[Sequence[int]]) -> list:
    if devices is not None:
        return [int(r) for r in devices]
    n = dist.get_world_size() if dist.is_initialized() else 1
    return list(range(n))


def mesh_ranks(dp: int = 0, tp: int = 1, sp: int = 1, pp: int = 1,
               ep: int = 1, devices: Optional[Sequence[int]] = None
               ) -> np.ndarray:
    """The ranks of ``make_mesh``, shaped over ``AXIS_ORDER``.  dp=0 means
    "the rest"."""
    ranks = _world_ranks(devices)
    n = len(ranks)
    other = tp * sp * pp * ep
    if dp <= 0:
        if n % other != 0:
            raise ValueError(
                f"device count {n} not divisible by tp*sp*pp*ep={other}")
        dp = n // other
    total = dp * other
    if total != n:
        raise ValueError(f"mesh {dp=}*{tp=}*{sp=}*{pp=}*{ep=}={total} != "
                         f"device count {n}")
    sizes = dict(pp=pp, dp=dp, ep=ep, sp=sp, tp=tp)
    return np.asarray(ranks).reshape(tuple(sizes[a] for a in AXIS_ORDER))


def hierarchical_ranks(ici_size: Optional[int] = None,
                       devices: Optional[Sequence[int]] = None
                       ) -> np.ndarray:
    """The ranks of ``make_hierarchical_mesh``, shaped (dcn_dp, ici_dp).
    None reads BYTEPS_TPU_ICI_SIZE (0 = all ranks local, one island)."""
    if ici_size is None:
        ici_size = get_config().ici_size
    ranks = _world_ranks(devices)
    n = len(ranks)
    if ici_size <= 0:
        ici_size = n
    if n % ici_size != 0:
        raise ValueError(f"{n} devices not divisible by ici_size={ici_size}")
    return np.asarray(ranks).reshape(n // ici_size, ici_size)


def slice_ranks(num_members: int,
                devices: Optional[Sequence[int]] = None
                ) -> Optional[np.ndarray]:
    """The ranks of ``make_slice_mesh``: the first ``num_members``, or
    None when the world has fewer ranks than members."""
    n = max(1, int(num_members))
    ranks = _world_ranks(devices)
    if len(ranks) < n:
        return None
    return np.asarray(ranks[:n])


def _device_mesh(ranks: np.ndarray, names: Tuple[str, ...],
                 device_type: str):
    from torch.distributed.device_mesh import DeviceMesh
    resolve_device(device_type)          # raises for CUDA without a card
    if not dist.is_initialized():
        raise RuntimeError(
            "a DeviceMesh needs a process group: call bps.init() (or "
            "torch.distributed.init_process_group) first")
    if ranks.size > dist.get_world_size():
        raise ValueError(f"mesh of {ranks.size} ranks in a world of "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def make_mesh(dp: int = 0, tp: int = 1, sp: int = 1, pp: int = 1,
              ep: int = 1, devices: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the ranks ``devices`` (default: the world)
    with axes ``AXIS_ORDER``."""
    return _device_mesh(mesh_ranks(dp, tp, sp, pp, ep, devices), AXIS_ORDER,
                        device_type)


def make_hierarchical_mesh(ici_size: Optional[int] = None,
                           devices: Optional[Sequence[int]] = None,
                           device_type: str = "cuda"):
    """Two-level DP mesh ('dcn_dp', 'ici_dp') for hierarchical reduction:
    ``ici_size`` consecutive ranks per island, islands joined over the
    network.  None reads BYTEPS_TPU_ICI_SIZE (0 = one island)."""
    return _device_mesh(hierarchical_ranks(ici_size, devices), TWO_LEVEL,
                        device_type)


def make_slice_mesh(num_members: int,
                    devices: Optional[Sequence[int]] = None,
                    device_type: str = "cuda"):
    """One-axis ``('ici_dp',)`` mesh over a slice's members, or None when
    the world has fewer ranks than members (the caller then sums on the
    host)."""
    ranks = slice_ranks(num_members, devices)
    if ranks is None:
        return None
    return _device_mesh(ranks, ("ici_dp",), device_type)


def get_mesh(refresh: bool = False, device_type: str = "cuda"):
    """Process-wide default mesh built from config (BYTEPS_TPU_MESH_*)."""
    global _mesh
    if _mesh is None or refresh:
        cfg = get_config(refresh=refresh)
        _mesh = make_mesh(dp=cfg.mesh_dp, tp=cfg.mesh_tp, sp=cfg.mesh_sp,
                          pp=cfg.mesh_pp, ep=cfg.mesh_ep,
                          device_type=device_type)
    return _mesh


def set_mesh(mesh) -> None:
    global _mesh
    _mesh = mesh


def reset_mesh() -> None:
    global _mesh
    _mesh = None


def dp_axis_size(mesh=None) -> int:
    m = mesh if mesh is not None else get_mesh()
    names = tuple(m.mesh_dim_names or ())
    return int(math.prod(m.size(names.index(a)) for a in ("dp",)
                         if a in names))
