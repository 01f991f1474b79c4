"""The user API over ``torch.distributed``: lifecycle, topology, the eager
push_pull family, broadcasts and the step counter.

Counterpart of ``byteps_tpu/common/api.py``.  A world of one needs no
process group: every collective is then the identity.  With
``DMLC_NUM_WORKER > 1``, ``init()`` joins the process group at
``tcp://DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT`` as rank ``DMLC_WORKER_ID`` —
NCCL when CUDA is present, gloo otherwise.  A caller that set up the
process group itself may call ``init()`` all the same: it joins nothing.

The eager path (``push_pull``, ``push_pull_async`` + ``synchronize`` /
``poll``, ``push_pull_tree``) is for out-of-graph tensors — metric
averages, parameter broadcasts, the Horovod plugin's gradients — as in the
JAX package: each named tensor gets a declared key (``core.native``), each
call a handle, and ``push_pull_tree`` packs small leaves into the fusion
planner's buckets (``common.fusion.plan_buckets``), dispatched in
priority order as concurrent async all-reduces.  Tensors stay on their
device.  ``priority`` orders the dispatch of a tree's units; the process
group runs collectives in issue order.

``BYTEPS_DEBUG_SAMPLE_TENSOR`` writes a sample of every eager tensor whose
name contains it to stderr, at push entry and after synchronize.

The PS tier (``BYTEPS_ENABLE_ASYNC``, ``push_pull_sparse``, membership,
server drain) and the signal and telemetry getters are not ported: they
raise ``NotImplementedError`` naming their ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import sys
import threading
import time
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..core.native import get_core
from .config import Config, get_config
from .logging import get_logger, set_level, set_rank
from .tree import tree_leaves, tree_paths, tree_unflatten

Tree = Any


@dataclasses.dataclass
class _State:
    initialized: bool = False
    config: Optional[Config] = None
    step: int = 0
    step_start_us: Optional[int] = None
    # handle -> (buffer, pending work or None, compression, ctx, average,
    #            name, t0)
    handles: Dict[int, Any] = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


_state = _State()


def _require_init() -> None:
    if not _state.initialized:
        raise RuntimeError(
            "byteps_tpu_torch not initialized; call bps.init() first")


def _not_ported(name: str, item: str):
    def stub(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to byteps_tpu_torch yet (ROADMAP.md "
            f"Queue 1 item {item})")
    stub.__name__ = name
    stub.__doc__ = f"Not ported yet: ROADMAP.md Queue 1 item {item}."
    return stub


# ---------------------------------------------------------------------------
# Lifecycle and topology
# ---------------------------------------------------------------------------
def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def init() -> None:
    cfg = get_config(refresh=True)
    if cfg.enable_async:
        raise NotImplementedError(
            "BYTEPS_ENABLE_ASYNC needs the PS tier, which is not ported to "
            "byteps_tpu_torch yet (ROADMAP.md Queue 1 item 6)")
    set_level(cfg.log_level)
    if cfg.num_worker > 1 and not is_distributed():
        if torch.cuda.is_available():
            torch.cuda.set_device(cfg.local_rank)
        dist.init_process_group(
            backend="nccl" if torch.cuda.is_available() else "gloo",
            init_method=f"tcp://{cfg.scheduler_uri}:{cfg.scheduler_port}",
            world_size=cfg.num_worker, rank=cfg.worker_id)
    _state.config = cfg
    _state.initialized = True
    get_core().trace_enable(cfg.trace_on and cfg.trace_start_step
                            <= _state.step <= cfg.trace_end_step)
    set_rank(process_rank() if size() > 1 else None)
    get_logger().info("byteps_tpu_torch initialized: rank=%d/%d "
                      "local_rank=%d", rank(), size(), local_rank())


def shutdown() -> None:
    """Leave the process group; the declared-name registry stays, so keys
    are the same after ``resume``."""
    _maybe_dump_trace()
    if is_distributed():
        dist.destroy_process_group()
    set_rank(None)
    with _state.lock:
        _state.handles.clear()
    _state.initialized = False


def suspend() -> None:
    """Elastic suspend: tear down communication, keep the registry."""
    shutdown()


def resume(num_workers: int, num_servers: int = 0) -> None:
    """Elastic resume with a new cluster size: re-read the environment,
    rejoin, and re-declare every name in its original order, so the keys
    are unchanged.  Tensors cross the resize as they are (they live on
    their device, not in the process group)."""
    if _state.initialized:
        suspend()
    os.environ["DMLC_NUM_WORKER"] = str(num_workers)
    os.environ["DMLC_NUM_SERVER"] = str(num_servers)
    core = get_core()
    names = [core.declared_name(i) for i in range(core.num_declared())]
    init()
    for n in names:
        if n is not None:
            core.declare_tensor(n)


def process_rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if is_distributed() else 0


def rank() -> int:
    """The worker's rank: the ``BYTEPS_GLOBAL_RANK`` override first, as in
    the JAX package, else the process group's rank."""
    cfg = _state.config or get_config()
    if cfg.global_rank is not None:
        return cfg.global_rank
    return process_rank()


def size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def local_rank() -> int:
    return (_state.config or get_config()).local_rank


def local_size() -> int:
    return (_state.config or get_config()).local_size


# ---------------------------------------------------------------------------
# Declaration and keys
# ---------------------------------------------------------------------------
def declare(name: str) -> int:
    """Assign (or look up) the deterministic key of a named tensor."""
    return get_core().declare_tensor(name)


def declared_key(name: str) -> int:
    return get_core().get_declared_key(name)


def register_compressor(name: str, kwargs: dict) -> int:
    """The declared key of ``name``.  PS-wire compression is a PS-tier
    feature; outside it, as in the JAX package, this only declares (the
    collective plane compresses through ``DistributedOptimizer``)."""
    del kwargs
    _require_init()
    return declare(name)


def get_ps_session():
    """None: the port runs no PS session (ROADMAP.md Queue 1 item 6)."""
    return None


# ---------------------------------------------------------------------------
# Eager push_pull
# ---------------------------------------------------------------------------
def _debug_sample(stage: str, name: str, tensor: torch.Tensor) -> None:
    """BYTEPS_DEBUG_SAMPLE_TENSOR: write a sample of the named tensor to
    stderr at the eager path's host stages, push entry and after
    synchronize, for names that contain the setting.  Setting it is the
    opt-in, whatever BYTEPS_LOG_LEVEL says.  The tensor is copied to the
    host only when its name matches."""
    pat = (_state.config or get_config()).debug_sample_tensor
    if not pat or pat not in name:
        return
    arr = tensor.detach().reshape(-1).to("cpu", torch.float32)
    head = ", ".join(f"{v:.6g}" for v in arr[:4].tolist())
    sys.stderr.write(
        f"[byteps_tpu DEBUG_SAMPLE] {stage} name={name} "
        f"shape={tuple(tensor.shape)} dtype={_dtype_name(tensor.dtype)} "
        f"norm2={float(arr.norm()):.6g} sum={float(arr.sum()):.6g} "
        f"first=[{head}]\n")
    sys.stderr.flush()


def push_pull_async(tensor: torch.Tensor, name: Optional[str] = None,
                    average: bool = True, priority: int = 0,
                    compression=None) -> int:
    """Start a sum (or average) of ``tensor`` over the workers; returns a
    handle for ``synchronize``/``poll``.  The caller's tensor is not
    modified.  ``priority`` is accepted for API parity."""
    del priority
    _require_init()
    from ..ops.compression import Compression
    compression = compression or Compression.none
    core = get_core()
    if name is None:
        name = f"byteps_tpu.tensor_{core.num_declared()}"
    _debug_sample("push", name, tensor)
    declare(name)
    handle = core.handle_allocate()
    t0 = core.trace_now_us()
    wire, ctx = compression.compress(tensor.detach())
    work = None
    cfg = _state.config or get_config()
    if size() > 1 or (cfg.force_distributed and is_distributed()):
        # BYTEPS_FORCE_DISTRIBUTED takes the real reduce at world 1 too,
        # the JAX package's test hook; without a process group there is
        # nothing to reduce over and the tensor stays as it is.
        wire = wire.clone()
        work = dist.all_reduce(wire, async_op=True)
    core.telemetry_record(tensor.numel() * tensor.element_size())
    with _state.lock:
        _state.handles[handle] = (wire, work, compression, ctx, average,
                                  name, t0)
    return handle


def synchronize(handle: int) -> torch.Tensor:
    """Wait for the handle's reduce and return its result (a new tensor).
    ValueError for a handle never allocated or already synchronized."""
    with _state.lock:
        if handle not in _state.handles:
            raise ValueError(
                f"unknown or already-synchronized handle {handle}")
        wire, work, compression, ctx, average, name, t0 = \
            _state.handles.pop(handle)
    if work is not None:
        work.wait()
    out = compression.decompress(wire, ctx)
    if average:
        out = out / size()
    _debug_sample("pull", name, out)
    core = get_core()
    core.handle_mark_done(handle)
    core.trace_record(name, "PUSH_PULL", t0, core.trace_now_us() - t0)
    core.handle_release(handle)
    return out


def poll(handle: int) -> bool:
    """True once the handle's reduce has completed.  ValueError for a
    handle never allocated or already synchronized."""
    with _state.lock:
        entry = _state.handles.get(handle)
    if entry is None:
        if get_core().handle_poll(handle) == -1:
            raise ValueError(
                f"unknown or already-synchronized handle {handle}")
        return True
    work = entry[1]
    return work is None or work.is_completed()


def push_pull(tensor: torch.Tensor, name: Optional[str] = None,
              average: bool = True, priority: int = 0,
              compression=None) -> torch.Tensor:
    """Synchronous eager reduce across workers: a new tensor.  The training
    hot path is ``DistributedOptimizer`` / ``ops.collectives``."""
    return synchronize(push_pull_async(tensor, name=name, average=average,
                                       priority=priority,
                                       compression=compression))


def _dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's dtype string ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def push_pull_tree(tree: Tree, name: Optional[str] = None,
                   average: bool = True, compression=None,
                   leaf_names=None, fusion_bytes: Optional[int] = None
                   ) -> Tree:
    """Sum/average every leaf of a tree (nested dicts and lists of
    tensors, flattened as ``common.tree`` does) across workers.

    With fusion on (``BYTEPS_TPU_FUSION_BYTES`` > 0, default 1 MiB, or the
    ``fusion_bytes`` argument), floating leaves below the threshold pack
    into the fusion planner's dtype-homogeneous buckets, one named
    push_pull each at the max priority of its members; larger leaves go
    solo, and the units are dispatched by descending priority.  With it
    off, the floating leaves travel as one float32 vector.  Non-floating
    leaves always travel alone and exact.  ``leaf_names`` aligns with the
    flattened leaf order; unnamed leaves are named by the batch name and
    their path in the tree (``['key'][0]``), as in the JAX package.
    """
    _require_init()
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    paths = tree_paths(tree)
    metas = [(l.shape, l.dtype, l.numel()) for l in leaves]
    cfg = _state.config or get_config()
    fb = cfg.fusion_bytes if fusion_bytes is None else int(fusion_bytes)
    sep_idx = [i for i, l in enumerate(leaves) if not l.is_floating_point()]
    sep = set(sep_idx)
    batch_idx = [i for i in range(len(leaves)) if i not in sep]
    if name is None:
        sig = hashlib.md5("|".join(
            f"{p}:{tuple(s)}:{_dtype_name(d)}"
            for p, (s, d, _) in zip(paths, metas)).encode()).hexdigest()[:12]
        name = f"byteps_tpu.tree.{sig}"

    def leaf_name(i: int) -> str:
        return str(leaf_names[i]) if leaf_names is not None \
            else f"{name}{paths[i]}"

    outs: list = [None] * len(leaves)

    def scatter(members, vec) -> None:
        off = 0
        for li, n in members:
            shp, dt, _ = metas[li]
            outs[li] = vec[off:off + n].reshape(shp).to(dt)
            off += n

    if fb > 0 and len(batch_idx) > 1:
        from .fusion import plan_buckets
        plan = plan_buckets(tuple(
            (i, metas[i][2], _dtype_name(metas[i][1]),
             leaves[i].element_size()) for i in batch_idx), fb)
        plan.record_use()
        units = []     # (name, payload, priority, compression, members)
        for b in plan.buckets:
            packed = torch.cat([leaves[li].detach().reshape(-1)
                                for li, _ in b.members])
            units.append((f"{name}.{b.tag}", packed, b.priority,
                          compression, list(b.members)))
        for li, prio in plan.solo:
            units.append((leaf_name(li), leaves[li].detach().reshape(-1),
                          prio, compression, [(li, metas[li][2])]))
        for i in sep_idx:
            units.append((leaf_name(i), leaves[i].detach().reshape(-1), i,
                          None, [(i, metas[i][2])]))
        units.sort(key=lambda u: -u[2])
        handles = [push_pull_async(payload, name=nm, average=average,
                                   priority=prio, compression=comp)
                   for nm, payload, prio, comp, _ in units]
        for (_, _, _, _, members), h in zip(units, handles):
            scatter(members, synchronize(h))
        return tree_unflatten(tree, outs)
    for i in sep_idx:
        outs[i] = push_pull(leaves[i], name=leaf_name(i),
                            average=average).to(metas[i][1])
    if batch_idx:
        flat = torch.cat([leaves[i].detach().reshape(-1).float()
                          for i in batch_idx])
        scatter([(i, metas[i][2]) for i in batch_idx],
                push_pull(flat, name=name, average=average,
                          compression=compression))
    return tree_unflatten(tree, outs)


# ---------------------------------------------------------------------------
# Broadcast
# ---------------------------------------------------------------------------
def broadcast_parameters(params: Tree, root_rank: int = 0) -> Tree:
    """``params`` with root_rank's values on every worker: a new tree of
    the same structure.  Tensor leaves travel as they are; number leaves
    as float64 tensors, given back as their type."""
    _require_init()
    if size() == 1:
        return params
    leaves = tree_leaves(params)
    # NCCL moves CUDA tensors only: other leaves cross on the current card.
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    bufs, works = [], []
    for leaf in leaves:
        if torch.is_tensor(leaf):
            buf = leaf.detach().clone()
            if buf.device.type != dev.type:
                buf = buf.to(dev)
        else:
            buf = torch.tensor(float(leaf), dtype=torch.float64, device=dev)
        bufs.append(buf)
        works.append(dist.broadcast(buf, src=root_rank, async_op=True))
    for w in works:
        w.wait()
    out = [b.to(l.device) if torch.is_tensor(l) else type(l)(b.item())
           for l, b in zip(leaves, bufs)]
    return tree_unflatten(params, out)


def broadcast_optimizer_state(opt_state: Tree, root_rank: int = 0) -> Tree:
    """Optimizer-state counterpart of ``broadcast_parameters``."""
    return broadcast_parameters(opt_state, root_rank)


# ---------------------------------------------------------------------------
# Speed, step counter and trace window
# ---------------------------------------------------------------------------
def get_pushpull_speed() -> tuple:
    """(timestamp, MB/s): the bytes every push_pull of the last 10 seconds
    handed in, over 10 seconds (the JAX package's window)."""
    return (time.time(), get_core().telemetry_speed_mbps())


def mark_step() -> None:
    """Advance the training-step counter that drives the trace window
    (``BYTEPS_TRACE_ON``, ``BYTEPS_TRACE_START_STEP``/``END_STEP``): each
    step inside it records a STEP span beside the PUSH_PULL spans, and the
    step after the window writes ``<BYTEPS_TRACE_DIR>/<local_rank>/
    comm.json``."""
    cfg = _state.config or get_config()
    core = get_core()
    now = core.trace_now_us()
    if cfg.trace_on and _state.step_start_us is not None \
            and cfg.trace_start_step <= _state.step <= cfg.trace_end_step:
        core.trace_record(f"step_{_state.step}", "STEP",
                          _state.step_start_us, now - _state.step_start_us)
    _state.step += 1
    _state.step_start_us = now
    if cfg.trace_on:
        core.trace_enable(cfg.trace_start_step <= _state.step
                          <= cfg.trace_end_step)
        if _state.step == cfg.trace_end_step + 1:
            _maybe_dump_trace()


def current_step() -> int:
    return _state.step


def _maybe_dump_trace() -> None:
    cfg = _state.config or get_config()
    core = get_core()
    if not cfg.trace_on or core.trace_count() == 0:
        return
    d = os.path.join(cfg.trace_dir, str(local_rank()))
    os.makedirs(d, exist_ok=True)
    core.trace_dump(os.path.join(d, "comm.json"), rank())


# ---------------------------------------------------------------------------
# Not ported yet
# ---------------------------------------------------------------------------
push_pull_sparse = _not_ported("push_pull_sparse", "6")
drain_ps_server = _not_ported("drain_ps_server", "6")
leave = _not_ported("leave", "6")
get_membership = _not_ported("get_membership", "6")
on_membership_change = _not_ported("on_membership_change", "6")
get_ring = _not_ported("get_ring", "6")
get_codec_stats = _not_ported("get_codec_stats", "7")
get_transport_stats = _not_ported("get_transport_stats", "7")
get_metrics = _not_ported("get_metrics", "7")
get_server_stats = _not_ported("get_server_stats", "7")
get_health = _not_ported("get_health", "7")
get_audit = _not_ported("get_audit", "7")
get_key_signals = _not_ported("get_key_signals", "7")
get_diagnosis = _not_ported("get_diagnosis", "7")
get_tuner = _not_ported("get_tuner", "7")
get_hierarchy = _not_ported("get_hierarchy", "7")
get_autoscaler = _not_ported("get_autoscaler", "7")
get_fleet = _not_ported("get_fleet", "7")
get_device_profile = _not_ported("get_device_profile", "7")
