"""Hybrid-parallel transformer: one train step over all five mesh axes.

Counterpart of ``byteps_tpu/models/hybrid.py``: a transformer LM
(optionally Switch-MoE) whose train step runs per rank on its blocks of
the batch and the parameters, as the JAX step runs under ``shard_map``,
and composes

  - dp x ep : batch sharding (expert ranks double as data ranks),
  - sp      : sequence sharding with ring attention (ops/ring_attention),
  - tp      : Megatron column/row sharded projections (parallel/tensor_
              parallel — separate wq/wk/wv so head sharding stays clean),
  - pp      : SPMD GPipe over stacked layer slices (parallel/pipeline),
  - ep      : Switch-MoE expert dispatch (parallel/expert),

each over its process group of the ``DeviceMesh`` (``parallel/mesh.py``);
a group of one rank makes its collectives the identity.

Gradient synchronization is explicit and per parameter group:

  group                         grads summed over
  ------------------------------------------------
  non-stage (embed/pos/ln_f)    dp, ep, sp, pp   (loss masked to the last
                                                  pp rank so embed's head
                                                  path and input path sum
                                                  correctly)
  stage, dense/tp               dp, ep, sp       (owned per pp rank)
  stage, expert (ffn_e_*)       dp, sp           (owned per (pp, ep) rank)

The Switch load-balancing aux loss is folded in whenever
``aux_loss_weight > 0``, under pp too: each stage accumulates its own aux
over its real microbatch ticks (``gpipe_spmd(with_aux=True)``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..common.device import DeviceLike, resolve_device
from ..common.tree import tree_leaves, tree_map, tree_paths, tree_unflatten
from ..ops import collectives
from ..ops.ring_attention import ring_attention_shard
from ..parallel import pipeline as pp_mod
from ..parallel import tensor_parallel as tp_mod
from ..parallel.expert import moe_core
from ..parallel.mesh import axes_group
from ..parallel.sharded import PartitionSpec as P
from ..parallel.sharded import _entry_axes, _shard_free_axis

Tree = Any


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    vocab_size: int = 1024
    num_layers: int = 4
    d_model: int = 64
    num_heads: int = 4
    d_ff: int = 128
    max_seq_len: int = 128
    num_experts: int = 0          # 0 = dense MLP in every block
    capacity_factor: float = 2.0
    #: Switch load-balancing aux-loss weight (0 = off).  The aux term is an
    #: expectation over the LOCAL token shard, so its value depends
    #: (mildly) on the sharding layout.
    aux_loss_weight: float = 0.0
    dtype: torch.dtype = torch.float32
    causal: bool = True
    #: > 0 streams the LM-head cross-entropy in row chunks of this size
    #: (transformer.fused_nll_sum); 0 = full-logits path.
    ce_chunk_rows: int = 0

    @property
    def head_dim(self):
        return self.d_model // self.num_heads


def param_shapes(cfg: HybridConfig) -> Tree:
    """The parameter tree's shapes (before ``stage_params``)."""
    L, D, F_, E = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.num_experts
    layers = {"wq": (L, D, D), "wk": (L, D, D), "wv": (L, D, D),
              "wo": (L, D, D), "ln1_scale": (L, D), "ln1_bias": (L, D),
              "ln2_scale": (L, D), "ln2_bias": (L, D)}
    if E > 0:
        layers.update({"gate_w": (L, D, E), "ffn_e_in": (L, E, D, F_),
                       "ffn_e_out": (L, E, F_, D)})
    else:
        layers.update({"mlp_in": (L, D, F_), "mlp_out": (L, F_, D)})
    return {"embed": (cfg.vocab_size, D), "pos": (cfg.max_seq_len, D),
            "ln_f_scale": (D,), "ln_f_bias": (D,), "layers": layers}


# Each weight's fan-in: the dim its init divides by (normal / sqrt(fan_in)).
_FAN_IN = {"wq": -2, "wk": -2, "wv": -2, "wo": -2, "gate_w": -2,
           "ffn_e_in": -2, "ffn_e_out": -2, "mlp_in": -2, "mlp_out": -2,
           "embed": -1}


def init_params(generator: torch.Generator, cfg: HybridConfig,
                device: DeviceLike = None) -> Tree:
    """Random parameters from ``generator``: normal/sqrt(fan_in) weights,
    0.02-scaled positions, unit norm scales, zero biases (the JAX
    package's init, other numbers), float32."""
    dev = resolve_device(device)

    def make(name, shape):
        if name in _FAN_IN:
            t = torch.randn(shape, generator=generator,
                            device=generator.device)
            t = t / math.sqrt(shape[_FAN_IN[name]])
        elif name == "pos":
            t = 0.02 * torch.randn(shape, generator=generator,
                                   device=generator.device)
        elif name.endswith("_scale"):
            t = torch.ones(shape)
        else:
            t = torch.zeros(shape)
        return t.to(dev).requires_grad_()

    shapes = param_shapes(cfg)
    out = {k: make(k, s) for k, s in shapes.items() if k != "layers"}
    out["layers"] = {k: make(k, s) for k, s in shapes["layers"].items()}
    return out


def params_from_numpy(tree: Tree, cfg: HybridConfig,
                      device: DeviceLike = None) -> Tree:
    """The JAX package's parameter tree as numpy arrays (before
    ``stage_params``) as this package's parameters."""
    dev = resolve_device(device)

    def convert(node, want):
        if isinstance(want, dict):
            if set(node) != set(want):
                raise ValueError(f"param keys {sorted(node)} != expected "
                                 f"{sorted(want)}")
            return {k: convert(node[k], want[k]) for k in want}
        arr = np.asarray(node, dtype=np.float32)
        if tuple(arr.shape) != tuple(want):
            raise ValueError(f"param shape {arr.shape} != expected {want}")
        return torch.tensor(arr, device=dev).requires_grad_()

    return convert(tree, param_shapes(cfg))


def param_specs(cfg: HybridConfig) -> Tree:
    """Global PartitionSpecs; stacked layers carry the pp axis leading (after
    ``stage_params`` reshaping to [pp, L/pp, ...])."""
    layers = {
        "wq": P("pp", None, None, "tp"),
        "wk": P("pp", None, None, "tp"),
        "wv": P("pp", None, None, "tp"),
        "wo": P("pp", None, "tp", None),
        "ln1_scale": P("pp", None, None), "ln1_bias": P("pp", None, None),
        "ln2_scale": P("pp", None, None), "ln2_bias": P("pp", None, None),
    }
    if cfg.num_experts > 0:
        layers.update({
            "gate_w": P("pp", None, None, None),
            "ffn_e_in": P("pp", None, "ep", None, None),
            "ffn_e_out": P("pp", None, "ep", None, None),
        })
    else:
        layers.update({
            "mlp_in": P("pp", None, None, "tp"),
            "mlp_out": P("pp", None, "tp", None),
        })
    return {
        "embed": P(None, None),
        "pos": P(None, None),
        "ln_f_scale": P(None), "ln_f_bias": P(None),
        "layers": layers,
    }


def stage_params(params: Tree, pp: int) -> Tree:
    """[L, ...] stacked layers -> [pp, L/pp, ...] for the pp axis."""
    out = dict(params)
    out["layers"] = pp_mod.shard_stage_params(params["layers"], pp)
    return out


def _ln(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)   # population variance
    return ((x32 - mu) * torch.rsqrt(var + eps) * scale + bias).to(x.dtype)


def _block(lp, x, cfg: HybridConfig, f_tp, g_tp, groups):
    """One hybrid block on a local activation x: [mb, s_local, D].
    Returns (x, aux) — aux is the MoE load-balancing loss (0 for dense).
    ``groups`` maps "sp" and "ep" to their process groups."""
    mb, s, D = x.shape
    dh = cfg.head_dim

    h = _ln(x, lp["ln1_scale"], lp["ln1_bias"])
    h = f_tp(h)                                   # Megatron f
    q = h @ lp["wq"]                              # [mb, s, D/tp]
    k = h @ lp["wk"]
    v = h @ lp["wv"]

    def heads(t):
        return t.reshape(mb, s, -1, dh).transpose(1, 2)
    attn = ring_attention_shard(heads(q), heads(k), heads(v),
                                causal=cfg.causal, group=groups["sp"])
    attn = attn.transpose(1, 2).reshape(mb, s, -1)
    y = g_tp(attn @ lp["wo"])                    # Megatron g
    x = x + y

    h2 = _ln(x, lp["ln2_scale"], lp["ln2_bias"])
    if cfg.num_experts > 0:
        y2, aux = moe_core(lp["gate_w"], lp["ffn_e_in"], lp["ffn_e_out"],
                           h2.reshape(mb * s, D), cfg.capacity_factor,
                           groups["ep"])
        y2 = y2.reshape(mb, s, D)
    else:
        a = F.gelu(f_tp(h2) @ lp["mlp_in"], approximate="tanh")
        y2 = g_tp(a @ lp["mlp_out"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y2, aux


def _stage_fn(local_layers, x, cfg: HybridConfig, f_tp, g_tp, groups):
    """Apply this pp rank's layer slice ([L/pp, ...] stacked) to x.
    Returns (out, aux_sum over this stage's layers)."""
    names = sorted(local_layers)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for leaves in zip(*(torch.unbind(local_layers[n], 0) for n in names)):
        x, a = _block(dict(zip(names, leaves)), x, cfg, f_tp, g_tp, groups)
        aux = aux + a
    return x, aux


def _coord(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _local_block(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a global tensor under ``spec`` (a dim split
    over several axes takes them major first)."""
    coord = _coord(mesh)
    for dim, entry in enumerate(spec):
        n, idx = 1, 0
        for a in _entry_axes(entry):
            n, idx = n * _size(mesh, a), idx * _size(mesh, a) + coord[a]
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


def _global_shape(local, spec, mesh) -> tuple:
    return tuple(s * math.prod(_size(mesh, a) for a in _entry_axes(e))
                 for s, e in zip(local.shape, list(spec) + [None] *
                                 (local.ndim - len(spec))))


def build_hybrid_train_step(
    cfg: HybridConfig,
    optimizer,
    mesh,
    num_microbatches: int = 1,
    donate: bool = False,
    zero1: bool = False,
):
    """Returns (step, init_fn).  ``step(params, (tokens, targets)) -> loss``
    runs this rank's part of the step over ``mesh`` (``make_mesh``'s five
    axes) and updates ``params``, this rank's blocks, in place; the loss
    returned is the global one.  ``init_fn(generator)`` gives those blocks
    from fresh random params (``init_fn(tree)`` from a whole tree, e.g.
    ``params_from_numpy``'s), stacked layers reshaped for pp, on the
    mesh's device type.

    tokens/targets: the global [B, S] on every rank, B divisible by
    dp*ep*microbatches and S by sp.

    ``optimizer`` is ``make_optimizer(leaves) -> torch.optim.Optimizer``
    (optax's ``(init, update)`` has no torch counterpart): the step builds
    it on its first call over this rank's leaves and keeps it as
    ``step.optimizer`` (again for another params tree).  ``donate`` is
    accepted for parity: the update is in place.

    ``zero1=True`` additionally shards the optimizer state over 'dp': each
    param spec gains the dp axis on its first free dp-divisible dimension
    (leaves of at least 1,024 elements); the optimizer runs over those 1/dp
    shards, whose gradients arrive reduce-scattered over dp, and the
    updated shards are all-gathered back — Adam moments drop to 1/dp per
    rank.  At dp=1 the step is identical to zero1=False.
    """
    del donate
    names = tuple(mesh.mesh_dim_names)
    pp = _size(mesh, "pp")
    specs = param_specs(cfg)
    spec_leaves = tree_leaves(specs)
    dev = resolve_device(mesh.device_type)
    # Every rank makes every group, in this order (axes_group).
    groups = {a: mesh.get_group(a) for a in names}
    sums = {axes: axes_group(mesh, axes) for axes in (
        ("dp", "ep", "sp", "pp"), ("dp", "ep", "sp"), ("dp", "sp"),
        ("ep", "sp", "pp"), ("ep", "sp"), ("sp",))}
    f_tp = tp_mod.copy_to(groups["tp"])
    g_tp = tp_mod.reduce_from(groups["tp"])
    run = functools.partial(_stage_fn, cfg=cfg, f_tp=f_tp, g_tp=g_tp,
                            groups=groups)

    def loss_fn(params, tokens, targets):
        # [B_loc, S_loc] on this (dp, ep, sp) coordinate; replicated over tp
        # and pp.
        B, S = tokens.shape
        coord = _coord(mesh)
        x = params["embed"][tokens].to(cfg.dtype)
        sp_idx = coord["sp"]
        x = x + params["pos"][sp_idx * S:(sp_idx + 1) * S].to(cfg.dtype)
        # The local stage slice [1, L/pp, ...]: drop the leading singleton.
        local_layers = {k: v[0] for k, v in params["layers"].items()}
        if pp > 1:
            x, aux = pp_mod.gpipe_spmd(run, local_layers, x,
                                       num_microbatches, group=groups["pp"],
                                       with_aux=True)
            # Per-microbatch aux terms are means over mb tokens; averaging
            # over M matches the single-pass (pp=1) per-token mean.
            aux = aux / num_microbatches
        else:
            x, aux = run(local_layers, x)

        x = _ln(x, params["ln_f_scale"], params["ln_f_bias"])
        if cfg.ce_chunk_rows:
            from .transformer import fused_nll_sum
            nll_sum = fused_nll_sum(x, params["embed"], targets,
                                    cfg.ce_chunk_rows)
        else:
            logits = torch.einsum("bsd,vd->bsv", x.float(), params["embed"])
            logp = torch.log_softmax(logits, dim=-1)
            nll_sum = -logp.gather(-1, targets[..., None]).sum()
        # Normalize by the GLOBAL token count.
        denom = (B * _size(mesh, "dp") * _size(mesh, "ep")
                 * S * _size(mesh, "sp"))
        loss = nll_sum / denom
        # Mask the token loss to the last pp stage so the sum over pp
        # double-counts neither the head path nor the input path of the
        # shared embedding (a mask, not a branch: every rank keeps the same
        # graph, so the backward's collectives meet).  The aux term stays
        # unmasked: each pp rank owns the aux of its layer slice.
        last = torch.tensor(coord["pp"] == pp - 1, device=loss.device)
        loss = torch.where(last, loss, torch.zeros_like(loss))
        if cfg.num_experts > 0 and cfg.aux_loss_weight > 0.0:
            # Mean aux over layers and over the (dp, ep, sp) shards.
            shards = (_size(mesh, "dp") * _size(mesh, "ep")
                      * _size(mesh, "sp"))
            loss = loss + cfg.aux_loss_weight * aux / (
                cfg.num_layers * shards)
        return loss

    def nondp_axes(path: str):
        if "['layers']" in path:
            return ("sp",) if "['ffn_e" in path else ("ep", "sp")
        return ("ep", "sp", "pp")

    # The dim each leaf's 1/dp shard lives on under zero1, or -1.
    def dp_dims(params):
        if not zero1 or _size(mesh, "dp") == 1:
            return [-1] * len(spec_leaves)
        shapes = tree_unflatten(specs, [
            _global_shape(p, s, mesh)
            for p, s in zip(tree_leaves(params), spec_leaves)])
        up = tree_leaves(_shard_free_axis(specs, shapes, mesh, "dp", 1024))
        return [next((i for i, e in enumerate(new) if e == "dp"), -1)
                for new in up]

    def build(params):
        """The optimizer over this rank's leaves, or their dp shards."""
        leaves = tree_leaves(params)
        axes = dp_dims(params)
        dp_group, n = groups["dp"], _size(mesh, "dp")
        me = _coord(mesh)["dp"]
        shards = []
        for p, ax in zip(leaves, axes):
            if ax < 0:
                shards.append(p)
            else:
                size = p.shape[ax] // n
                shards.append(p.detach().narrow(ax, me * size, size).clone()
                              .requires_grad_())
        step.optimizer = optimizer(shards)
        step._state = (leaves, axes, shards, dp_group)

    def step(params, batch):
        leaves = tree_leaves(params)
        if step._state is None or len(step._state[0]) != len(leaves) or any(
                a is not b for a, b in zip(step._state[0], leaves)):
            build(params)
        _, axes, shards, dp_group = step._state
        tokens, targets = batch
        bspec = P(("dp", "ep"), "sp")
        tok = _local_block(tokens, bspec, mesh).to(dev)
        tgt = _local_block(targets, bspec, mesh).to(dev)
        for p in leaves + shards:
            p.grad = None
        loss = loss_fn(params, tok, tgt)
        loss.backward()
        for p, s, ax, path in zip(leaves, shards, axes, tree_paths(params)):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            nondp = nondp_axes(path)
            if ax < 0:
                p.grad = collectives.all_reduce(g, sums[("dp",) + nondp])
            else:
                g = collectives.all_reduce(g, sums[nondp])
                s.grad = collectives.reduce_scatter(g, dp_group, axis=ax)
        step.optimizer.step()
        with torch.no_grad():
            for p, s, ax in zip(leaves, shards, axes):
                if ax >= 0:
                    p.copy_(collectives.all_gather(s.detach(), dp_group,
                                                   axis=ax))
        return collectives.all_reduce(loss.detach().clone(),
                                      sums[("dp", "ep", "sp", "pp")])

    step.optimizer = None
    step._state = None

    def init_fn(init):
        full = (init_params(init, cfg, device=dev)
                if isinstance(init, torch.Generator) else init)
        staged = stage_params(full, pp)
        return tree_map(lambda t, s: _local_block(t.detach(), s, mesh)
                        .to(dev).clone().requires_grad_(), staged, specs)

    return step, init_fn
