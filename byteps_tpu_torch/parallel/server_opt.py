"""Server-resident optimizer training: push gradients, pull *parameters*.

Counterpart of ``byteps_tpu/parallel/server_opt.py``.  Under the sum-only
PS contract every worker pulls the whole gradient sum and runs the whole
optimizer itself, N times over, holding N copies of its state.  This
trainer switches its key's publish stage into parameter mode (CMD_OPT):
each partition's owner runs the optimizer step ONCE on the merged sum and
publishes the updated parameters.  Workers push gradients as before and
adopt the pulled parameters; the update is sharded server by server along
the partitions.

Two modes, one trainer:

- ``mode="server"``: ``session.arm_server_opt`` declares the optimizer
  (epoch-versioned) and seeds the initial parameters; each ``step(grads)``
  is one push_pull whose pull IS the updated parameters.  The worker holds
  no optimizer state (``opt_state_bytes() == 0``); the server's
  ``opt_slot_bytes`` counts it.
- ``mode="local"``: pull the sum and run the same optimizer here, on the
  parameters' device, where its state lives.  The law is that both modes
  give bit-equal float32 parameters round by round, so the local step is
  plain float32 torch ops in the server's order (``OptUpdateStage``,
  ``core/server.cc``): one rounding an op, no fused multiply-add, scalars
  as 0-dim float32 tensors on the device (on CUDA PyTorch turns a division
  by a CPU scalar into a multiplication by its reciprocal), the square root
  correctly rounded (``sqrt_f32``), and Adam's bias correction by float32
  square-and-multiply, never ``pow``.  The JAX
  package's local mode is optax under ``jax.disable_jit()``, which the
  server's stage matches op for op too.

The default mode comes from ``BYTEPS_TPU_SERVER_OPT`` (1 = server,
otherwise local).  Drain and scale-up migrate the server's slots
byte-equal; after a SIGKILL failover the session re-declares the
optimizer and re-seeds parameters from this trainer's view
(``params_fn``): SGD recovers bit for bit, momentum and Adam slots restart
zeroed (docs/server-optimizer.md "Failover").
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from ..common.tree import FlatHost
from .hierarchy import maybe_reducer, not_ported_reducer

Tree = Any

#: optimizer name -> hyperparameters, filled with optax's defaults so that
#: the kwargs string the server parses is always explicit.
_DEFAULTS = {
    "sgd": {"lr": 0.01},
    "momentum": {"lr": 0.01, "mu": 0.9},
    "adam": {"lr": 0.001, "b1": 0.9, "b2": 0.999, "eps": 1e-8},
}


def _canonical_opt_kwargs(opt_kwargs: dict, grad_scale: float) -> dict:
    kw = {str(k): v for k, v in dict(opt_kwargs).items()}
    name = str(kw.pop("opt", "sgd"))
    if name not in _DEFAULTS:
        raise ValueError(
            f"server-resident optimizer {name!r} not supported "
            f"(have: {sorted(_DEFAULTS)})")
    full = dict(_DEFAULTS[name])
    for k, v in kw.items():
        if k not in full:
            raise ValueError(
                f"unknown hyperparam {k!r} for server optimizer "
                f"{name!r} (have: {sorted(full)})")
        full[k] = float(v)
    full = {k: float(v) for k, v in full.items()}
    full["opt"] = name
    if float(grad_scale) != 1.0:
        full["gscale"] = float(grad_scale)
    return full


def int_pow_f32(x, y: int) -> np.float32:
    """``x ** y`` by square-and-multiply, rounded to float32 at every
    multiply: the server's ``IntPowF32``."""
    x = np.float32(x)
    if y == 0:
        return np.float32(1.0)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else np.float32(acc * x)
        y >>= 1
        if y > 0:
            x = np.float32(x * x)
    return acc


class _LocalOpt:
    """The server's update stage on a flat float32 tensor, op for op."""

    def __init__(self, kw: dict, n: int, device: torch.device):
        self.kind = kw["opt"]
        self.device = device
        self.nlr = self._scalar(-1.0 * kw["lr"])
        self.slots = []
        if self.kind == "momentum":
            self.mu = self._scalar(kw["mu"])
            self.slots = [torch.zeros(n, dtype=torch.float32, device=device)]
        elif self.kind == "adam":
            self.b1, self.b2 = np.float32(kw["b1"]), np.float32(kw["b2"])
            self.onemb1 = self._scalar(1.0 - kw["b1"])
            self.onemb2 = self._scalar(1.0 - kw["b2"])
            self.eps = self._scalar(kw["eps"])
            self.slots = [torch.zeros(n, dtype=torch.float32, device=device)
                          for _ in range(2)]
        self.count = 0

    def _scalar(self, v) -> torch.Tensor:
        return torch.tensor(np.float32(v), device=self.device)

    def update(self, p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The parameters after one step on gradient ``g``."""
        self.count = min(self.count + 1, 2147483647)
        if self.kind == "sgd":
            return torch.add(p, torch.mul(self.nlr, g))
        if self.kind == "momentum":
            m = torch.add(g, torch.mul(self.mu, self.slots[0]))
            self.slots[0] = m
            return torch.add(p, torch.mul(self.nlr, m))
        m, v = self.slots
        m = torch.add(torch.mul(self.onemb1, g),
                      torch.mul(self._scalar(self.b1), m))
        v = torch.add(torch.mul(self.onemb2, torch.mul(g, g)),
                      torch.mul(self._scalar(self.b2), v))
        self.slots = [m, v]
        one = np.float32(1.0)
        bc1 = self._scalar(one - int_pow_f32(self.b1, self.count))
        bc2 = self._scalar(one - int_pow_f32(self.b2, self.count))
        mh = torch.div(m, bc1)
        vh = torch.div(v, bc2)
        u = torch.mul(self.nlr,
                      torch.div(mh, torch.add(sqrt_f32(vh), self.eps)))
        return torch.add(p, u)


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as ``std::sqrt`` gives
    it: taken in float64 and rounded once to float32, which is exact for a
    float32 input.  ``torch.sqrt`` on a float32 CPU tensor is vectorized
    to within 0.5001 ulp and misses the rounding of a few elements in a
    thousand."""
    return torch.sqrt(x.double()).float()


class ServerOptTrainer:
    """Sync training whose optimizer step runs on the PS tier.

    Usage::

        trainer = ServerOptTrainer(session, params,
                                   {"opt": "adam", "lr": 1e-3},
                                   name="model", grad_scale=1.0 / N)
        for batch in data:
            grads = grad_fn(trainer.params, batch)
            trainer.step(grads)      # push grads, adopt updated params

    ``grad_scale`` multiplies the merged gradient SUM before the optimizer
    reads it (1/N averages; 1.0, the default, is the raw sum), the same in
    both modes.  Params and gradients are trees of tensors; ``params``
    hands back tensors on the caller's devices and in its dtypes.  Local
    mode runs on the device of the first leaf.  ``hierarchy`` (the
    hierarchical reducer) is not ported: a value, or
    ``BYTEPS_TPU_HIERARCHY=1``, raises ``NotImplementedError``.
    """

    def __init__(self, session, params: Tree, opt_kwargs: dict,
                 name: str = "serveropt",
                 declared_key: Optional[int] = None,
                 mode: Optional[str] = None,
                 grad_scale: float = 1.0,
                 hierarchy=None):
        if getattr(session, "server_async", False):
            raise RuntimeError(
                "ServerOptTrainer needs sync rounds; against an async "
                "server there is no merge boundary for the update stage "
                "(use AsyncPSTrainer there)")
        if mode is None:
            mode = ("server"
                    if os.environ.get("BYTEPS_TPU_SERVER_OPT", "0") == "1"
                    else "local")
        if mode not in ("server", "local"):
            raise ValueError(f"mode must be 'server' or 'local', "
                             f"got {mode!r}")
        if hierarchy is not None:
            raise not_ported_reducer()
        maybe_reducer(session)
        self._session = session
        self.mode = mode
        self._grad_scale = float(grad_scale)
        self._kw = _canonical_opt_kwargs(opt_kwargs, grad_scale)
        self._view = FlatHost(params)
        if declared_key is None:
            from ..common.api import _session_declare
            declared_key = _session_declare(f"ServerOpt.{name}")
        self._key = declared_key
        self._flat = self._view.flatten(params)
        self._rounds = 0
        #: The device local mode's step and state live on (None in
        #: server mode).
        self.device = None
        if mode == "server":
            # Armed from round 0, before the first push, so that every
            # pull this trainer adopts is parameters; params_fn is the
            # failover re-seed source.
            self._opt = None
            session.arm_server_opt(
                declared_key, self._flat, self._kw,
                params_fn=lambda: self._flat, effective_round=0)
        else:
            self.device = dev = self._view.devices[0]
            self._opt = _LocalOpt(self._kw, self._flat.size, dev)
            self._p = torch.from_numpy(self._flat).to(dev, copy=True)
            self._gscale = self._opt._scalar(self._grad_scale)

    @property
    def params(self) -> Tree:
        """The current parameters, as the caller's tree."""
        return self._view.unflatten(self._flat)

    @property
    def rounds(self) -> int:
        return self._rounds

    def opt_state_bytes(self) -> int:
        """Optimizer-state bytes THIS worker holds (0 in server mode)."""
        if self._opt is None:
            return 0
        return sum(t.numel() * t.element_size() for t in self._opt.slots)

    def step(self, grads: Tree, timeout: Optional[float] = 300.0) -> Tree:
        """Push one round's gradients and adopt the updated parameters:
        in server mode the pull is them; in local mode the pull is the
        gradient sum, and the same step runs here."""
        flat_g = self._view.flatten(grads)
        handle = self._session.push_pull_async(self._key, flat_g)
        pulled = np.asarray(handle.wait(timeout), np.float32).ravel()
        if self._opt is None:
            self._flat = pulled
        else:
            from ..common import devprof

            g = torch.from_numpy(np.ascontiguousarray(pulled)).to(
                self.device)
            if self._grad_scale != 1.0:
                g = torch.mul(self._gscale, g)
            # The local update is this trainer's device work (server mode
            # runs it on the PS tier).
            tok = devprof.step_begin()
            self._p = self._opt.update(self._p, g)
            devprof.step_end(tok, self._p)
            self._flat = self._p.cpu().numpy()
        self._rounds += 1
        return self.params

    def server_docs(self) -> dict:
        """The servers' per-partition optimizer docs (param_version,
        slots_crc, ...); empty in local mode."""
        if self.mode != "server":
            return {}
        return self._session.fetch_opt_docs(self._key)
