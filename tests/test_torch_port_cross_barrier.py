"""byteps_tpu_torch's cross-barrier drivers vs the JAX package's.

``CrossBarrierDriver`` (parallel/cross_barrier.py) around the port's
in-place step: its losses and final params equal a plain loop's bit for
bit, and its credit gate resolves a loss at exactly the submits where
JAX's driver does, on a counting fake step given to both.

``CrossBarrier`` (torch/cross_barrier.py) on the port's eager surface: the
five scenarios of tests/test_torch_cross_barrier.py (four optimizers
against the vanilla one, a forward overlapping a pending sync through the
injected comm, a live LR schedule, close(), accumulation), and the
reference's ``byteps_tpu.torch.CrossBarrier`` and the port's on the same
model and batches at world 1.
"""

import threading
import time

import numpy as np
import pytest
import torch

import byteps_tpu as jbps
import byteps_tpu.torch as jhvd
import byteps_tpu_torch as bps
import byteps_tpu_torch.torch as hvd
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import mlp
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)


# ---------------------------------------------------------------------------
# CrossBarrierDriver
# ---------------------------------------------------------------------------
def _mlp_step():
    params = mlp.init_params(torch.Generator().manual_seed(0), (16, 32, 4),
                             device="cpu")
    opt = bps.DistributedOptimizer(torch.optim.SGD(tree_leaves(params),
                                                   lr=0.1))
    return params, bps.build_train_step(mlp.loss_fn, opt, device="cpu")


def _batches(n):
    rng = np.random.RandomState(1)
    out = []
    for _ in range(n):
        x = rng.randn(32, 16).astype(np.float32)
        out.append((torch.from_numpy(x),
                    torch.from_numpy((x.sum(-1) > 0).astype(np.int64))))
    return out


@pytest.mark.parametrize("max_in_flight", [1, 3])
def test_driver_equals_the_plain_loop(max_in_flight):
    batches = _batches(6)
    params, step = _mlp_step()
    plain = [float(step(params, b)) for b in batches]
    want = [p.detach().clone() for p in tree_leaves(params)]

    params, step = _mlp_step()
    drv = bps.CrossBarrierDriver(step, params, max_in_flight=max_in_flight)
    for b in batches:
        drv.submit(b)
        assert len(drv._pending) <= max_in_flight
    assert drv.finish() is params
    assert drv.losses() == plain
    for a, b in zip(tree_leaves(params), want):
        assert torch.equal(a, b)
    params, step = _mlp_step()
    got, losses = bps.run_cross_barrier(step, params, batches, 2)
    assert losses == plain
    for a, b in zip(tree_leaves(got), want):
        assert torch.equal(a, b)


class _Loss:
    """A loss whose resolution is recorded, by ``float`` (JAX's driver) or
    by ``.item()`` (the port's)."""

    def __init__(self, i, log):
        self.i, self.log = i, log

    def item(self):
        self.log.append(("resolve", self.i))
        return float(self.i)

    __float__ = item


@pytest.mark.parametrize("max_in_flight", [1, 2, 3])
def test_credit_gate_blocks_where_jax_does(max_in_flight):
    """The same counting fake step through both drivers: the order of
    dispatches and resolutions, the losses and the returned state."""
    logs = []
    for functional in (True, False):
        log = []
        if functional:
            def step(params, opt_state, batch):
                log.append(("dispatch", batch))
                return params + 1, opt_state, _Loss(batch, log)
            drv = jbps.CrossBarrierDriver(step, 0, "state", max_in_flight)
        else:
            def step(params, batch):
                log.append(("dispatch", batch))
                params.append(batch)
                return _Loss(batch, log)
            drv = bps.CrossBarrierDriver(step, [], max_in_flight)
        for b in range(7):
            drv.submit(b)
            log.append(("returned", b))
        state = drv.finish()
        assert drv.losses() == [float(b) for b in range(7)]
        assert state == ((7, "state") if functional else list(range(7)))
        logs.append(log)
    assert logs[0] == logs[1]
    first = logs[1].index(("resolve", 0))
    assert logs[1][first - 1] == ("dispatch", max_in_flight)


def test_driver_refuses_no_credit():
    with pytest.raises(ValueError, match="max_in_flight"):
        jbps.CrossBarrierDriver(lambda *a: a, None, None, max_in_flight=0)
    with pytest.raises(ValueError, match="max_in_flight"):
        bps.CrossBarrierDriver(lambda *a: a, None, max_in_flight=0)


# ---------------------------------------------------------------------------
# CrossBarrier (the Horovod face)
# ---------------------------------------------------------------------------
@pytest.fixture
def both():
    jhvd.init()
    hvd.init()
    yield
    hvd.shutdown()
    jhvd.shutdown()


def _model(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(
        torch.nn.Linear(6, 12), torch.nn.Tanh(),
        torch.nn.Linear(12, 12), torch.nn.Tanh(),
        torch.nn.Linear(12, 1))


def _data():
    torch.manual_seed(42)
    x = torch.randn(16, 6)
    return x, x.sum(dim=1, keepdim=True)


def _loss(m, x, y):
    return torch.nn.functional.mse_loss(m(x), y)


def _assert_close(ref, m):
    for (n, a), (_, b) in zip(ref.named_parameters(), m.named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def _vanilla(opt_cls, kw):
    """At world 1 the averaged gradient is the local one: the per-param
    updates change when updates happen, never their math."""
    x, y = _data()
    ref = _model()
    ref_opt = opt_cls(ref.parameters(), **kw)
    for _ in range(4):
        ref_opt.zero_grad()
        _loss(ref, x, y).backward()
        ref_opt.step()
    m = _model()
    cb = hvd.CrossBarrier(m, opt_cls(m.parameters(), **kw),
                          named_parameters=m.named_parameters())
    try:
        for _ in range(4):
            _loss(m, x, y).backward()
            cb.step()
        cb.synchronize()
    finally:
        cb.close()
    _assert_close(ref, m)


def _overlap():
    """Step N+1's forward enters the input layer while step N's last-layer
    gradient is still pending behind a gate in the injected comm."""
    events = []
    gate = threading.Event()
    slow_name = "CrossBarrier.Gradient.4.weight"  # last Linear's weight

    def dispatch(p, name):
        return (p, name)

    def poll(handle):
        return handle[1] != slow_name or gate.is_set()

    def wait(handle):
        if handle[1] == slow_name:
            events.append(("slow_sync_done", time.monotonic()))

    m = _model()
    cb = hvd.CrossBarrier(m, torch.optim.SGD(m.parameters(), lr=0.01),
                          named_parameters=m.named_parameters(),
                          comm=(dispatch, wait, poll))
    m[0].register_forward_pre_hook(
        lambda mod, inp: events.append(("fwd_layer0", time.monotonic())))
    x, y = _data()
    try:
        _loss(m, x, y).backward()
        events.clear()                      # ignore step-0 forward
        cb.step()
        fwd = threading.Thread(target=lambda: _loss(m, x, y))
        fwd.start()
        deadline = time.time() + 10
        while not any(e[0] == "fwd_layer0" for e in events):
            assert time.time() < deadline, "forward never started"
            time.sleep(0.01)
        assert not any(e[0] == "slow_sync_done" for e in events)
        gate.set()
        fwd.join(timeout=30)
        assert not fwd.is_alive(), "forward deadlocked on the slow layer"
    finally:
        gate.set()
        cb.close()
    order = [e[0] for e in sorted(events, key=lambda e: e[1])]
    assert order.index("fwd_layer0") < order.index("slow_sync_done"), order


def _lr_schedule():
    """A scheduler on the inner optimizer reaches the per-param updates."""
    x, y = _data()
    ref = _model()
    inner_ref = torch.optim.SGD(ref.parameters(), lr=0.1)
    sched_ref = torch.optim.lr_scheduler.StepLR(inner_ref, 1, gamma=0.5)
    for _ in range(3):
        inner_ref.zero_grad()
        _loss(ref, x, y).backward()
        inner_ref.step()
        sched_ref.step()
    m = _model()
    inner = torch.optim.SGD(m.parameters(), lr=0.1)
    cb = hvd.CrossBarrier(m, inner, named_parameters=m.named_parameters())
    sched = torch.optim.lr_scheduler.StepLR(inner, 1, gamma=0.5)
    try:
        for _ in range(3):
            _loss(m, x, y).backward()
            cb.step()
            cb.synchronize()   # every update applied before the LR moves
            sched.step()
    finally:
        cb.close()
    _assert_close(ref, m)


def _close():
    """After close() the model trains with a plain optimizer: no hook
    dispatches into the dead queue or blocks the forward."""
    x, y = _data()
    m = _model()
    cb = hvd.CrossBarrier(m, torch.optim.SGD(m.parameters(), lr=0.01),
                          named_parameters=m.named_parameters())
    _loss(m, x, y).backward()
    cb.step()
    cb.close()
    plain = torch.optim.SGD(m.parameters(), lr=0.01)
    for _ in range(2):
        plain.zero_grad()
        _loss(m, x, y).backward()
        plain.step()


def _accumulation():
    """backward_passes_per_step=2: every second backward dispatches the
    accumulated gradient halved."""
    x, y = _data()
    ref = _model()
    ref_opt = torch.optim.SGD(ref.parameters(), lr=0.1)
    for _ in range(2):
        ref_opt.zero_grad()
        _loss(ref, x, y).backward()
        _loss(ref, x, y).backward()
        for p in ref.parameters():
            p.grad.div_(2)
        ref_opt.step()
    m = _model()
    cb = hvd.CrossBarrier(m, torch.optim.SGD(m.parameters(), lr=0.1),
                          named_parameters=m.named_parameters(),
                          backward_passes_per_step=2)
    try:
        for _ in range(2):
            _loss(m, x, y).backward()
            _loss(m, x, y).backward()
            cb.step()
        cb.synchronize()
    finally:
        cb.close()
    _assert_close(ref, m)


SCENARIOS = {
    "sgd": lambda: _vanilla(torch.optim.SGD, dict(lr=0.05, momentum=0.9)),
    "adam": lambda: _vanilla(torch.optim.Adam, dict(lr=0.01)),
    "rmsprop": lambda: _vanilla(torch.optim.RMSprop, dict(lr=0.005)),
    "adamw": lambda: _vanilla(torch.optim.AdamW, dict(lr=0.01)),
    "overlap": _overlap,
    "lr_schedule": _lr_schedule,
    "close": _close,
    "accumulation": _accumulation,
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_cross_barrier_scenarios(both, scenario):
    SCENARIOS[scenario]()


def test_cross_barrier_matches_the_reference(both):
    """The reference's CrossBarrier (through JAX's eager push_pull) and the
    port's, from the same weights on the same batches: the same params."""
    x, y = _data()
    models = []
    for face in (jhvd, hvd):
        m = _model()
        cb = face.CrossBarrier(m, torch.optim.Adam(m.parameters(), lr=0.01),
                               named_parameters=m.named_parameters())
        try:
            for i in range(4):
                _loss(m, x + 0.1 * i, y).backward()
                cb.step()
            cb.synchronize()
        finally:
            cb.close()
        models.append(m)
    for (n, a), (_, b) in zip(models[0].named_parameters(),
                              models[1].named_parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
