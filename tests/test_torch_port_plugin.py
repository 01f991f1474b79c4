"""byteps_tpu_torch.torch, the native Horovod face, against byteps_tpu.torch.

The cases of tests/test_torch_plugin.py on the port: the same torch model
and data go through the JAX package's plugin (which carries each tensor
through JAX) and the port's (which keeps it on its device), and the
parameters must agree to 1e-6 (DistributedOptimizer, broadcasts, DDP
auto-sync, fp16 masters with the overflow skip).  A 2-rank gloo run
(``tests/torch_port_api_worker.py``) must equal the 1-process run on the
full batch.
"""

import numpy as np
import pytest
import torch

import byteps_tpu.torch as jhvd
import byteps_tpu_torch.torch as hvd
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_port_api import run_worlds


@pytest.fixture
def both():
    jhvd.init()
    hvd.init()
    yield
    hvd.shutdown()
    jhvd.shutdown()


def _close(a, b, tol=1e-6):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.detach().numpy(), y.detach().numpy(),
                                   rtol=tol, atol=tol)


def test_push_pull_inplace(both):
    t = torch.arange(6, dtype=torch.float32)
    u = t.clone()
    assert hvd.push_pull(t, average=True, name="t0") is t
    jhvd.push_pull(u, average=True, name="t0")
    assert torch.equal(t, u)


def test_async_handles(both):
    t = torch.ones(4)
    h = hvd.push_pull_async(t, name="t1")
    assert hvd.poll(h) in (True, False)
    assert hvd.synchronize(h) is t
    np.testing.assert_allclose(t.numpy(), np.ones(4))
    with pytest.raises(ValueError):
        hvd.synchronize(h)
    h = hvd.push_pull_async_inplace(t, name="t2")
    hvd.synchronize(h)


def _mlp(seed=0):
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 4))


def _data(seed=1, n=16):
    rng = np.random.RandomState(seed)
    return (torch.from_numpy(rng.randn(n, 8).astype(np.float32)),
            torch.from_numpy(rng.randn(n, 4).astype(np.float32)))


@pytest.mark.parametrize("bpps", [1, 2])
@pytest.mark.parametrize("comp", ["none", "fp16"])
def test_distributed_optimizer_matches_reference(both, bpps, comp):
    """DistributedOptimizer(SGD with momentum) for 3 steps, bpps backward
    passes each: the port's parameters and losses equal the reference
    plugin's; every parameter's push_pull is synchronized each step."""
    x, y = _data()
    runs = []
    for mod in (jhvd, hvd):
        m = _mlp()
        opt = mod.DistributedOptimizer(
            torch.optim.SGD(m.parameters(), lr=0.1, momentum=0.9),
            named_parameters=m.named_parameters(),
            compression=getattr(mod.Compression, comp),
            backward_passes_per_step=bpps)
        losses = []
        for _ in range(3):
            opt.zero_grad()
            for i in range(bpps):
                sl = slice(i * 8 // bpps, (i + 1) * 8 // bpps + 8 * (bpps == 1))
                loss = torch.nn.functional.mse_loss(m(x[sl]), y[sl])
                loss.backward()
            opt.step()
            losses.append(float(loss.detach()))
            if mod is hvd:
                assert opt.step_handles == 4
        runs.append((list(m.parameters()), losses))
    _close(runs[0][0], runs[1][0])
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-6)


def test_zero_grad_drops_a_step_that_was_not_taken(both):
    """A backward whose step is skipped leaves handles in flight;
    zero_grad waits for and drops them, and the next step reduces only
    its own gradients."""
    x, y = _data()
    m = _mlp()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                   named_parameters=m.named_parameters())
    torch.nn.functional.mse_loss(m(x), y).backward()
    assert len(opt._pending) == 4
    opt.zero_grad()
    assert not opt._pending and all(p.grad is None for p in m.parameters())
    torch.nn.functional.mse_loss(m(x), y).backward()
    want = [p.grad.clone() for p in m.parameters()]
    opt.synchronize()
    assert opt.step_handles == 4
    for p, w in zip(m.parameters(), want):
        assert torch.equal(p.grad, w)


def test_distributed_optimizer_refuses_async():
    """enable_async needs PS mode against servers in async mode: without
    them step() raises, as the JAX package's does."""
    m = _mlp()
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                   enable_async=True)
    m(torch.ones(3, m[0].in_features)).sum().backward()
    with pytest.raises(RuntimeError, match="BYTEPS_ENABLE_ASYNC=1"):
        opt.step()


def test_broadcast_parameters(both):
    m = torch.nn.Linear(4, 2)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    hvd.broadcast_parameters(m.state_dict())
    hvd.broadcast_parameters(list(m.named_parameters()))
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k])


def test_broadcast_optimizer_state(both):
    """Adam's state, tensors and scalars, through both plugins'
    broadcast: the same state after, and the step after it the same."""
    states = []
    for mod in (jhvd, hvd):
        m = _mlp()
        o = torch.optim.Adam(m.parameters(), lr=1e-3)
        x, y = _data()
        torch.nn.functional.mse_loss(m(x), y).backward()
        o.step()
        mod.broadcast_optimizer_state(o)
        o.step()
        states.append((o.state_dict()["state"], list(m.parameters())))
    for pid, st in states[1][0].items():
        for k, v in st.items():
            ref = states[0][0][pid][k]
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ref)), k
    _close(states[0][1], states[1][1])


def test_ddp_wrapper(both):
    m = hvd.DistributedDataParallel(torch.nn.Linear(4, 2))
    m(torch.randn(3, 4)).sum().backward()
    m.synchronize()
    for p in m.module.parameters():
        assert p.grad is not None


def test_ddp_auto_sync_matches_reference(both):
    """``loss.backward(); opt.step()`` with a plain optimizer: the sync
    fires from the end of each backward, and the parameters equal the
    reference wrapper's."""
    x, y = _data()
    runs = []
    for mod in (jhvd, hvd):
        m = mod.DistributedDataParallel(_mlp())
        opt = torch.optim.SGD(m.parameters(), lr=0.1)
        for _ in range(5):
            opt.zero_grad()
            torch.nn.functional.mse_loss(m(x), y).backward()
            opt.step()
        assert m.autosync_count == 5
        runs.append(list(m.parameters()))
    _close(*runs)
    m2 = hvd.DistributedDataParallel(torch.nn.Linear(2, 1), auto_sync=False)
    m2(torch.randn(3, 2)).sum().backward()
    assert m2.autosync_count == 0


@pytest.mark.parametrize("dtype", [torch.float16])
def test_fp16_master_weight_optimizer_matches_reference(both, dtype):
    """A float16 model with fp32 masters (static loss scale): the same
    masters, model and losses as the reference plugin over 6 steps.  (The
    reference plugin cannot take bf16 tensors: numpy has no bf16.)"""
    x, y = _data(n=32)
    runs = []
    for mod in (jhvd, hvd):
        m = _mlp(42).to(dtype)
        opt = mod.HalfPrecisionDistributedOptimizer(
            m, lambda ps: torch.optim.SGD(ps, lr=0.05), loss_scale=1024.0)
        losses = []
        for _ in range(6):
            opt.zero_grad()
            loss = torch.nn.functional.mse_loss(m(x.to(dtype)).float(), y)
            opt.scale_loss(loss).backward()
            opt.step()
            losses.append(float(loss.detach()))
        assert opt.steps_skipped == 0
        assert all(p.dtype == torch.float32 for p in opt._master_params)
        runs.append((opt._master_params, list(m.parameters()), losses))
    _close(runs[0][0], runs[1][0])
    _close(runs[0][1], runs[1][1])
    np.testing.assert_allclose(runs[0][2], runs[1][2], rtol=1e-6)


def test_fp16_dynamic_loss_scale_skips_overflow(both):
    m = torch.nn.Linear(2, 1).to(torch.float16)
    opt = hvd.HalfPrecisionDistributedOptimizer(
        m, lambda ps: torch.optim.SGD(ps, lr=0.1), loss_scale="dynamic")
    s0 = opt.loss_scale
    before = [p.detach().clone() for p in opt._master_params]
    for p in m.parameters():
        p.grad = torch.full_like(p, float("inf"))
    opt.step()
    assert opt.steps_skipped == 1 and opt.loss_scale == s0 / 2
    for b, p in zip(before, opt._master_params):
        assert torch.equal(b, p.detach())
    for p in m.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    assert opt.steps_skipped == 1
    hvd.broadcast_fp16_parameters(opt)


def test_cross_barrier_is_the_ported_scheduler(both):
    """``byteps_tpu_torch.torch.CrossBarrier`` is the port's scheduler
    (torch/cross_barrier.py; its cases are
    tests/test_torch_port_cross_barrier.py): one step of it equals one of
    the plain optimizer."""
    from byteps_tpu_torch.torch import cross_barrier
    assert hvd.CrossBarrier is cross_barrier.CrossBarrier
    torch.manual_seed(0)
    a, b = torch.nn.Linear(4, 2), torch.nn.Linear(4, 2)
    b.load_state_dict(a.state_dict())
    x = torch.randn(8, 4)
    plain = torch.optim.SGD(a.parameters(), lr=0.1)
    a(x).square().mean().backward()
    plain.step()
    cb = hvd.CrossBarrier(b, torch.optim.SGD(b.parameters(), lr=0.1),
                          named_parameters=b.named_parameters())
    try:
        b(x).square().mean().backward()
        cb.step()
        cb.synchronize()
    finally:
        cb.close()
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)


def test_two_rank_gloo_run_equals_one_process(tmp_path):
    """Two gloo ranks, each on half the global batch, after the broadcasts
    (rank 1 starts from other weights): DistributedOptimizer and DDP end
    where one process on the whole batch ends, every rank alike."""
    ranks, single = run_worlds((2, tmp_path / "dist"),
                               (1, tmp_path / "single"))
    single = single[0]
    keys = [k for k in single if k.startswith(("opt_p", "ddp_p"))]
    assert len(keys) == 8
    for out in ranks:
        for k in keys:
            np.testing.assert_allclose(out[k], single[k], rtol=1e-6,
                                       atol=1e-6)
    np.testing.assert_allclose(ranks[0]["opt_losses"] + ranks[1]["opt_losses"],
                               2 * single["opt_losses"], rtol=1e-5)
