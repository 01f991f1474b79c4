"""byteps_tpu_torch's ring and Ulysses attention vs the JAX package's.

Inputs are made with numpy from a seed.  Two gloo ranks
(``tests/torch_port_ring_worker.py``), each holding half the sequence, run
the port's functions; the JAX functions run under ``shard_map`` on a
2-device CPU mesh, as ``tests/test_ring_attention.py`` runs them on 8.
World-1 cases (``collectives.local_mode()``) run in this process against a
1-device mesh.  Tolerances are the JAX tests': forward rtol = atol = 2e-5,
gradients 1e-4, the flash inner atol 2e-5 / rtol 1e-4.
"""

import functools
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from byteps_tpu.common.compat import shard_map
from byteps_tpu.models.transformer import dense_attention as jax_dense
from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu.ops import ring_attention as jra
from byteps_tpu_torch.ops import collectives
from byteps_tpu_torch.ops import flash_attention as fa
from byteps_tpu_torch.ops import ring_attention as ra
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_ring_worker.py")
SPEC = P(None, None, "sp", None)
FNS = ("ring", "ulysses", "ulysses_flash")


def _inputs():
    rng = np.random.RandomState(7)

    def rnd(*shape):
        return rng.randn(*shape).astype(np.float32)
    out = {f"dense_{t}": rnd(2, 4, 64, 8) for t in "qkv"}
    out.update({f"flash_{t}": rnd(1, 4, 256, 32) for t in "qkv"})
    out["bad_heads"] = rnd(1, 3, 8, 8)
    out["strict"] = rnd(1, 2, 100, 32)
    return out


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("sp",))


def _jax_fn(name, n, causal):
    """The JAX counterpart of the worker's ``name`` on an n-device mesh:
    (q, k, v) -> out, full-shape arrays in and out."""
    mesh = _mesh(n)
    if name == "ulysses_flash":
        fn = jra.make_ulysses_attn_fn(mesh, attn="flash")
        return lambda q, k, v: fn(q, k, v, causal)
    shard = {"ring": jra.ring_attention_shard,
             "ulysses": jra.ulysses_attention_shard}[name]
    return shard_map(functools.partial(shard, causal=causal), mesh=mesh,
                     in_specs=(SPEC,) * 3, out_specs=SPEC, check_vma=False)


def _jax_out_and_grads(name, n, causal, q, k, v):
    f = _jax_fn(name, n, causal)
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2), (0, 1, 2)))(
        *args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _check(name, out, grads, want, want_grads, q, k, v, causal):
    fwd_tol = (dict(atol=2e-5, rtol=1e-4) if name == "ulysses_flash"
               else dict(atol=2e-5, rtol=2e-5))
    np.testing.assert_allclose(out, want, **fwd_tol)
    dense = np.asarray(jax_dense(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal))
    np.testing.assert_allclose(out, dense, **fwd_tol)
    for got, ref in zip(grads, want_grads):
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got / scale, ref / scale, atol=1e-4,
                                   rtol=1e-4)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    """The worker's outputs on 2 ranks, each rank's sequence block joined
    back into the full sequence."""
    tmp = tmp_path_factory.mktemp("ring")
    data = _inputs()
    np.savez(tmp / "in.npz", **data)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2",
                               str(port), str(tmp / "in.npz"),
                               str(tmp / f"out{r}.npz")], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=50)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [np.load(tmp / f"out{r}.npz") for r in range(2)]
    joined, errs = {}, {}
    for key in ranks[0].files:
        if key.startswith("err_"):
            errs[key] = [str(r[key]) for r in ranks]
        else:
            joined[key] = np.concatenate([r[key] for r in ranks], axis=2)
    return data, joined, errs


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", FNS)
def test_two_ranks_match_jax_mesh(world2, name, causal):
    """Outputs against the JAX function on a 2-device mesh and against
    dense attention; the gradients of sum(out ** 2) against JAX's."""
    data, res, _ = world2
    prefix = "flash" if name == "ulysses_flash" else "dense"
    q, k, v = (data[f"{prefix}_{t}"] for t in "qkv")
    want, want_grads = _jax_out_and_grads(name, 2, causal, q, k, v)
    case = f"{name}_{int(causal)}"
    _check(name, res[case], [res[f"{case}_d{t}"] for t in "qkv"], want,
           want_grads, q, k, v, causal)


def test_two_ranks_refuse_what_jax_refuses(world2):
    """A head count the sp world does not divide, and the strict flash
    inner at a gathered length no 64-row block divides, raise on every
    rank, as the JAX functions do."""
    data, _, errs = world2
    assert all("divisible by the sp axis size" in e
               for e in errs["err_bad_heads"])
    assert all("divisible by 64" in e for e in errs["err_strict"])
    x = jnp.asarray(data["bad_heads"])
    with pytest.raises(ValueError, match="divisible"):
        _jax_fn("ulysses", 2, False)(x, x, x)
    x = jnp.asarray(data["strict"])
    with pytest.raises(ValueError, match="divisible by 64"):
        _jax_fn("ulysses_flash", 2, False)(x, x, x)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("name", FNS)
def test_world_one_matches_jax(name, causal):
    """At world 1 (local mode) the permutations and all-to-alls are the
    identity, and each function is attention over the whole sequence."""
    data = _inputs()
    prefix = "flash" if name == "ulysses_flash" else "dense"
    q, k, v = (data[f"{prefix}_{t}"] for t in "qkv")
    fn = {"ring": ra.make_ring_attn_fn(),
          "ulysses": ra.make_ulysses_attn_fn(),
          "ulysses_flash": ra.make_ulysses_attn_fn(attn="flash")}[name]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with collectives.local_mode():
        out = fn(tq, tk, tv, causal)
        grads = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    want, want_grads = _jax_out_and_grads(name, 1, causal, q, k, v)
    _check(name, out.detach().numpy(), [g.numpy() for g in grads], want,
           want_grads, q, k, v, causal)


def test_ulysses_flash_takes_the_streaming_family(monkeypatch):
    """Past the resident budget (set to 0 in both packages) the Ulysses
    flash inner runs the streaming family, in 4 splits here, forward and
    backward, and still matches JAX's streaming kernels."""
    monkeypatch.setattr(jfa, "RESIDENT_VMEM_BUDGET", 0)
    monkeypatch.setattr(fa, "RESIDENT_VMEM_BUDGET", 0)
    monkeypatch.setattr(fa, "_split_len", lambda s: 64)
    calls = []
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                 "flash_fwd_str", "flash_bwd_dq_str", "flash_bwd_dkv_str"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    data = _inputs()
    q, k, v = (data[f"flash_{t}"] for t in "qkv")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    with collectives.local_mode():
        out = ra.make_ulysses_attn_fn(attn="flash")(tq, tk, tv, True)
        grads = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    assert calls == ["flash_fwd_str", "flash_bwd_dq_str",
                     "flash_bwd_dkv_str"]
    want, want_grads = _jax_out_and_grads("ulysses_flash", 1, True, q, k, v)
    _check("ulysses_flash", out.detach().numpy(), [g.numpy() for g in grads],
           want, want_grads, q, k, v, True)


def test_ulysses_rejects_unknown_attn():
    with pytest.raises(ValueError, match="dense"):
        ra.make_ulysses_attn_fn(attn="nope")
    x = torch.zeros(1, 2, 100, 32)
    with collectives.local_mode(), pytest.raises(ValueError,
                                                 match="divisible by 64"):
        ra.make_ulysses_attn_fn(attn="flash")(x, x, x, False)
