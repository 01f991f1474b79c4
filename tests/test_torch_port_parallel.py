"""byteps_tpu_torch's TP / PP / EP modules vs the JAX package's, on one
4-rank gloo world (the mirror of tests/test_parallel_strategies.py).

The world (``tests/torch_port_parallel_worker.py parallel``), spawned once
for the module, runs on tp=4, pp=4 and ep=4 meshes: the Megatron col/row
pair forward and backward, the tp split/gather round trip, ``gpipe_spmd``
forward and gradients at M = 2 and 4, and ``moe_layer`` at three capacity
factors and its gradients.  Each is held to the sequential or dense
computation and to the JAX function under ``shard_map`` on 4 CPU devices,
at the reference file's tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as JP

from byteps_tpu.common.compat import shard_map
from byteps_tpu.parallel import expert, pipeline
from byteps_tpu.parallel import tensor_parallel as jtp
from torch_port_parallel_worker import collect, spawn
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 4


def _mesh(name, n=WORLD):
    return Mesh(np.array(jax.devices()[:n]), (name,))


def _moe_inputs(rng, E, D, F, T):
    """init_moe_params' tree and scaling (normal / sqrt(fan_in)) from a
    numpy generator, and tokens [T, D]."""
    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(
            np.float32)
    params = {"gate_w": w((D, E), D), "ffn_in": w((E, D, F), D),
              "ffn_out": w((E, F, D), F)}
    return params, rng.standard_normal((T, D)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    D, F = 16, 32
    moe, moe_x = _moe_inputs(rng, 8, 16, 32, 64)
    moeg, moeg_x = _moe_inputs(rng, 8, 8, 16, 32)
    inputs = {
        "x": rng.randn(4, D).astype(np.float32),
        "w1": rng.randn(D, F).astype(np.float32),
        "w2": rng.randn(F, D).astype(np.float32),
        "b2": rng.randn(D).astype(np.float32),
        "arange": np.arange(64.0, dtype=np.float32).reshape(4, 16),
        "pp_ws": (rng.randn(8, 16, 16) / 4).astype(np.float32),
        "pp_x": rng.randn(8, 16).astype(np.float32),
        "pg_ws": (rng.randn(4, 8, 8) / np.sqrt(8)).astype(np.float32),
        "pg_x": rng.randn(4, 8).astype(np.float32),
        "moe_x": moe_x, "moeg_x": moeg_x,
        **{f"moe/{k}": v for k, v in moe.items()},
        **{f"moeg/{k}": v for k, v in moeg.items()},
    }
    d = tmp_path_factory.mktemp("parallel_world")
    procs = spawn("parallel", inputs, d)
    return inputs, collect(procs, d)


def _t(a, grad=False):
    return torch.tensor(a, requires_grad=grad)


def test_megatron_col_row_matches_dense(world):
    inputs, ranks = world
    x, w1, w2, b2 = (jnp.asarray(inputs[k]) for k in ("x", "w1", "w2", "b2"))

    def shard_fn(x, w1l, w2l, b2):
        h = jax.nn.relu(jtp.col_parallel_dense(x, w1l))
        return jtp.row_parallel_dense(h, w2l, b2)

    jout = jax.jit(shard_map(
        shard_fn, mesh=_mesh("tp"),
        in_specs=(JP(), JP(None, "tp"), JP("tp", None), JP()),
        out_specs=JP(), check_vma=False))(x, w1, w2, b2)
    expect = jax.nn.relu(x @ w1) @ w2 + b2
    for r in ranks:
        np.testing.assert_allclose(r["colrow"], np.asarray(expect),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["colrow"], np.asarray(jout),
                                   rtol=2e-5, atol=2e-5)


def test_megatron_col_row_grads_match_dense(world):
    """copy_to's all-reduce adjoint and reduce_from's identity one: every
    rank computes the same loss and gets dense's dx and db2, and its own
    columns of dW1 and rows of dW2 (the ranks' sum is dense's)."""
    inputs, ranks = world
    x, w1, w2, b2 = (_t(inputs[k], True) for k in ("x", "w1", "w2", "b2"))
    ((torch.relu(x @ w1) @ w2 + b2) ** 2).sum().backward()
    for r in ranks:
        np.testing.assert_allclose(r["colrow/dx"], x.grad.numpy(),
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["colrow/db2"], b2.grad.numpy(),
                                   rtol=2e-5, atol=2e-5)
    for k, want in (("dw1", w1.grad), ("dw2", w2.grad)):
        np.testing.assert_allclose(sum(r[f"colrow/{k}"] for r in ranks),
                                   want.numpy(), rtol=2e-5, atol=2e-5)


def test_tp_split_gather_roundtrip(world):
    inputs, ranks = world
    for r in ranks:
        np.testing.assert_array_equal(r["roundtrip"], inputs["arange"])


def _stage_fn(stage_ws, h):
    def body(h, w):
        return jnp.tanh(h @ w), None
    return jax.lax.scan(body, h, stage_ws)[0]


@pytest.mark.parametrize("num_microbatches", [2, 4])
def test_gpipe_matches_sequential(world, num_microbatches):
    inputs, ranks = world
    ws, x = _t(inputs["pp_ws"]), _t(inputs["pp_x"])
    ref = x
    for w in ws:
        ref = torch.tanh(ref @ w)
    staged = pipeline.shard_stage_params(jnp.asarray(inputs["pp_ws"]), WORLD)
    jout = jax.jit(shard_map(
        lambda s, x: pipeline.gpipe_spmd(_stage_fn, s[0], x,
                                         num_microbatches),
        mesh=_mesh("pp"), in_specs=(JP("pp"), JP()), out_specs=JP(),
        check_vma=False))(staged, jnp.asarray(inputs["pp_x"]))
    for r in ranks:
        got = r[f"gpipe{num_microbatches}"]
        np.testing.assert_allclose(got, ref.numpy(), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(jout), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("num_microbatches", [2, 4])
def test_gpipe_grads_match_sequential(world, num_microbatches):
    """Every rank's loss on the replicated output counts (their mean is the
    loss), so the last stage must receive every rank's cotangent: a
    broadcast whose adjoint kept only its own would be 4x short here."""
    inputs, ranks = world
    ws, x = _t(inputs["pg_ws"], True), _t(inputs["pg_x"])
    h = x
    for w in ws:
        h = torch.tanh(h @ w)
    (h ** 2).sum().backward()
    got = np.concatenate([r[f"gpipe_grad{num_microbatches}"]
                          for r in ranks])
    np.testing.assert_allclose(got, ws.grad.numpy(), rtol=2e-4, atol=2e-5)

    def pp_loss(staged, x):
        def inner(local_ws, x):
            y = pipeline.gpipe_spmd(_stage_fn, local_ws[0], x,
                                    num_microbatches)
            return (y ** 2).sum()
        return shard_map(inner, mesh=_mesh("pp"), in_specs=(JP("pp"), JP()),
                         out_specs=JP(), check_vma=False)(staged, x)

    staged = pipeline.shard_stage_params(jnp.asarray(inputs["pg_ws"]),
                                         WORLD)
    g_jax = jax.jit(jax.grad(pp_loss))(staged, jnp.asarray(inputs["pg_x"]))
    np.testing.assert_allclose(got, np.asarray(g_jax).reshape(got.shape),
                               rtol=2e-4, atol=2e-5)


def _jax_moe(inputs, prefix, mesh, cf):
    params = {k: jnp.asarray(inputs[f"{prefix}/{k}"])
              for k in ("gate_w", "ffn_in", "ffn_out")}
    return jax.jit(functools.partial(expert.moe_layer, mesh=mesh,
                                     capacity_factor=cf))(
        params, jnp.asarray(inputs[f"{prefix}_x"]))


@pytest.mark.parametrize("cf", [16.0, 2.0, 0.25])
def test_moe_matches_jax(world, cf):
    """Each capacity factor against JAX on the same ep=4 layout (capacity
    is per rank's tokens); with room for every token, against one
    device too."""
    inputs, ranks = world
    y, aux = _jax_moe(inputs, "moe", _mesh("ep"), cf)
    for r in ranks:
        np.testing.assert_allclose(r[f"moe{cf}"], np.asarray(y), rtol=2e-4,
                                   atol=2e-5)
        np.testing.assert_allclose(r[f"moe{cf}/aux"], np.asarray(aux),
                                   rtol=2e-4, atol=2e-5)
    if cf == 16.0:
        y1, _ = _jax_moe(inputs, "moe", _mesh("ep", 1), cf)
        np.testing.assert_allclose(ranks[0][f"moe{cf}"], np.asarray(y1),
                                   rtol=2e-4, atol=2e-5)


def test_moe_capacity_drops_tokens(world):
    """With capacity factor << 1 some tokens are dropped (zero output),
    never corrupted."""
    _, ranks = world
    y, aux = ranks[0]["moe0.25"], ranks[0]["moe0.25/aux"]
    assert np.isfinite(y).all()
    assert float(aux) > 0
    assert (np.abs(y).sum(-1) == 0).sum() > 0


def test_moe_grads_flow(world):
    """The loss every rank computes on the whole output gives every rank
    JAX's gradients of x and of all the params, ep=4 both."""
    inputs, ranks = world
    params = {k: jnp.asarray(inputs[f"moeg/{k}"])
              for k in ("gate_w", "ffn_in", "ffn_out")}

    def loss(p, x):
        y, aux = expert.moe_layer(p, x, _mesh("ep"), 8.0)
        return (y ** 2).sum() + 0.01 * aux

    g, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        params, jnp.asarray(inputs["moeg_x"]))
    for r in ranks:
        for k, want in g.items():
            assert np.isfinite(r[f"moeg/{k}"]).all(), k
            np.testing.assert_allclose(r[f"moeg/{k}"], np.asarray(want),
                                       rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(r["moeg/x"], np.asarray(gx), rtol=2e-4,
                                   atol=2e-5)
        assert float(np.abs(r["moeg/ffn_in"]).sum()) > 0
