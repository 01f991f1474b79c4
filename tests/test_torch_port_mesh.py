"""byteps_tpu_torch's meshes and hierarchical reduce vs the JAX package's.

The rank layout behind every mesh must be the JAX mesh's device ids over
the 8 CPU devices, with the same axis names and the same errors (pure
functions; no process group).  Then one 4-rank gloo world on a (2, 2)
('dcn_dp', 'ici_dp') mesh, spawned once for the module: its
``hierarchical_all_reduce``, ``hierarchical_tree_all_reduce`` and a
three-step ``DistributedOptimizer(hierarchical=True)`` trajectory against
JAX's on ``jax.devices()[:4]`` reshaped (2, 2), and against one process on
the whole batch.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import byteps_tpu as jbps
from byteps_tpu.common.config import Config as JConfig
from byteps_tpu.models import transformer as jtfm
from byteps_tpu.ops import collectives as jcoll
from byteps_tpu.parallel import mesh as jmesh
from byteps_tpu_torch.common.config import Config
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import transformer as tfm
from byteps_tpu_torch.parallel import mesh
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_mesh_worker.py")
WORLD = 4
TREE_SHAPES = {"a": (5,), "b": (3, 7), "c": (2, 3, 3)}   # odd bucket sizes


def _ids(jm):
    return np.vectorize(lambda d: d.id)(jm.devices)


@pytest.mark.parametrize("dp,tp,sp,pp,ep", [
    (0, 1, 1, 1, 1), (0, 2, 1, 1, 1), (2, 2, 2, 1, 1), (1, 2, 1, 2, 2),
    (0, 1, 2, 2, 1), (8, 1, 1, 1, 1)])
def test_make_mesh_layout_matches_jax(dp, tp, sp, pp, ep):
    jm = jmesh.make_mesh(dp=dp, tp=tp, sp=sp, pp=pp, ep=ep)
    got = mesh.mesh_ranks(dp, tp, sp, pp, ep, devices=range(8))
    assert mesh.AXIS_ORDER == tuple(jm.axis_names)
    np.testing.assert_array_equal(got, _ids(jm))


@pytest.mark.parametrize("ici_size", [0, 1, 2, 4, 8])
def test_hierarchical_layout_matches_jax(ici_size):
    jm = jmesh.make_hierarchical_mesh(ici_size)
    got = mesh.hierarchical_ranks(ici_size, devices=range(8))
    assert mesh.TWO_LEVEL == tuple(jm.axis_names)
    np.testing.assert_array_equal(got, _ids(jm))
    # A sub-list of ranks, as a sub-list of devices.
    sub = jmesh.make_hierarchical_mesh(2, devices=jax.devices()[:4])
    np.testing.assert_array_equal(mesh.hierarchical_ranks(2, range(4)),
                                  _ids(sub))


@pytest.mark.parametrize("members", [1, 3, 8, 9])
def test_slice_layout_matches_jax(members):
    jm = jmesh.make_slice_mesh(members)
    got = mesh.slice_ranks(members, devices=range(8))
    if jm is None:
        assert got is None
    else:
        assert tuple(jm.axis_names) == ("ici_dp",)
        np.testing.assert_array_equal(got, _ids(jm))


@pytest.mark.parametrize("call", [
    lambda m, devs: m(dp=3, devices=devs),
    lambda m, devs: m(tp=3, devices=devs),
    lambda m, devs: m(dp=2, tp=2, devices=devs),
    "ici3"])
def test_mesh_errors_match_jax(call):
    def run(pkg, devs):
        if call == "ici3":
            pkg.make_hierarchical_mesh(3, devices=devs)
        else:
            call(pkg.make_mesh, devs)

    with pytest.raises(ValueError) as jerr:
        run(jmesh, jax.devices())
    with pytest.raises(ValueError) as terr:
        run(mesh, list(range(8)))
    assert str(terr.value) == str(jerr.value)


def test_mesh_knobs_match_jax_config(monkeypatch):
    env = {"BYTEPS_TPU_MESH_DP": "2", "BYTEPS_TPU_MESH_TP": "4",
           "BYTEPS_TPU_MESH_SP": "1", "BYTEPS_TPU_MESH_PP": "2",
           "BYTEPS_TPU_MESH_EP": "3", "BYTEPS_TPU_ICI_SIZE": "4"}
    keys = ("mesh_dp", "mesh_tp", "mesh_sp", "mesh_pp", "mesh_ep",
            "ici_size")
    for k in env:
        monkeypatch.delenv(k, raising=False)
    defaults = Config.from_env()
    assert [getattr(defaults, k) for k in keys] == \
        [getattr(JConfig.from_env(), k) for k in keys] == [0, 1, 1, 1, 1, 0]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert [getattr(Config.from_env(), k) for k in keys] == \
        [getattr(JConfig.from_env(), k) for k in keys] == [2, 4, 1, 2, 3, 4]


def test_device_mesh_needs_a_process_group_and_cuda():
    """Without a process group there is no DeviceMesh; the default device
    type is CUDA, which raises here rather than running on the CPU."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_hierarchical_mesh(device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh()
    # The compressed reduce takes precedence: no mesh is built for it.
    import byteps_tpu_torch as bps
    w = torch.zeros(3, requires_grad=True)
    opt = bps.DistributedOptimizer(
        torch.optim.SGD([w], lr=1.0), hierarchical=True,
        inter_compressor=bps.compressor.create({"compressor": "onebit"}))
    assert not opt.hierarchical and opt.mesh is None


# ---------------------------------------------------------------------------
# The 4-rank gloo world, spawned once.
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tiny():
    return (jtfm.get_config("tiny", dtype=jnp.float32, attn_impl="flash"),
            tfm.get_config("tiny", dtype=torch.float32, attn_impl="flash"))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs (numpy, seeded), the JAX params of the tiny transformer, and
    the 4 ranks' outputs."""
    d = tmp_path_factory.mktemp("mesh_world")
    rng = np.random.RandomState(0)
    jcfg, _ = _tiny()
    params_np = jax.tree.map(np.asarray,
                             jtfm.init_params(jax.random.key(0), jcfg))
    toks = rng.randint(0, jcfg.vocab_size, size=(WORLD, 65))
    inputs = {"x": rng.randn(WORLD, 16).astype(np.float32),
              "toks": toks[:, :-1], "tgts": toks[:, 1:]}
    for r in range(WORLD):
        for k, shp in TREE_SHAPES.items():
            inputs[f"tree{r}/{k}"] = rng.randn(*shp).astype(np.float32)
    for path, leaf in jax.tree_util.tree_flatten_with_path(params_np)[0]:
        inputs["param/" + "/".join(p.key for p in path)] = leaf
    np.savez(d / "in.npz", **inputs)

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD),
                               str(port), str(d / "in.npz"), str(d)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=55)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]
    return inputs, params_np, ranks


def _jax_mesh():
    return jbps.make_hierarchical_mesh(2, devices=jax.devices()[:WORLD])


def _shard_map(fn, jm):
    from byteps_tpu.common.compat import shard_map
    return jax.jit(shard_map(fn, mesh=jm, in_specs=(P(("dcn_dp", "ici_dp")),),
                             out_specs=P(), check_vma=False))


def test_device_meshes_on_the_world(world):
    """On the 4 gloo ranks, the meshes' shapes and dp sizes are the JAX
    meshes' over 4 devices."""
    _, _, ranks = world
    devs = jax.devices()[:WORLD]
    jflat = jmesh.make_mesh(tp=2, devices=devs)
    for r in ranks:
        assert tuple(r["flat_shape"]) == tuple(jflat.devices.shape)
        assert int(r["flat_dp"]) == jmesh.dp_axis_size(jflat) == 2
        assert int(r["two_level_dp"]) == jmesh.dp_axis_size(_jax_mesh()) == 1
        assert tuple(r["slice_shape"]) == tuple(
            jmesh.make_slice_mesh(WORLD // 2, devices=devs).devices.shape)
        assert bool(r["slice_none"]) and jmesh.make_slice_mesh(
            WORLD + 1, devices=devs) is None


def test_hierarchical_all_reduce_matches_jax(world):
    inputs, _, ranks = world
    x = jnp.asarray(inputs["x"])
    jm = _jax_mesh()
    for average in (False, True):
        want = np.asarray(_shard_map(
            lambda xs: jcoll.hierarchical_all_reduce(
                xs.reshape(-1), "ici_dp", "dcn_dp", average=average),
            jm)(x))
        key = "har_avg" if average else "har"
        for r in ranks:
            np.testing.assert_allclose(r[key], want, rtol=1e-6)


def test_hierarchical_tree_all_reduce_matches_jax(world):
    inputs, _, ranks = world
    stacked = {k: jnp.stack([inputs[f"tree{r}/{k}"] for r in range(WORLD)])
               for k in TREE_SHAPES}
    want = _shard_map(
        lambda t: jcoll.hierarchical_tree_all_reduce(
            jax.tree.map(lambda x: x[0], t), average=True,
            partition_bytes=128), _jax_mesh())(stacked)
    for k in TREE_SHAPES:
        for r in ranks:
            assert r[f"tree/{k}"].shape == TREE_SHAPES[k]
            np.testing.assert_allclose(r[f"tree/{k}"], np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def _assert_trajectory(losses, leaves, want_losses, want_leaves, tcfg):
    """The AdamW trajectory test's tolerances (tests/test_torch_port_train
    .py), its carve-out included: the K slice of qkv_b, whose gradient is
    exactly zero, is Adam's rounding noise in either framework."""
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    H, Dh = tcfg.num_heads, tcfg.head_dim
    k_cols = np.arange(H * Dh, (H + tcfg.kv_heads) * Dh)
    for (path, want), got in zip(want_leaves, leaves):
        if jax.tree_util.keystr(path) == "['layers']['qkv_b']":
            for x in (got, want):          # three steps of at most lr
                assert float(np.abs(x[:, k_cols]).max()) <= 3.1e-3
            got, want = np.delete(got, k_cols, 1), np.delete(want, k_cols, 1)
        diff = np.linalg.norm(got - want)
        assert diff <= 1e-5 * np.linalg.norm(want), (path, diff)


def test_hierarchical_step_matches_one_process_and_jax(world):
    inputs, params_np, ranks = world
    jcfg, tcfg = _tiny()
    batch_np = (inputs["toks"], inputs["tgts"])
    leaves = [[r[f"p{i}"] for i in range(len(jax.tree.leaves(params_np)))]
              for r in ranks]
    for r in range(1, WORLD):               # every rank holds the same
        np.testing.assert_array_equal(ranks[r]["losses"], ranks[0]["losses"])
        for a, b in zip(leaves[0], leaves[r]):
            np.testing.assert_array_equal(a, b)

    # One process, the whole batch, the flat reduce (a world of one).
    import byteps_tpu_torch as bps
    params = tfm.params_from_numpy(params_np, tcfg, device="cpu")
    opt = bps.DistributedOptimizer(torch.optim.AdamW(
        tree_leaves(params), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4))
    step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, tcfg), opt,
                                device="cpu")
    batch = tuple(torch.from_numpy(a).long() for a in batch_np)
    single = [float(step(params, batch)) for _ in range(3)]
    flat = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_unflatten(
            jax.tree.structure(params_np),
            [p.detach().numpy() for p in tree_leaves(params)]))[0]
    _assert_trajectory(ranks[0]["losses"], leaves[0], single, flat, tcfg)

    # JAX on the (2, 2) mesh, DistributedOptimizer(hierarchical=True).
    jopt = jbps.DistributedOptimizer(optax.adamw(1e-3), hierarchical=True)
    jstep = jbps.build_train_step(lambda p, b: jtfm.loss_fn(p, b, jcfg),
                                  jopt, _jax_mesh(), donate=False)
    jparams = jax.tree.map(jnp.asarray, params_np)
    jstate = jopt.init(jparams)
    jbatch = tuple(jnp.asarray(a, jnp.int32) for a in batch_np)
    jlosses = []
    for _ in range(3):
        jparams, jstate, loss = jstep(jparams, jstate, jbatch)
        jlosses.append(float(loss))
    _assert_trajectory(ranks[0]["losses"], leaves[0], jlosses,
                       jax.tree_util.tree_flatten_with_path(
                           jax.tree.map(np.asarray, jparams))[0], tcfg)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]
