"""byteps_tpu_torch's sharded step (DTensor) vs the JAX package's GSPMD one.

The spec functions are pure shape code: ``param_specs`` against JAX's in
this process, and ``zero1_opt_specs`` / ``fsdp_param_specs`` and their
errors on the meshes of one 4-rank gloo world, spawned once for the module
(``tests/torch_port_parallel_worker.py sharded``), against JAX's on
4-device meshes.  In the same world ``build_sharded_train_step`` runs the
tiny transformer 3 AdamW steps from JAX's parameters on one global batch
five ways (replicated specs and ZeRO-1 on dp=4, FSDP on dp=4, FSDP over TP
and TP with flash attention on dp=2 x tp=2), each held to JAX's
single-device step, the trajectory ``tests/test_sharded.py`` holds JAX's
own sharded step to; ZeRO-1's moments and FSDP's params must live 1/dp per
rank.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import PartitionSpec as JP

import byteps_tpu as jbps
from byteps_tpu.models import transformer as jtfm
from byteps_tpu.parallel import sharded as jsharded
from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
from byteps_tpu_torch.models import transformer as tfm
from torch_port_parallel_worker import collect, spawn
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 4
STEPS = 3
CASES = ("plain", "zero1", "fsdp", "fsdp_tp", "flash_tp")


def _jspecs(tree):
    """{keystr: spec as a list} of a JAX spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return {jax.tree_util.keystr(p): [list(e) if isinstance(e, tuple) else e
                                      for e in s] for p, s in flat}


def _jcfg(attn="dense"):
    return jtfm.get_config("tiny", causal=True, remat=False,
                           dtype=jnp.float32, attn_impl=attn)


def _jmesh(**axes):
    return jbps.make_mesh(**axes, devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """JAX's tiny params and two global batches (S = 32, and S = 64 for
    flash), and the 4 ranks' results."""
    rng = np.random.RandomState(0)
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(0), _jcfg()))
    toks = rng.randint(0, 1024, size=(16, 33))
    ftoks = rng.randint(0, 1024, size=(8, 65))
    inputs = {"toks": toks[:, :-1], "tgts": toks[:, 1:],
              "ftoks": ftoks[:, :-1], "ftgts": ftoks[:, 1:]}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        inputs["param/" + "/".join(p.key for p in path)] = leaf
    d = tmp_path_factory.mktemp("sharded_world")
    procs = spawn("sharded", inputs, d)
    refs = {"dense": _jax_trajectory(params, inputs, "dense"),
            "flash": _jax_trajectory(params, inputs, "flash")}
    return inputs, refs, collect(procs, d)


def _jax_trajectory(params, inputs, attn):
    """JAX's single-device AdamW step, 3 times: (losses, final leaves, the
    first step's gradient leaves)."""
    cfg = _jcfg(attn)
    pre = "f" if attn == "flash" else ""
    batch = tuple(jnp.asarray(inputs[pre + k], jnp.int32)
                  for k in ("toks", "tgts"))
    opt = optax.adamw(1e-3)

    @jax.jit
    def step(p, s, b):
        loss, g = jax.value_and_grad(
            lambda p: jtfm.loss_fn(p, b, cfg))(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, g

    p = jax.tree.map(jnp.asarray, params)
    s = opt.init(p)
    losses, grads = [], None
    for _ in range(STEPS):
        p, s, loss, g = step(p, s, batch)
        losses.append(float(loss))
        grads = grads or [np.asarray(x) for x in jax.tree.leaves(g)]
    return losses, [np.asarray(x) for x in jax.tree.leaves(p)], grads


@pytest.mark.parametrize("name,tp_axis,pp_axis", [
    ("tiny", "tp", None), ("llama_tiny", "tp", None), ("tiny", "tp", "pp"),
    ("llama_tiny", "mp", "pp")])
def test_param_specs_match_jax(name, tp_axis, pp_axis):
    want = _jspecs(jtfm.param_specs(jtfm.get_config(name), tp_axis,
                                    pp_axis))
    tree = tfm.param_specs(tfm.get_config(name), tp_axis, pp_axis)
    got = {p: list(s) for p, s in zip(tree_paths(tree), tree_leaves(tree))}
    assert got == want


def _jshapes(name):
    """JAX's parameter tree of a named config, as shapes (the spec
    functions read nothing else)."""
    return jax.eval_shape(lambda: jtfm.init_params(jax.random.key(0),
                                                   jtfm.get_config(name)))


@functools.lru_cache(maxsize=None)
def _jax_spec_case(case):
    opt = optax.adamw(1e-3)
    tiny = _jshapes("tiny")
    rep = jax.tree.map(lambda _: JP(), tiny)
    if case == "zero1_dp4":
        return _jspecs(jsharded.zero1_opt_specs(opt, tiny, _jmesh(dp=4),
                                                rep)[0].mu)
    if case == "zero1_embed_dp":
        return _jspecs(jsharded.zero1_opt_specs(
            opt, tiny, _jmesh(dp=4), dict(rep, embed=JP("dp")))[0].mu)
    if case == "zero1_ici":
        hier = jbps.make_hierarchical_mesh(2, devices=jax.devices()[:WORLD])
        return _jspecs(jsharded.zero1_opt_specs(opt, tiny, hier, rep,
                                                dp_axis="ici_dp")[0].mu)
    if case == "fsdp_dp4":
        return _jspecs(jsharded.fsdp_param_specs(tiny, _jmesh(dp=4),
                                                 min_shard_elems=64))
    return _jspecs(jsharded.fsdp_param_specs(
        _jshapes("llama_tiny"), _jmesh(dp=2, tp=2),
        base_specs=jtfm.param_specs(jtfm.get_config("llama_tiny")),
        min_shard_elems=64))


@pytest.mark.parametrize("case", ["zero1_dp4", "zero1_embed_dp", "zero1_ici",
                                  "fsdp_dp4", "fsdp_tp"])
def test_zero1_and_fsdp_specs_match_jax(world, case):
    """The state specs of each parameter (JAX: Adam's ``mu`` subtree) and
    FSDP's param specs, alone and over TP's."""
    _, _, ranks = world
    want = _jax_spec_case(case)
    for r in ranks:
        assert json.loads(str(r[f"spec/{case}"])) == want
    if case == "zero1_embed_dp":             # no leaf split twice over dp
        assert want["['embed']"] == ["dp"]
    if case == "fsdp_tp":
        both = [s for s in want.values() if "dp" in s and "tp" in s]
        assert both, "no leaf carries both dp (FSDP) and tp"


def _jax_error(case):
    tiny = _jshapes("tiny")
    rep = jax.tree.map(lambda _: JP(), tiny)
    hier = jbps.make_hierarchical_mesh(2, devices=jax.devices()[:WORLD])
    calls = {
        "zero1_hier": lambda: jsharded.zero1_opt_specs(optax.adamw(1e-3),
                                                       tiny, hier, rep),
        "fsdp_hier": lambda: jsharded.fsdp_param_specs(tiny, hier),
        "zero1_no_params": lambda: jbps.build_sharded_train_step(
            lambda p, b: 0.0, optax.adamw(1e-3), _jmesh(dp=4), rep,
            zero1=True)}
    try:
        calls[case]()
    except (TypeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


@pytest.mark.parametrize("case", ["zero1_hier", "fsdp_hier",
                                  "zero1_no_params"])
def test_spec_errors_match_jax(world, case):
    """A mesh without the dp axis (a hierarchical mesh's 'ici_dp' /
    'dcn_dp') raises the JAX package's ValueError; zero1 without params or
    specs its TypeError."""
    _, _, ranks = world
    want = _jax_error(case)
    assert want != "no error"
    for r in ranks:
        assert json.loads(str(r[f"error/{case}"])) == want


def test_flash_kernels_refuse_dtensors(world):
    """The kernels' wrapper takes plain tensors only; a DTensor raises
    rather than handing the kernels one rank's block."""
    _, _, ranks = world
    for r in ranks:
        err = json.loads(str(r["error/flash_dtensor"]))
        assert err.startswith("TypeError: flash_attention takes plain")


def test_flash_adapter_runs_per_rank_on_dtensors(world):
    """``flash_attention_fn`` on DTensors (batch over dp, heads over tp)
    equals the call on the whole tensors, forward and gradients, and its
    output keeps the inputs' placements."""
    _, _, ranks = world
    for r in ranks:
        got, want = r["flash_fn/out"]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        for got, want in r["flash_fn/grads"]:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        assert json.loads(str(r["flash_fn/placements"])) == [
            "S(0)", "S(1)"]


def _assert_trajectory(losses, leaves, want_losses, want_leaves, grads):
    """The AdamW trajectory tolerances of tests/test_torch_port_train.py:
    losses to 1e-5, every leaf to 1e-5 relative (L2), less the elements
    whose first gradient is below 1e-5 of their leaf's largest.  Adam turns
    the rounding noise of such a gradient into steps of either sign in
    either framework: the K slice of qkv_b (exactly zero: softmax ignores a
    per-row logit shift), which test_torch_port_train.py leaves out, and,
    under flash attention, a Q-bias element of this batch (8e-8 against
    1.3e-2; JAX's flash and the port's plain version round it apart).
    Those elements stay within the 3 steps of at most lr each side
    takes."""
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    paths = tree_paths(tfm.param_shapes(tfm.get_config("tiny")))
    for path, got, want, g in zip(paths, leaves, want_leaves, grads):
        noise = np.abs(g) < 1e-5 * np.abs(g).max()
        assert float(np.abs(got - want)[noise].max(initial=0)) <= 6.2e-3
        got, want = got[~noise], want[~noise]
        diff = np.linalg.norm(got - want)
        assert diff <= 1e-5 * np.linalg.norm(want), (path, diff)


@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_jax(world, case):
    """Each layout's 3 AdamW steps against JAX's single-device step from
    the same params and batch; every rank holds the same."""
    _, refs, ranks = world
    want_losses, want_leaves, grads = refs["flash" if case == "flash_tp"
                                           else "dense"]
    n = len(want_leaves)
    leaves = [ranks[0][f"{case}/p{i}"] for i in range(n)]
    _assert_trajectory(ranks[0][f"{case}/losses"], leaves, want_losses,
                       want_leaves, grads)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{case}/losses"],
                                      ranks[0][f"{case}/losses"])
    assert ranks[0][f"{case}/losses"][-1] < ranks[0][f"{case}/losses"][0]
    if case == "flash_tp":
        # The flash adapter ran (its plain versions, on the CPU) on each
        # rank's block: 2 layers x 3 steps, forward, dQ and dK/dV.
        for r in ranks:
            assert r["flash_tp/calls"].tolist() == [6, 6, 6]


def _split(spec, sizes):
    return int(np.prod([sizes[a] for e in spec if e is not None
                        for a in (e if isinstance(e, list) else [e])]))


@pytest.mark.parametrize("case", ["zero1", "fsdp", "fsdp_tp"])
def test_state_and_params_live_split(world, case):
    """Under ZeRO-1 each rank holds 1/dp of every moment its spec splits
    (the params whole); under FSDP 1/dp of every param its spec splits
    (times tp where TP splits it too)."""
    _, _, ranks = world
    if case == "zero1":
        specs = _jax_spec_case("zero1_dp4")
        key, sizes = "moment", {"dp": 4}
    elif case == "fsdp":
        specs = _jax_spec_case("fsdp_dp4")
        key, sizes = "local", {"dp": 4}
    else:
        specs = _jspecs(jsharded.fsdp_param_specs(
            _jshapes("tiny"), _jmesh(dp=2, tp=2),
            base_specs=jtfm.param_specs(jtfm.get_config("tiny")),
            min_shard_elems=64))
        key, sizes = "local", {"dp": 2, "tp": 2}
    split = [_split(s, sizes) for s in specs.values()]
    assert max(split) > 1
    for r in ranks:
        for i, n in enumerate(split):
            local, whole = r[f"{case}/{key}{i}"]
            assert local * n == whole, (list(specs)[i], local, whole)
        if case == "zero1":
            for i in range(len(split)):
                local, whole = r[f"zero1/local{i}"]
                assert local == whole
