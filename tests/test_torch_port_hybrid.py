"""byteps_tpu_torch's five-axis hybrid train step vs the JAX package's.

One 4-rank gloo world (``tests/torch_port_parallel_worker.py hybrid``),
spawned once for the module, trains the reference test's configs
(tests/test_hybrid.py's CFG and CFG_MOE) from JAX's parameters on one
global batch, 3 steps, under each layout scaled to 4 ranks: dp, dp x tp,
tp x sp, pp x dp (2 and 4 microbatches), pp x tp (also with the streamed
LM head), MoE ep x dp and ep x tp, the MoE aux loss under pp x ep, and
ZeRO-1 on dp x tp and dp.  Each trajectory is held to JAX's single-device
one at the reference's own tolerance (the aux run, layout-dependent, to
JAX on the same layout), and the port's single-rank run to JAX's
single-device run leaf by leaf.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.models import hybrid as jhybrid
from byteps_tpu.parallel import sharded as jsharded
from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
from byteps_tpu_torch.models import hybrid
from torch_port_parallel_worker import collect, spawn
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 4
STEPS = 3
CFG = jhybrid.HybridConfig(vocab_size=64, num_layers=4, d_model=16,
                           num_heads=4, d_ff=32, max_seq_len=32)
CFG_MOE = jhybrid.HybridConfig(vocab_size=64, num_layers=2, d_model=16,
                               num_heads=4, d_ff=32, max_seq_len=32,
                               num_experts=4, capacity_factor=8.0)
# layout -> (config, the JAX run it is held to)
LAYOUTS = {
    "dp4": ("d", "sgd"), "dp2_tp2": ("d", "sgd"), "tp2_sp2": ("d", "sgd"),
    "pp2_dp2_mb2": ("d", "sgd"), "pp2_dp2_mb4": ("d", "sgd"),
    "pp2_tp2_mb2": ("d", "sgd"),
    # The streamed LM head against the full-logits run, as
    # test_fused_ce_matches_dense_across_axes holds JAX's.
    "pp2_tp2_mb2_ce16": ("d", "sgd"),
    "moe_ep2_dp2": ("m", "sgd"), "moe_ep2_tp2": ("m", "sgd"),
    "zero1_dp2_tp2": ("d", "adam"), "zero1_dp4": ("d", "adam"),
}


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


def _jax_run(cfg, opt, params, batch, axes, mb=1):
    """JAX's hybrid step 3 times: (losses, final leaves)."""
    mesh = jbps.make_mesh(**axes)
    step, _ = jhybrid.build_hybrid_train_step(cfg, opt, mesh,
                                              num_microbatches=mb)
    p = jsharded.shard_params(
        jhybrid.stage_params(jax.tree.map(jnp.asarray, params),
                             int(mesh.shape["pp"])),
        mesh, jhybrid.param_specs(cfg))
    s = opt.init(p)
    losses = []
    for _ in range(STEPS):
        p, s, loss = step(p, s, batch)
        losses.append(float(loss))
    return losses, [np.asarray(x) for x in jax.tree.leaves(p)]


def _params(cfg, rng):
    """JAX's parameter tree (init_params' keys and shapes) filled from a
    numpy generator as init_params scales it: normal / sqrt(fan_in)
    weights, 0.02-scaled positions, unit norm scales, zero biases."""
    def fill(path, leaf):
        name = path[-1].key
        if name.endswith(("_scale", "_bias")):
            return np.full(leaf.shape, name.endswith("_scale"), np.float32)
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "pos":
            return np.float32(0.02) * x
        fan = leaf.shape[-1] if name == "embed" else leaf.shape[-2]
        return x / np.float32(np.sqrt(fan))
    shapes = jax.eval_shape(lambda: jhybrid.init_params(jax.random.key(0),
                                                        cfg))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    params = {"d": _params(CFG, rng), "m": _params(CFG_MOE, rng)}
    toks = rng.randint(0, 64, size=(8, 32)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    inputs = {"toks": toks, "tgts": tgts}
    for key, tree in params.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            inputs[f"{key}/" + "/".join(p.key for p in path)] = leaf
    d = tmp_path_factory.mktemp("hybrid_world")
    procs = spawn("hybrid", inputs, d)
    # The JAX runs, while the world runs.
    one = dict(dp=1, devices=jax.devices()[:1])
    batch = (jnp.asarray(toks), jnp.asarray(tgts))
    refs = {
        ("d", "sgd"): _jax_run(CFG, optax.sgd(0.1), params["d"], batch, one),
        ("d", "adam"): _jax_run(CFG, optax.adam(1e-2), params["d"], batch,
                                one),
        ("m", "sgd"): _jax_run(CFG_MOE, optax.sgd(0.1), params["m"], batch,
                               one),
        "aux": _jax_run(dataclasses.replace(CFG_MOE, aux_loss_weight=0.01),
                        optax.sgd(0.1), params["m"], batch,
                        dict(pp=2, ep=2, devices=jax.devices()[:WORLD]),
                        mb=2),
    }
    return params, refs, collect(procs, d)


@pytest.mark.parametrize("cfg", [CFG, CFG_MOE], ids=["dense", "moe"])
def test_param_specs_and_shapes_match_jax(cfg):
    """The spec tree and, through ``init_params``, the parameter shapes."""
    tcfg = hybrid.HybridConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)
                                  if f.name != "dtype"})
    want = jax.tree_util.tree_flatten_with_path(
        jhybrid.param_specs(cfg), is_leaf=_is_spec)[0]
    tree = hybrid.param_specs(tcfg)
    assert [(jax.tree_util.keystr(p), tuple(s)) for p, s in want] == list(
        zip(tree_paths(tree), map(tuple, tree_leaves(tree))))
    shapes = jax.eval_shape(lambda: jhybrid.init_params(jax.random.key(0),
                                                        cfg))
    got = hybrid.init_params(torch.Generator().manual_seed(0), tcfg,
                             device="cpu")
    assert [tuple(x.shape) for x in jax.tree.leaves(shapes)] == [
        tuple(x.shape) for x in tree_leaves(got)]


def test_single_rank_matches_jax_leaf_by_leaf(world):
    """The port's step on a mesh of one rank against JAX's single-device
    step: losses and every parameter after 3 SGD steps."""
    _, refs, ranks = world
    want_losses, want_leaves = refs[("d", "sgd")]
    np.testing.assert_allclose(ranks[0]["single/losses"], want_losses,
                               rtol=1e-5)
    for i, want in enumerate(want_leaves):
        got = ranks[0][f"single/p{i}"]
        assert got.shape == want.shape
        diff = np.linalg.norm(got - want)
        assert diff <= 1e-5 * np.linalg.norm(want), (i, diff)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_layout_matches_single_device(world, layout):
    _, refs, ranks = world
    want = refs[LAYOUTS[layout]][0]
    got = ranks[0][f"{layout}/losses"]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert got[-1] < got[0]


def test_moe_aux_loss_under_pp_gives_gate_gradient(world):
    """The aux loss under pp=2 x ep=2 (it rides beside the pipeline's
    carry) against JAX on the same layout — its value depends on the
    layout — and the router gets a load-balancing gradient."""
    _, refs, ranks = world
    np.testing.assert_allclose(ranks[0]["moe_aux_pp2_ep2/losses"],
                               refs["aux"][0], rtol=2e-4, atol=2e-5)
    for r in ranks:
        assert float(r["moe_aux_pp2_ep2/gate_grad"]) > 0


@pytest.mark.parametrize("layout,axes", [("zero1_dp2_tp2", dict(dp=2, tp=2)),
                                         ("zero1_dp4", dict(dp=4))])
def test_zero1_moments_live_split(world, layout, axes):
    """Each rank's Adam moment is 1/dp of its block of the param wherever
    JAX's ZeRO-1 rule gives the leaf the dp axis, and the whole block
    elsewhere."""
    params, _, ranks = world
    mesh = jbps.make_mesh(**axes, devices=jax.devices()[:WORLD])
    staged = jhybrid.stage_params(params["d"], 1)
    up = jsharded._shard_free_axis(jhybrid.param_specs(CFG), staged, mesh,
                                   "dp", 1024)
    dp = axes["dp"]
    split = [dp if "dp" in spec else 1
             for spec in jax.tree.leaves(up, is_leaf=_is_spec)]
    assert max(split) > 1
    for r in ranks:
        moments = r[f"{layout}/moments"]
        for (moment, block), n in zip(moments, split):
            assert moment * n == block
