"""byteps_tpu_torch's compression plane vs the JAX package's.

Each compressor, fed the same inputs (numpy, from a seed) and the same
state, over three successive rounds so that PRNG lanes, error feedback and
momentum carry over, must give the JAX package's payloads and states: words
and levels bit for bit (compared as numpy uint32), floats to 1e-6 of their
largest value (a sum's order may differ between the frameworks).  Then the
compressed reduction: at world 1 against JAX under ``local_mode``, and on a
2-rank gloo world against JAX on a 2-device CPU mesh.
"""

import functools
import json
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
from byteps_tpu.models import transformer as jtfm
from byteps_tpu.ops import collectives as jcoll
from byteps_tpu.ops import compressor as jC
from byteps_tpu_torch.ops import collectives
from byteps_tpu_torch.ops import compressor as C
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_compress_worker.py")
ROUNDS = 3
RTOL = 1e-6


def flat(node, key=None):
    """Leaves of a state or payload in jax.tree order (dict keys sorted),
    as numpy; int32 words and PRNG lanes as the uint32 they hold, payload
    indices (``idx``) as int32."""
    if isinstance(node, dict):
        return [a for k in sorted(node) for a in flat(node[k], k)]
    if isinstance(node, (tuple, list)):
        return [a for v in node for a in flat(v)]
    if node is None:
        return []
    a = np.asarray(node.detach().cpu().numpy()
                   if isinstance(node, torch.Tensor) else node)
    return [a.view(np.uint32) if a.dtype == np.int32 and key != "idx"
            else a]


def assert_same(got, want, what, rtol=RTOL, atol=0.0):
    got, want = flat(got), [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        if w.dtype in (np.uint32, np.int32):
            np.testing.assert_array_equal(g, w, err_msg=f"{what}[{i}]")
        else:
            top = float(np.abs(w).max()) if w.size else 0.0
            err = float(np.abs(g - w).max()) if w.size else 0.0
            assert err <= rtol * top + atol, (what, i, err, top, atol)


def _rounds(n, seed):
    rng = np.random.RandomState(seed)
    return [(rng.randn(n) * (r + 1)).astype(np.float32)
            for r in range(ROUNDS)]


def _run_both(kwargs, xs, server=False):
    """Compress the same inputs through both packages for ROUNDS rounds;
    compare payloads, states and decompressed values each round."""
    jc, tc = jC.create(kwargs, server=server), C.create(kwargs, server=server)
    n = xs[0].size
    js, ts = jc.init_state(n), tc.init_state(n)
    assert_same(ts, js, "init state")
    for r, x in enumerate(xs):
        jp, js = jc.compress(jnp.asarray(x), js)
        tp, ts = tc.compress(torch.from_numpy(x), ts)
        assert_same(tp, jp, f"payload round {r}")
        assert_same(ts, js, f"state round {r}")
        assert_same(tc.decompress(tp, n), jc.decompress(jp, n),
                    f"decompress round {r}")
        assert tc.payload_bytes(n) == jc.payload_bytes(n)
    return tc


@pytest.mark.parametrize("scaled", [True, False])
def test_onebit_matches_jax(scaled):
    _run_both({"compressor": "onebit", "onebit_scaling": scaled},
              _rounds(4096 * 5 + 77, 0))


@pytest.mark.parametrize("partition", ["linear", "natural"])
@pytest.mark.parametrize("normalize", ["max", "l2"])
@pytest.mark.parametrize("s", [15, 127])
def test_dithering_matches_jax(partition, normalize, s):
    """Levels, signs and PRNG lanes bit for bit.  With normalize="l2" the
    norm is a sum of squares, whose order differs: it may land one ulp
    apart, and a level whose rounding draw sits within that ulp of its
    threshold could then differ by one.  On these inputs none does (the
    test demands equality), and the norm agrees to 1e-6."""
    _run_both({"compressor": "dithering", "k": s, "partition": partition,
               "normalize": normalize, "seed": 7}, _rounds(4096 * 3 + 5, s))


def test_topk_matches_jax():
    """Inputs without ties: torch.topk and lax.top_k order equal
    magnitudes differently."""
    _run_both({"compressor": "topk", "k": 300}, _rounds(5000, 1))


def test_randomk_matches_jax():
    """The indices replay exactly, collisions included (k > n/2 here)."""
    xs = _rounds(1000, 2)
    _run_both({"compressor": "randomk", "k": 700, "seed": 9}, xs)


@pytest.mark.parametrize("inner", ["onebit", "dithering", "topk"])
def test_ef_and_nesterov_layering_match_jax(inner):
    kw = {"compressor": inner, "k": 64 if inner == "topk" else 15,
          "ef": "vanilla", "momentum": "nesterov", "momentum_mu": 0.8}
    comp = _run_both(kw, _rounds(4096 * 2 + 9, 3))
    assert isinstance(comp, C.NesterovMomentum) and comp.mu == 0.8
    assert isinstance(comp.inner, C.ErrorFeedback)
    srv = _run_both(kw, _rounds(4096 * 2 + 9, 4), server=True)
    assert isinstance(srv, C.ErrorFeedback)       # momentum is worker-only
    assert C.server_side(comp) is comp.inner


def test_set_lr_scale_is_one_shot_and_matches_jax():
    kw = {"compressor": "onebit", "ef": "vanilla"}
    jc, tc = jC.create(kw), C.create(kw)
    n = 4096 + 3
    x0, x1, x2 = _rounds(n, 5)
    js, ts = jc.init_state(n), tc.init_state(n)
    _, js = jc.compress(jnp.asarray(x0), js)
    _, ts = tc.compress(torch.from_numpy(x0), ts)
    # Nested like an optimizer's state; composes multiplicatively.
    js = jC.set_lr_scale({"opt": (js,)}, 0.5)["opt"][0]
    ts = C.set_lr_scale(C.set_lr_scale({"opt": (ts,)}, 2.0), 0.25)["opt"][0]
    assert float(ts["lr_scale"]) == float(js["lr_scale"]) == 0.5
    np.testing.assert_array_equal(ts["error"].numpy(),
                                  np.asarray(js["error"]))
    for x in (x1, x2):                     # applied once, then back to 1
        jp, js = jc.compress(jnp.asarray(x), js)
        tp, ts = tc.compress(torch.from_numpy(x), ts)
        assert_same(tp, jp, "payload")
        assert_same(ts, js, "state")
        assert float(ts["lr_scale"]) == 1.0


def test_registry_and_reference_kwargs():
    assert C.known_compressors() == jC.known_compressors()
    ref = {"byteps_compressor_type": "dithering", "byteps_compressor_k": "7",
           "byteps_compressor_partition": "natural",
           "byteps_compressor_normalize": "l2",
           "byteps_error_feedback_type": "vanilla",
           "byteps_momentum_type": "nesterov", "byteps_momentum_mu": "0.5"}
    comp = C.create(ref)
    d = comp.inner.inner
    assert (comp.mu, d.s, d.partition, d.normalize) == (0.5, 7, "natural",
                                                        "l2")
    assert C.create({"compressor": "onebit",
                     "onebit_scaling": "false"}).scaled is False
    for bad, match in (({"compressor": "nope"}, "unknown compressor"),
                       ({}, "no compressor type"),
                       ({"compressor": "onebit", "ef": "fancy"},
                        "error-feedback"),
                       ({"compressor": "onebit", "momentum": "adam"},
                        "momentum"),
                       ({"compressor": "dithering", "k": 200}, "levels")):
        with pytest.raises(ValueError, match=match):
            C.create(bad)

    @C.register("halfbit")
    def _make(kw):
        return C.OnebitCompressor(scaled=False)
    try:
        assert "halfbit" in C.known_compressors()
        assert C.create({"compressor": "halfbit"}).scaled is False
    finally:
        from byteps_tpu_torch.ops.compressor import registry
        del registry._FACTORIES["halfbit"]


def test_compression_ratio_matches_jax():
    for n, comp in ((4096, "onebit"), (4096 * 40 + 1, "onebit"),
                    (4096, "topk"), (10000, "dithering")):
        kw = {"compressor": comp, "k": 41 if comp == "topk" else 15}
        t = {"w": torch.zeros(n), "b": [torch.zeros(7)]}
        j = {"w": jnp.zeros(n), "b": [jnp.zeros(7)]}
        assert C.compression_ratio(t, C.create(kw)) == pytest.approx(
            jC.compression_ratio(j, jC.create(kw)), rel=1e-12)
    assert C.compression_ratio({"w": torch.zeros(4096)},
                               C.OnebitCompressor()) > 30


def test_tiny_buckets_skip_expanding_compression():
    """A bucket whose payload would exceed its raw bytes ships raw: at
    world 1 the reduce returns it exactly, with the state untouched."""
    comp = C.create({"compressor": "onebit", "ef": "vanilla"})
    n = 100
    assert comp.payload_bytes(n) > n * 4
    tree = {"w": torch.linspace(-1.0, 1.0, n)}
    state = C.init_compression_state(tree, comp)
    with collectives.local_mode():
        out, new = C.compressed_tree_all_reduce(tree, comp, state,
                                                average=False)
    assert torch.equal(out["w"], tree["w"])
    assert new["worker"][0] is state["worker"][0]
    assert new["server"][0] is state["server"][0]


# ---------------------------------------------------------------------------
# The compressed reduction.
# ---------------------------------------------------------------------------
def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


@functools.lru_cache(maxsize=None)
def _tiny_grads(seeds):
    """Gradients of the tiny transformer (float32) at its init, on one
    batch per seed, as numpy trees (once per process; callers copy)."""
    cfg = jtfm.get_config("tiny", dtype=jnp.float32)
    params = jtfm.init_params(jax.random.key(0), cfg)
    grad = jax.jit(jax.grad(lambda p, b: jtfm.loss_fn(p, b, cfg)))
    out = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        toks = rng.randint(0, cfg.vocab_size, size=(2, 33))
        batch = (jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
        out.append(jax.tree.map(np.asarray, grad(params, batch)))
    return out


PB = 64 * 1024       # several buckets on the tiny transformer


def _bucket_max(tree):
    """max |x| of each bucket of ``tree`` (a torch tree)."""
    maxes = []

    def record(buf, bi):
        maxes.append(float(buf.abs().max()))
        return buf
    with collectives.local_mode():
        collectives.bucketed_tree_all_reduce(tree, partition_bytes=PB,
                                             bucket_transform=record)
    return maxes


@pytest.mark.parametrize("kwargs", [
    {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov"},
    {"compressor": "dithering", "k": 15},
])
def test_world1_reduction_matches_jax_local_mode(kwargs):
    """Reduced leaves to 1e-6 of their largest value.  Each bucket's state
    to 1e-6 of the largest value of that bucket's gradient: a mean |x| over
    the bucket (the onebit scale) may differ in its last bit between the
    frameworks, which moves every error-feedback residual by as much; where
    the residuals themselves are near zero (the server leg, which
    requantizes values that are already +-scale), that is all they hold."""
    grads = _tiny_grads(range(ROUNDS))
    jc, tc = jC.create(kwargs), C.create(kwargs)
    jstate = jC.init_compression_state(grads[0], jc, PB)
    tstate = C.init_compression_state(_to_torch(grads[0]), tc, PB)
    assert len(tstate["worker"]) == len(jstate["worker"]) > 4
    assert_same(tstate, jstate, "init state")
    for r, g in enumerate(grads):
        with jcoll.local_mode():
            jout, jstate = jC.compressed_tree_all_reduce(
                jax.tree.map(jnp.asarray, g), jc, jstate, partition_bytes=PB)
        with collectives.local_mode():
            tout, tstate = C.compressed_tree_all_reduce(
                _to_torch(g), tc, tstate, partition_bytes=PB)
        assert_same(tout, jout, f"reduced round {r}")
        for bi, top in enumerate(_bucket_max(_to_torch(g))):
            for side in ("worker", "server"):
                if jstate[side] is not None:
                    assert_same(tstate[side][bi], jstate[side][bi],
                                f"{side} state {bi} round {r}",
                                atol=RTOL * top)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_gloo_reduction_matches_jax_mesh(tmp_path):
    """onebit + EF (bidirectional: worker and server state) on two gloo
    ranks, each with its own gradients, against JAX on a 2-device mesh:
    the same reduced values on both ranks, and each rank's state equal to
    its shard of JAX's (states to 1e-6 of the largest gradient, as in the
    world-1 test)."""
    kwargs = {"compressor": "onebit", "ef": "vanilla"}
    rounds, world, pb = 2, 2, 16 * 1024
    rng = np.random.RandomState(11)
    shapes = [(3000,), (40, 70), (5,), (4096 + 9,)]
    grads = [[[rng.randn(*s).astype(np.float32) for s in shapes]
              for _ in range(world)] for _ in range(rounds)]
    np.savez(tmp_path / "in.npz", **{
        f"g{r}_{k}_{i}": a for r in range(rounds) for k in range(world)
        for i, a in enumerate(grads[r][k])})

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(k), str(world), str(port),
         str(tmp_path / "in.npz"), str(tmp_path / f"out{k}.npz"),
         json.dumps(kwargs), str(pb), str(len(shapes)), str(rounds)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for k in range(world)]
    try:
        logs = [p.communicate(timeout=50)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [np.load(tmp_path / f"out{k}.npz") for k in range(world)]

    comp = jC.create(kwargs)
    mesh = Mesh(np.array(jax.devices()[:world]), ("dp",))
    state = jC.init_compression_state(grads[0][0], comp, pb)
    state = jax.tree.map(lambda l: jnp.stack([l] * world), state)

    def step(t, st):
        t, st = jax.tree.map(lambda x: x[0], (t, st))
        out, st = jC.compressed_tree_all_reduce(t, comp, st, axis_name="dp",
                                                partition_bytes=pb)
        return jax.tree.map(lambda x: x[None], (out, st))

    f = jax.jit(shard_map(step, mesh=mesh, in_specs=(P("dp"), P("dp")),
                          out_specs=(P("dp"), P("dp")), check_vma=False))
    for r in range(rounds):
        tree = [jnp.stack([jnp.asarray(grads[r][k][i]) for k in range(world)])
                for i in range(len(shapes))]
        out, state = f(tree, state)
        for k in range(world):
            got_out = [outs[k][f"o{r}_{i}"] for i in range(len(shapes))]
            want_out = [np.asarray(o)[k] for o in out]
            want_st = [np.asarray(l)[k] for l in jax.tree.leaves(state)]
            got_st = [outs[k][f"s{r}_{i}"] for i in range(len(want_st))]
            assert_same(got_out, want_out, f"rank {k} round {r} output")
            top = max(float(np.abs(g).max()) for g in grads[r][k])
            assert_same(got_st, want_st, f"rank {k} round {r} state",
                        atol=RTOL * top)
