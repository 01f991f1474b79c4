"""byteps_tpu_torch's host core and eager API against the JAX package's.

The core (declared-name registry, keys, partitions, placement hashes,
handles) against ``byteps_tpu.core.native`` on the same inputs; the eager
API (push_pull, async + poll + synchronize, push_pull_tree and its bucket
plan, broadcasts, step counter) at world 1 against ``byteps_tpu``'s, on
the same numpy inputs; and a 2-rank gloo world
(``tests/torch_port_api_worker.py``) against numpy: averages, sums, the
tree reduce, broadcasts of parameters and optimizer state.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import byteps_tpu as jbps
from byteps_tpu.common import fusion as jfusion
from byteps_tpu.core import native as jnative
import byteps_tpu_torch as bps
from byteps_tpu_torch.common import fusion
from byteps_tpu_torch.core import native
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_port_api_worker.py")


@pytest.fixture
def both():
    """Both packages initialized at world 1."""
    jbps.init()
    bps.init()
    yield
    bps.shutdown()
    jbps.shutdown()


# ---------------------------------------------------------------------------
# The core
# ---------------------------------------------------------------------------
def test_registry_and_handles_match_the_reference_core():
    """Declaration order, lookups, names, reset, and the handle table's
    states, call for call against a fresh reference core."""
    mine, ref = native.Core(), jnative._PyCore()
    for core in (mine, ref):
        assert core.get_declared_key("a") == -1
    names = ["Gradient.w", "Gradient.b", "Gradient.w", "metric.loss", ""]
    assert ([mine.declare_tensor(n) for n in names]
            == [ref.declare_tensor(n) for n in names] == [0, 1, 0, 2, 3])
    assert mine.num_declared() == ref.num_declared() == 4
    for i in (-1, 0, 3, 4):
        assert mine.declared_name(i) == ref.declared_name(i)
    assert mine.get_declared_key("metric.loss") == 2
    h = [mine.handle_allocate() for _ in range(3)]
    g = [ref.handle_allocate() for _ in range(3)]
    assert h == g == [0, 1, 2]
    mine.handle_mark_done(1)
    ref.handle_mark_done(1)
    mine.handle_release(2)
    ref.handle_release(2)
    for i in range(4):
        assert mine.handle_poll(i) == ref.handle_poll(i)
    assert [mine.handle_poll(i) for i in range(4)] == [0, 1, -1, -1]
    mine.reset_registry()
    ref.reset_registry()
    assert mine.num_declared() == ref.num_declared() == 0


@pytest.mark.parametrize("hash_fn", ["djb2", "built_in", "sdbm", "mixed",
                                     "naive"])
def test_keys_partitions_and_placement_match_the_reference(hash_fn):
    """encode/decode (k << 16 | p), partition bounds at the reference's
    partition sizes, and key -> server under every hash, against the
    reference's Python core (the C++ core, built from the port's
    byte-identical copy of its sources, is held against both in
    test_torch_port_native.py: the reference's own build writes into the
    JAX package)."""
    cores = [jnative._PyCore()]
    mine = native.get_core()
    keys = [mine.encode_key(k, p) for k in (0, 1, 7, 1000, 40000)
            for p in (0, 1, 3, 65535)]
    for ref in cores:
        assert keys == [ref.encode_key(k, p) for k in (0, 1, 7, 1000, 40000)
                        for p in (0, 1, 3, 65535)]
        assert [mine.decode_key(k) for k in keys] == [
            tuple(ref.decode_key(k)) for k in keys]
        for nbytes in (0, 1, 4096, 4 * 1024 * 1024, 10 * 1024 * 1024 + 3):
            assert mine.partition_bounds(nbytes, 4 * 1024 * 1024) == [
                tuple(b) for b in ref.partition_bounds(nbytes,
                                                       4 * 1024 * 1024)]
        for n in (0, 1, 3, 8):
            assert [mine.key_to_server(k, n, hash_fn) for k in keys] == [
                ref.key_to_server(k, n, hash_fn) for k in keys]


def test_pushpull_speed_window_and_trace_recorder(tmp_path):
    core = native.Core()
    core.telemetry_record(20_000_000)
    assert core.telemetry_speed_mbps() == pytest.approx(2.0)
    core.trace_record("x", "PUSH_PULL", 0, 5)
    assert core.trace_count() == 0                      # off by default
    core.trace_enable(True)
    core.trace_record("x", "PUSH_PULL", 0, 5)
    core.trace_dump(str(tmp_path / "comm.json"), 3)
    import json
    doc = json.loads((tmp_path / "comm.json").read_text())
    assert doc["traceEvents"] == [{"name": "x", "cat": "comm", "ph": "X",
                                   "ts": 0, "dur": 5, "pid": 3,
                                   "tid": "PUSH_PULL"}]
    assert core.trace_count() == 0


# ---------------------------------------------------------------------------
# The eager API at world 1
# ---------------------------------------------------------------------------
def test_push_pull_before_init_raises():
    with pytest.raises(RuntimeError, match="init"):
        bps.push_pull(torch.ones(2))


@pytest.mark.parametrize("comp", ["none", "fp16"])
def test_push_pull_and_async_match_the_reference(both, comp):
    """push_pull (averaged or summed), and push_pull_async + poll +
    synchronize, give the reference's values at world 1, bit for bit,
    also through the fp16 (bf16 wire) cast."""
    x = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    jc = getattr(jbps.Compression, comp)
    tc = getattr(bps.Compression, comp)
    for avg in (True, False):
        want = np.asarray(jbps.push_pull(jnp.asarray(x), name="t",
                                         average=avg, compression=jc))
        got = bps.push_pull(torch.from_numpy(x), name="t", average=avg,
                            compression=tc)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
    jh = jbps.push_pull_async(jnp.asarray(x), name="ta", compression=jc)
    th = bps.push_pull_async(torch.from_numpy(x), name="ta", compression=tc)
    assert bps.poll(th) and jbps.poll(jh)
    np.testing.assert_array_equal(bps.synchronize(th).numpy(),
                                  np.asarray(jbps.synchronize(jh)))
    for fn, jfn in ((bps.synchronize, jbps.synchronize),
                    (bps.poll, jbps.poll)):
        with pytest.raises(ValueError, match="handle"):
            fn(th)
        with pytest.raises(ValueError, match="handle"):
            jfn(jh)
    with pytest.raises(ValueError, match="handle"):
        bps.poll(10 ** 6)
    assert bps.declared_key("ta") >= 0


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"w1": rng.randn(16, 8).astype(np.float32),
            "b1": rng.randn(8).astype(np.float32),
            "layers": [rng.randn(4, 4).astype(np.float32),
                       rng.randn(300).astype(np.float32),
                       rng.randint(0, 9, size=(5,)).astype(np.int32)],
            "scale": rng.randn(2).astype(np.float32)}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree)


@pytest.mark.parametrize("fusion_bytes", [0, 64, 1024, 1 << 20])
def test_push_pull_tree_matches_the_reference(both, fusion_bytes):
    """push_pull_tree at fusion thresholds from off to above every leaf:
    the reference's values and dtypes, and the same bucket plan (buckets
    built, leaves fused and solo)."""
    import jax
    tree = _tree(1)
    fusion.reset_stats()
    jfusion.reset_stats()
    got = bps.push_pull_tree(_to_torch(tree), fusion_bytes=fusion_bytes)
    want = jbps.push_pull_tree(jax.tree.map(jnp.asarray, tree),
                               fusion_bytes=fusion_bytes)
    from byteps_tpu_torch.common.tree import tree_leaves
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    keys = ("plans_used", "buckets_built", "leaves_fused", "leaves_solo",
            "fused_bytes", "solo_bytes", "wire_messages_saved")
    assert ({k: fusion.get_stats()[k] for k in keys}
            == {k: jfusion.get_stats()[k] for k in keys})


@pytest.mark.parametrize("fusion_bytes", [64, 1000, 4096])
def test_bucket_plan_matches_the_reference_planner(fusion_bytes):
    """plan_buckets on the same items: the same buckets (members, tags,
    priorities) and solo leaves, in the same order."""
    items = tuple((i, n, dt, 2 if dt == "bfloat16" else 4)
                  for i, (n, dt) in enumerate(
                      [(10, "float32"), (300, "float32"), (7, "bfloat16"),
                       (64, "float32"), (2000, "float32"), (5, "bfloat16"),
                       (1, "float32")]))
    mine = fusion.plan_buckets(items, fusion_bytes)
    ref = jfusion.plan_buckets(items, fusion_bytes)
    assert [(b.tag, b.members, b.priority, b.nbytes) for b in mine.buckets] \
        == [(b.tag, b.members, b.priority, b.nbytes) for b in ref.buckets]
    assert mine.solo == ref.solo


def test_broadcasts_are_the_identity_at_world_one(both):
    tree = _to_torch(_tree(2))
    assert bps.broadcast_parameters(tree) is tree
    assert bps.broadcast_optimizer_state(tree) is tree


def test_step_counter_and_trace_window(tmp_path, monkeypatch):
    """mark_step advances current_step; inside BYTEPS_TRACE_START/END_STEP
    each step and push_pull is a span, written to
    <dir>/<local_rank>/comm.json the step after the window, as the
    reference writes it."""
    import json
    monkeypatch.setenv("BYTEPS_TRACE_ON", "1")
    monkeypatch.setenv("BYTEPS_TRACE_START_STEP", "1")
    monkeypatch.setenv("BYTEPS_TRACE_END_STEP", "2")
    monkeypatch.setenv("BYTEPS_TRACE_DIR", str(tmp_path))
    bps.init()
    try:
        s0 = bps.current_step()
        for _ in range(4):
            bps.push_pull(torch.ones(2), name="traced")
            bps.mark_step()
        assert bps.current_step() == s0 + 4
    finally:
        bps.shutdown()
        monkeypatch.delenv("BYTEPS_TRACE_ON")
        from byteps_tpu_torch.common.config import get_config
        get_config(refresh=True)
        native.get_core().trace_enable(False)
    if s0 == 0:
        doc = json.loads((tmp_path / "0" / "comm.json").read_text())
        names = [e["name"] for e in doc["traceEvents"]]
        assert names.count("traced") == 2 and "step_1" in names


def test_speed_suspend_resume_and_unported_entry_points(both):
    bps.push_pull(torch.ones(1000), name="speed")
    ts, mbps = bps.get_pushpull_speed()
    assert mbps > 0 and ts > 0
    k = bps.declare("keep.me")
    bps.suspend()
    bps.resume(1)
    assert bps.declared_key("keep.me") == k
    with pytest.raises(RuntimeError, match="needs PS mode"):
        bps.push_pull_sparse("emb", None, None)
    with pytest.raises(NotImplementedError, match="item 7b"):
        bps.get_fleet()
    assert bps.get_ps_session() is None


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------
def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_global_rank_override_leaves_data_slicing_on_the_process(
        monkeypatch):
    """BYTEPS_GLOBAL_RANK overrides rank() in both packages; the data
    helpers still slice by the process's own rank (0 here), as the
    reference slices by process index, and without the variable rank()
    is the process's again."""
    from byteps_tpu.utils import data as jdata
    from byteps_tpu_torch.utils import data as tdata
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    monkeypatch.setenv("BYTEPS_GLOBAL_RANK", "3")
    jbps.init()
    bps.init()
    try:
        assert bps.rank() == jbps.rank() == 3
        want = np.asarray(jdata.host_shard(jnp.asarray(x), size=4))
        got = tdata.host_shard(torch.from_numpy(x), size=4)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, x[:2])
    finally:
        bps.shutdown()
        jbps.shutdown()
    monkeypatch.delenv("BYTEPS_GLOBAL_RANK")
    jbps.init()
    bps.init()
    try:
        assert bps.rank() == jbps.rank() == 0
    finally:
        bps.shutdown()
        jbps.shutdown()


def test_force_distributed_reduces_at_world_one(monkeypatch):
    """BYTEPS_FORCE_DISTRIBUTED=1 at world 1: with a process group (a
    world-1 gloo group here) push_pull goes through dist.all_reduce and
    gives the reference's forced push_pull result, averaged and summed;
    without a group the tensor stays as it is and nothing is reduced."""
    import torch.distributed as dist
    monkeypatch.setenv("BYTEPS_FORCE_DISTRIBUTED", "1")
    x = np.random.RandomState(5).randn(4, 3).astype(np.float32)
    jbps.init()
    try:
        want = {avg: np.asarray(jbps.push_pull(jnp.asarray(x), name="f",
                                               average=avg))
                for avg in (True, False)}
    finally:
        jbps.shutdown()
    calls = []
    real = dist.all_reduce

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(dist, "all_reduce", counted)
    bps.init()
    try:
        got = bps.push_pull(torch.from_numpy(x), name="f")
        np.testing.assert_array_equal(got.numpy(), x)
        assert calls == []
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0)
        try:
            for avg in (True, False):
                got = bps.push_pull(torch.from_numpy(x), name="f",
                                    average=avg)
                np.testing.assert_array_equal(got.numpy(), want[avg])
            assert len(calls) == 2
        finally:
            dist.destroy_process_group()
    finally:
        bps.shutdown()


def run_worlds(*worlds):
    """Run the worker in each ``(world, prefix)``'s processes, all worlds
    at once; for each world, the per-rank npz files."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for world, prefix in worlds:
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, WORKER, str(r),
                                    str(world), str(port), str(prefix)],
                                   env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
                  for r in range(world)]
    try:
        logs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [[dict(np.load(f"{prefix}.{r}.npz")) for r in range(world)]
            for world, prefix in worlds]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("api")
    dist, single = run_worlds((2, d / "dist"), (1, d / "single"))
    return dist, single[0]


def test_two_ranks_average_sum_and_tree(two_ranks):
    """Average and sum against numpy's over both ranks' inputs, the async
    path too; push_pull_tree (fusion threshold 64 bytes: several buckets
    and solo leaves) against the numpy mean, the int leaf exact."""
    ranks, _ = two_ranks
    sys.path.insert(0, os.path.dirname(WORKER))
    from torch_port_api_worker import inputs
    ins = [inputs(r) for r in range(2)]
    for out in ranks:
        mean = (ins[0]["x"] + ins[1]["x"]) / 2
        np.testing.assert_allclose(out["avg"], mean, rtol=1e-6)
        np.testing.assert_allclose(out["async"], mean, rtol=1e-6)
        np.testing.assert_allclose(out["sum"], ins[0]["x"] + ins[1]["x"],
                                   rtol=1e-6)
        for k in ("a", "b", "c"):
            np.testing.assert_allclose(out[f"tree_{k}"],
                                       (ins[0][k] + ins[1][k]) / 2,
                                       rtol=1e-6)
        np.testing.assert_array_equal(out["tree_i"],
                                      (ins[0]["i"] + ins[1]["i"]) // 2)
        assert int(out["buckets"]) >= 2
    np.testing.assert_array_equal(ranks[0]["tree_a"], ranks[1]["tree_a"])


def test_two_ranks_broadcasts(two_ranks):
    """Parameters from the root (the last rank here), numbers as their
    type; the optimizer state (Adam's moments and its step) from rank 0."""
    ranks, _ = two_ranks
    for out in ranks:
        np.testing.assert_array_equal(out["bcast_w"], np.full(3, 1.0))
        assert out["bcast_n"].tolist() == [2]
        np.testing.assert_array_equal(out["adam_exp_avg"],
                                      ranks[0]["adam_exp_avg"])
        assert float(out["adam_step"]) == 1.0
