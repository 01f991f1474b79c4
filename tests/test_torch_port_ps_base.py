"""The base of the port's PS worker plane, without the C++ library: the
consistent-hash ring, the streaming fusion buffer and the row-batch plan,
the codec pool and the gradient-health monitor, and the server entry's
arguments, each against the JAX package's.

Nothing here builds or loads a native library: ``serve()`` runs with
``build.build`` and ``ctypes.CDLL`` replaced in both packages.
"""

import ctypes
import os
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from byteps_tpu.common import config as rconfig
from byteps_tpu.common import fusion as rfusion
from byteps_tpu.common import ring as rring
from byteps_tpu.server import codec_pool as rpool
from byteps_tpu_torch.common import config, fusion, ring
from byteps_tpu_torch.server import codec_pool as pool

from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# Ring
# ---------------------------------------------------------------------------
KEYS = [(k << 16) | (k % 4) for k in range(4000)]
MEMBERS = [(0, "h", 1), (1, "h", 2), (2, "h", 3)]


@pytest.mark.parametrize("vnodes", [64, 5])
def test_ring_owners_and_successors_match_the_reference(vnodes):
    for ids in ([0, 1], [0, 1, 2], [0, 2, 7], [3]):
        servers = [(i, "10.0.0.1", 9000 + i) for i in ids]
        mine = ring.RingTable(servers, vnodes)
        ref = rring.RingTable(servers, vnodes)
        assert ring.build_points(ids, vnodes) == rring.build_points(ids,
                                                                    vnodes)
        for k in KEYS[:1000] + [2**64 - 1, 0, 12345]:
            assert mine.owner(k) == ref.owner(k)
            if len(ids) > 1:
                assert mine.successor(k) == ref.successor(k) != mine.owner(k)
            else:
                with pytest.raises(ValueError, match="single member"):
                    mine.successor(k)
    for x in (0, 1, 2**63, 2**64 - 1):
        assert ring.splitmix64(x) == rring.splitmix64(x)
        assert ring.key_point(x) == rring.key_point(x)
    with pytest.raises(ValueError, match="no members"):
        ring.owner_of(1, [])


def test_ring_stability_on_add_and_remove():
    old = ring.RingTable(MEMBERS)
    new = old.with_server(3, "h", 4)
    ref_old = rring.RingTable(MEMBERS)
    ref_new = ref_old.with_server(3, "h", 4)
    frac = ring.moved_fraction(old, new, KEYS)
    assert frac == rring.moved_fraction(ref_old, ref_new, KEYS)
    assert 0.10 < frac < 0.45, frac
    assert (new.epoch, new.ids()) == (ref_new.epoch, ref_new.ids()) \
        == (1, [0, 1, 2, 3])
    for k in KEYS:
        if old.owner(k) != new.owner(k):
            assert new.owner(k) == 3
    back = new.without(3)
    assert back.epoch == 2
    for k in KEYS:
        if new.owner(k) != back.owner(k):
            assert new.owner(k) == 3
        else:
            assert back.owner(k) == new.owner(k)
    assert ring.moved_fraction(old, new, []) == 0.0


def test_ring_table_wire_and_json_roundtrip():
    servers = [(0, "10.0.0.1", 9001), (2, "10.0.0.3", 9003)]
    t = ring.RingTable(servers, vnodes=32, epoch=5)
    wire = t.to_wire()
    assert wire == rring.RingTable(servers, vnodes=32, epoch=5).to_wire()
    epoch, vnodes, n = struct.unpack("<QII", wire[:16])
    assert (epoch, vnodes, n) == (5, 32, 2)
    assert t.describe() == rring.RingTable(servers, 32, 5).describe()
    t2 = ring.RingTable.from_json(t.describe())
    assert t2.epoch == 5 and t2.vnodes == 32
    assert t2.ids() == t.ids()
    assert t2.owner(12345) == t.owner(12345)
    assert t.address(2) == ("10.0.0.3", 9003) and t.address(1) is None
    with pytest.raises(ValueError):
        ring.RingTable([(0, "h", 1)]).without(0)   # never empty the ring


def test_ring_knobs(monkeypatch):
    cfg = config.get_config(refresh=True)
    assert (cfg.ring, cfg.ring_vnodes) == (False, ring.DEFAULT_VNODES) \
        == (False, 64)
    monkeypatch.setenv("BYTEPS_TPU_RING", "1")
    monkeypatch.setenv("BYTEPS_TPU_RING_VNODES", "16")
    monkeypatch.setenv("BYTEPS_TPU_FUSION_FLUSH_MS", "2.5")
    monkeypatch.setenv("BYTEPS_SERVER_ENGINE_THREAD", "3")
    monkeypatch.setenv("BYTEPS_SERVER_ENABLE_SCHEDULE", "1")
    cfg = config.get_config(refresh=True)
    ref = rconfig.Config.from_env()
    for f in ("ring", "ring_vnodes", "fusion_flush_ms",
              "server_engine_threads", "server_enable_schedule"):
        assert getattr(cfg, f) == getattr(ref, f), f
    assert (cfg.ring, cfg.ring_vnodes, cfg.fusion_flush_ms) == (True, 16, 2.5)
    monkeypatch.undo()
    config.get_config(refresh=True)


# ---------------------------------------------------------------------------
# Streaming FusionBuffer (tests/test_fusion.py's cases, on torch tensors)
# ---------------------------------------------------------------------------
def _collecting(mod, **kw):
    got = []

    def dispatch(packed, members, priority):
        got.append((packed.clone() if torch.is_tensor(packed)
                    else np.asarray(packed).copy(), list(members), priority))

    return mod.FusionBuffer(dispatch, **kw), got


def test_buffer_full_flush_and_solo():
    buf, got = _collecting(fusion, fusion_bytes=1024, flush_ms=0)
    small = torch.ones(100)                          # 400 B
    buf.add("g0", small, priority=0)
    buf.add("g1", 2 * small, priority=1)
    assert got == []                                 # 800 B still open
    buf.add("g2", 3 * small, priority=2)             # would exceed 1 KiB
    assert len(got) == 1                             # g0+g1 flushed full
    packed, members, prio = got[0]
    assert [m[0] for m in members] == ["g0", "g1"] and prio == 1
    assert torch.equal(packed, torch.cat([small, 2 * small]))
    buf.add("big", torch.ones(1000), priority=7)     # 4000 B: solo
    assert len(got) == 2 and got[1][1][0][0] == "big"
    buf.close()                                      # drains g2
    assert len(got) == 3 and got[2][1][0][0] == "g2"


def test_buffer_deadline_flushes_stragglers():
    before = fusion.get_stats()["deadline_flushes"]
    buf, got = _collecting(fusion, fusion_bytes=1 << 20, flush_ms=50)
    buf.add("straggler", torch.ones(10), priority=3)
    deadline = time.time() + 5
    while not got and time.time() < deadline:
        time.sleep(0.01)
    assert got and got[0][1][0][0] == "straggler"
    assert fusion.get_stats()["deadline_flushes"] == before + 1
    buf.close()
    assert not buf._flusher.is_alive()


def test_buffer_meta_carries_original_shapes():
    buf, got = _collecting(fusion, fusion_bytes=1 << 20, flush_ms=0)
    buf.add("m", torch.ones(20, 30), priority=0)
    buf.add("v", torch.ones(8), priority=1)
    buf.close()
    (_, members, _) = got[0]
    assert members == [("m", (20, 30), 600), ("v", (8,), 8)]
    assert all(type(m[1]) is tuple for m in members)


def test_buffer_dispatch_not_under_lock():
    release = threading.Event()
    entered = threading.Event()

    def slow_dispatch(packed, members, priority):
        entered.set()
        assert release.wait(10), "dispatch never released"

    buf = fusion.FusionBuffer(slow_dispatch, fusion_bytes=1024, flush_ms=0)
    small = torch.ones(100)
    buf.add("a", small)
    buf.add("b", small)
    t = threading.Thread(target=buf.add, args=("c", small))  # trips flush
    t.start()
    try:
        assert entered.wait(5)
        done = threading.Event()
        t2 = threading.Thread(
            target=lambda: (buf.add("d", torch.ones(10)), done.set()))
        t2.start()
        assert done.wait(5), "add() blocked behind a slow dispatch"
    finally:
        release.set()
        t.join(timeout=10)
    t2.join(timeout=10)
    buf.close()
    with pytest.raises(RuntimeError, match="closed"):
        buf.add("e", small)


def test_buffer_keeps_dtypes_separate():
    buf, got = _collecting(fusion, fusion_bytes=1 << 20, flush_ms=0)
    buf.add("f", torch.ones(8), priority=0)
    buf.add("h", torch.ones(8, dtype=torch.float16), priority=1)
    buf.close()
    assert len(got) == 2
    assert {g[0].dtype for g in got} == {torch.float32, torch.float16}


def test_buffer_matches_the_reference_on_the_same_leaves():
    """Bucket composition, packed values, metadata, priorities and the
    stats' increments equal the reference's FusionBuffer on the same
    leaves (numpy there, torch here)."""
    rng = np.random.default_rng(0)
    shapes = [(7,), (3, 5), (64,), (300,), (2, 2, 2), (40,), (1,), (90,),
              (11, 13), (500,), (3,), (128,)]
    dtypes = [np.float32, np.float16]
    leaves = [(f"w{i}", rng.standard_normal(s).astype(dtypes[i % 5 == 4]),
               (i * 7) % 5) for i, s in enumerate(shapes)]
    before = (fusion.get_stats(), rfusion.get_stats())
    out = []
    for mod, conv in ((fusion, torch.from_numpy), (rfusion, lambda a: a)):
        buf, got = _collecting(mod, fusion_bytes=1200, flush_ms=0)
        for name, a, prio in leaves:
            buf.add(name, conv(a), priority=prio)
        buf.flush()
        buf.close()
        out.append(got)
    mine, ref = out
    assert len(mine) == len(ref) > 3
    for (p, m, pr), (rp, rm, rpr) in zip(mine, ref):
        np.testing.assert_array_equal(p.numpy(), rp)
        assert m == [(n, tuple(s), k) for n, s, k in rm] and pr == rpr
    after = (fusion.get_stats(), rfusion.get_stats())
    for key in ("buckets_built", "leaves_fused", "leaves_solo", "fused_bytes",
                "solo_bytes", "wire_messages_saved", "full_flushes",
                "drain_flushes", "deadline_flushes"):
        assert after[0][key] - before[0][key] == \
            after[1][key] - before[1][key], key
    assert set(fusion.ZERO_STATS) == set(rfusion.ZERO_STATS)


def test_buffer_concurrent_producers_lose_nothing():
    """Eight producer threads, a 1 ms deadline flusher and a short switch
    interval: every tensor is dispatched exactly once, with its values."""
    got, lock = [], threading.Lock()

    def dispatch(packed, members, priority):
        with lock:
            got.append((packed.clone(), list(members)))
    buf = fusion.FusionBuffer(dispatch, fusion_bytes=2048, flush_ms=1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def produce(t):
            for i in range(60):
                n = 1 + (7 * i + t) % 300
                buf.add(f"t{t}.{i}", torch.full((n,), float(t * 1000 + i)),
                        priority=i)
        ts = [threading.Thread(target=produce, args=(t,)) for t in range(8)]
        [t.start() for t in ts]
        [t.join(timeout=30) for t in ts]
        assert not any(t.is_alive() for t in ts)
        buf.close()
    finally:
        sys.setswitchinterval(interval)
    seen = {}
    for packed, members in got:
        off = 0
        for name, shape, n in members:
            assert name not in seen
            seen[name] = packed[off:off + n]
            off += n
        assert off == packed.numel()
    assert len(seen) == 8 * 60
    for name, vals in seen.items():
        t, i = map(int, name[1:].split("."))
        assert vals.numel() == 1 + (7 * i + t) % 300
        assert bool((vals == t * 1000 + i).all())


@pytest.mark.parametrize("nrows,width,cap", [
    (0, 8, 4096), (1, 8, 4096), (1000, 8, 4096), (999, 1024, 4096),
    (5, 4096, 1000), (77, 3, 33), (10, 1, 1)])
def test_plan_row_batches_matches_the_reference(nrows, width, cap):
    before = (fusion.get_stats(), rfusion.get_stats())
    got = fusion.plan_row_batches(nrows, width, cap)
    assert got == rfusion.plan_row_batches(nrows, width, cap)
    assert sum(b - a for a, b in got) == max(nrows, 0)
    after = (fusion.get_stats(), rfusion.get_stats())
    for key in ("row_batch_plans", "row_batches"):
        assert after[0][key] - before[0][key] == \
            after[1][key] - before[1][key]


# ---------------------------------------------------------------------------
# CompressionPool and HealthMonitor
# ---------------------------------------------------------------------------
def _start_order(mod, jobs, threads=1):
    """Start order of ``jobs`` ((priority, key) pairs) submitted to a pool
    whose threads are all held by gate jobs."""
    p = mod.CompressionPool(threads)
    gate, held = threading.Event(), threading.Semaphore(0)
    order, lock = [], threading.Lock()

    def gate_job():
        held.release()
        gate.wait(10)

    def job(pk):
        def run():
            with lock:
                order.append(pk)
        return run
    try:
        for _ in range(threads):
            p.submit(1 << 30, -1, gate_job)
        for _ in range(threads):
            assert held.acquire(timeout=10)
        for prio, key in jobs:
            p.submit(prio, key, job((prio, key)))
        assert p.stats()["pending"] == len(jobs)
        gate.set()
    finally:
        p.close()
    return order


def test_codec_pool_order_priority_desc_key_asc():
    rng = np.random.default_rng(1)
    jobs = [(int(rng.integers(-3, 3)), int(rng.integers(0, 50)))
            for _ in range(200)]
    want = sorted(jobs, key=lambda pk: (-pk[0], pk[1]))
    assert _start_order(pool, jobs) == want == _start_order(rpool, jobs)
    # With four threads, each job starts within three places of its turn.
    got = _start_order(pool, jobs, threads=4)
    assert sorted(got) == sorted(want)
    for i, pk in enumerate(got):
        assert abs(want.index(pk) - i) < 4 or want.count(pk) > 1


def test_codec_pool_resize_never_drops_staged_work():
    from byteps_tpu_torch.common import telemetry as tm
    tm.reset_registry()
    p = pool.CompressionPool(2)
    done = []
    lock = threading.Lock()
    total = 120

    def job(i):
        def run():
            time.sleep(0.002)
            with lock:
                done.append(i)
        return run

    try:
        for i in range(total // 3):
            p.submit(1, i, job(i))
        assert p.resize(6) == 6              # grow mid-backlog
        for i in range(total // 3, 2 * total // 3):
            p.submit(1, i, job(i))
        assert p.resize(1) == 1              # shrink mid-backlog
        for i in range(2 * total // 3, total):
            p.submit(1, i, job(i))
        deadline = time.time() + 30
        while time.time() < deadline:
            with lock:
                if len(done) == total:
                    break
            time.sleep(0.02)
        with lock:
            assert sorted(done) == list(range(total))   # nothing dropped
        assert p.stats()["threads"] == 1
        deadline = time.time() + 10
        while time.time() < deadline and len(
                [t for t in p._threads if t.is_alive()]) > 1:
            time.sleep(0.02)
        assert len([t for t in p._threads if t.is_alive()]) == 1
        assert p.resize(0) == 1              # clamps to one thread
    finally:
        p.close()
    assert p.resize(3) == 1                  # closed: unchanged
    with pytest.raises(RuntimeError, match="closed"):
        p.submit(0, 0, lambda: None)


def test_codec_pool_contains_a_leaking_job(capfd):
    p = pool.CompressionPool(1)
    ran = threading.Event()

    def leak():
        raise RuntimeError("codec blew up")
    try:
        p.submit(5, 0, leak)
        p.submit(0, 1, ran.set)
        assert ran.wait(10), "the pool's thread died with the job"
        assert [t for t in p._threads if t.is_alive()]
    finally:
        p.close()
    assert "codec pipeline job failed" in capfd.readouterr().err
    with pytest.raises(ValueError):
        pool.CompressionPool(0)


def test_codec_pool_record_and_stats_match_the_reference():
    from byteps_tpu_torch.common import telemetry as tm
    tm.reset_registry()
    stats = []
    for mod in (pool, rpool):
        p = mod.CompressionPool(2)
        try:
            for stage, us in (("ENCODE", 120), ("ENCODE", -5),
                              ("DECODE", 40), ("ENCODE", 7)):
                p.record(stage, us)
            stats.append(p.stats())
        finally:
            p.close()
    assert stats[0] == stats[1] == {
        "threads": 2, "pending": 0, "encoded_parts": 3, "decoded_parts": 1,
        "encode_busy_us": 127, "decode_busy_us": 40}
    assert pool.CompressionPool.ZERO_STATS == rpool.CompressionPool.ZERO_STATS
    h = tm.get_registry().histogram("bps_codec_encode_seconds")
    assert h.value()["count"] == 3


def _without_ts(snap):
    return {**snap, "keys": {k: {f: v for f, v in rec.items() if f != "ts"}
                             for k, rec in snap["keys"].items()}}


def test_health_monitor_snapshot_matches_the_reference():
    from byteps_tpu_torch.common import telemetry as tm
    tm.reset_registry()
    rng = np.random.default_rng(2)
    good = rng.standard_normal(1000).astype(np.float32)
    bad = good.copy()
    bad[::97] = np.nan
    bad[5] = np.inf

    class EF:
        def ef_residual_norm(self):
            return 0.25

    snaps = []
    for mod in (pool, rpool):
        mon = mod.HealthMonitor(2, context=lambda: {"worker": 1,
                                                    "ring_epoch": 0})
        p = mod.CompressionPool(1)
        try:
            assert mon.sample_push("w", good, 0, comp=EF())
            assert not mon.sample_push("w", good, 1)
            assert mon.sample_push("b", bad, 2, pool=p)
        finally:
            p.close()
        assert mon.pull_due(4) and not mon.pull_due(3)
        mon.check_pull("p.part0", 4, bad)
        mon.check_pull("q.part0", 3, bad)      # not a sampled round
        snaps.append(_without_ts(mon.snapshot()))
    assert snaps[0] == snaps[1]
    assert snaps[0]["nonfinite_total"] == 2
    assert snaps[0]["keys"]["w"]["ef_residual_norm"] == 0.25
    assert snaps[0]["keys"]["p"]["nonfinite"] == bad.size - np.isfinite(
        bad).sum()
    reg = tm.get_registry()
    assert reg.counter("bps_grad_nonfinite_total").value() == 2
    assert reg.gauge("bps_grad_norm", labels={"key": "w"}).value() == \
        pytest.approx(float(np.linalg.norm(good)), rel=1e-6)


# ---------------------------------------------------------------------------
# serve(): the arguments bps_ps_server_run receives
# ---------------------------------------------------------------------------
def _serve_args(monkeypatch, env, **kwargs):
    """The (library path, bps_ps_server_run args) each package's serve()
    produces under ``env``, with nothing built or loaded."""
    import byteps_tpu.core.build as rbuild
    import byteps_tpu.server as rserver
    import byteps_tpu_torch.core.build as pbuild
    import byteps_tpu_torch.server as pserver

    calls = []

    class Lib:
        def __init__(self, path):
            self.path = path
            self.bps_ps_server_run = self

        def __call__(self, *args):
            calls.append((self.path, args))
            return 0

    out = []
    with monkeypatch.context() as m:
        for k in ("BYTEPS_TPU_TSAN", "BYTEPS_TPU_ASAN"):
            m.delenv(k, raising=False)
        for k, v in env.items():
            m.setenv(k, v)
        m.setattr(ctypes, "CDLL", Lib)
        m.setattr(rbuild, "build", lambda *a, **k: "reference.so")
        m.setattr(pbuild, "build", lambda *a, **k: "port.so")
        for server in (pserver, rserver):
            calls.clear()
            assert server.serve(**kwargs) == 0
            assert len(calls) == 1
            out.append(calls[0])
    config.get_config(refresh=True)
    rconfig.get_config(refresh=True)
    return out


def test_serve_passes_the_reference_arguments(monkeypatch):
    env = {"DMLC_PS_ROOT_PORT": "12000", "DMLC_NUM_WORKER": "3",
           "DMLC_SERVER_ID": "2", "BYTEPS_SERVER_ENGINE_THREAD": "6",
           "BYTEPS_SERVER_ENABLE_SCHEDULE": "1", "BYTEPS_ENABLE_ASYNC": "1"}
    (mine_lib, mine), (ref_lib, ref) = _serve_args(monkeypatch, env)
    assert (mine_lib, ref_lib) == ("port.so", "reference.so")
    assert mine == ref == (12003, 3, 6, 1, 1)
    (_, mine), (_, ref) = _serve_args(
        monkeypatch, {"DMLC_PS_ROOT_PORT": "9100"}, port=5555,
        num_workers=2, engine_threads=1, schedule=False, async_mode=False)
    assert mine == ref == (5555, 2, 1, 0, 0)
    (_, mine), (_, ref) = _serve_args(monkeypatch, {})
    assert mine == ref


def test_serve_execs_the_sanitized_binary(monkeypatch):
    import os
    import byteps_tpu_torch.core.build as pbuild
    import byteps_tpu_torch.server as pserver

    class Exec(Exception):
        pass

    def execv(exe, argv):
        raise Exec(exe, argv)
    monkeypatch.setenv("BYTEPS_TPU_TSAN", "1")
    monkeypatch.setenv("DMLC_PS_ROOT_PORT", "9200")
    monkeypatch.setattr(os, "execv", execv)
    monkeypatch.setattr(pbuild, "build_server_exe", lambda: "srv_tsan")
    assert pbuild.sanitized()
    assert pbuild.exe_path().endswith("_tsan")
    assert pbuild.lib_path() != pbuild.exe_path()
    with pytest.raises(Exec) as e:
        pserver.serve(num_workers=1)
    assert e.value.args == ("srv_tsan", ["srv_tsan", "9201", "1", "4", "0",
                                         "0"])
    monkeypatch.undo()
    config.get_config(refresh=True)


_FAKE_BUILD = """
import os, subprocess, sys, time
from byteps_tpu_torch.core import build
build.BUILD_DIR = sys.argv[1]

def fake_run(cmd, **kw):
    with open(os.path.join(build.BUILD_DIR, "compiles"), "a") as f:
        f.write(f"{os.getpid()}\\n")
    time.sleep(0.5)                      # a slow compile, then its output
    with open(cmd[cmd.index("-o") + 1], "wb") as f:
        f.write(b"library")
    return subprocess.CompletedProcess(cmd, 0, "", "")
subprocess.run = fake_run
print(build.build())
"""


def test_build_compiles_once_across_processes(tmp_path):
    """Four processes building at once (a parallel test run) compile once
    under the file lock, and every one gets the finished library; g++ is
    replaced by a fake that takes half a second."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", _FAKE_BUILD,
                               str(tmp_path)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    paths = {o.strip().splitlines()[-1] for o, _ in outs}
    assert len(paths) == 1
    path = paths.pop()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path).startswith("libbyteps_core_")
    assert len((tmp_path / "compiles").read_text().split()) == 1
    with open(path, "rb") as f:
        assert f.read() == b"library"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    from byteps_tpu_torch.core import build

    def failing(cmd, **kw):
        return subprocess.CompletedProcess(cmd, 1, "", "server.cc: error: no")
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build.subprocess, "run", failing)
    with pytest.raises(RuntimeError, match="server.cc: error: no"):
        build.build()
    assert not os.path.exists(build.lib_path())
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
