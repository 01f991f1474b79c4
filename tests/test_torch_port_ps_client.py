"""The port's PS client (``byteps_tpu_torch/server/client.py``) against the
JAX package's, on the port's server.

  - Wire: the reference session and the port's run one sequence through a
    recording proxy, and send the same client->server frames, request ids
    left out, in the order the protocol fixes.
  - Interop: a reference worker and a port worker sum through one server.
  - Behaviour: the reference's own tests of the client (tests/
    test_ps_server.py, test_transport_fault.py, test_elastic.py,
    test_server_elastic.py), held to the same assertions, on the port's
    client.
"""

import logging
import os
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from byteps_tpu_torch.common.logging import get_logger
from byteps_tpu_torch.server.client import PSSession

from torch_port_ps import (  # noqa: F401  (fixtures)
    RecordingProxy, port_server, reference_client)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from chaos_proxy import ChaosProxy  # noqa: E402

HELLO, INIT, PUSH = 0, 1, 2


# ---------------------------------------------------------------------------
# Wire: byte-identical client->server frames
# ---------------------------------------------------------------------------
def _wire_sequence(cls, ports):
    """Three keys (one partitioned over both servers, one onebit), two
    rounds, one lane a server."""
    s = cls(["127.0.0.1"] * 2, ports, worker_id=0, num_servers=2,
            partition_bytes=4096, wire_conns=1, min_compress_bytes=0,
            compress_threads=0)
    s.register_compressor(3, {"compressor": "onebit", "ef": "vanilla"})
    plan = s._plan(2, 6 * 4096)
    assert len({srv for (_, _, _, srv) in plan}) == 2
    rng = np.random.RandomState(7)
    outs = []
    for _ in range(2):
        items = [(1, rng.randn(256).astype(np.float32), 0),
                 (2, rng.randn(6 * 1024).astype(np.float32), 5),
                 (3, rng.randn(2048).astype(np.float32), 10)]
        outs.append([h.wait(30) for h in s.push_pull_group(items)])
    s.close()
    return outs


def _push_order_ok(frames):
    """Each round's pushes leave in (priority desc, key asc) order."""
    prio = {1: 0, 2: 5, 3: 10}
    pushes = [(fl, key) for cmd, _, fl, _, key, _ in frames if cmd == PUSH]
    for rnd in {fl & 0x7FFF for fl, _ in pushes}:
        keys = [k for fl, k in pushes if fl & 0x7FFF == rnd]
        assert keys == sorted(keys, key=lambda k: (-prio[k >> 16], k)), \
            keys


def test_client_frames_match_reference(port_server, reference_client):
    recs = {}
    outs = {}
    ports = port_server.many(4)
    for side, cls in (("reference", reference_client.PSSession),
                      ("port", PSSession)):
        proxies = [RecordingProxy(ports.pop()) for _ in range(2)]
        try:
            outs[side] = _wire_sequence(cls, [p.port for p in proxies])
            time.sleep(0.2)            # the last bytes through the pumps
            recs[side] = [p.frames() for p in proxies]
        finally:
            for p in proxies:
                p.close()
    for r_out, p_out in zip(outs["reference"], outs["port"]):
        for a, b in zip(r_out, p_out):
            np.testing.assert_array_equal(a, b)
    for srv in range(2):
        ref = [f for conn in recs["reference"][srv] for f in conn]
        got = [f for conn in recs["port"][srv] for f in conn]
        assert sorted(got) == sorted(ref), f"server {srv}"
        assert any(f[0] == PUSH for f in got)
        for conns in (recs["reference"][srv], recs["port"][srv]):
            for conn in conns:
                assert conn and conn[0][0] == HELLO
                _push_order_ok(conn)
                for key in {f[4] for f in conn if f[0] == PUSH}:
                    kinds = [f[0] for f in conn if f[4] == key
                             and f[0] in (INIT, PUSH)]
                    assert kinds[0] == INIT, key


# ---------------------------------------------------------------------------
# Interop: a reference worker and a port worker through one server
# ---------------------------------------------------------------------------
def test_reference_and_port_workers_sum_exactly(port_server,
                                                reference_client):
    port = port_server(num_workers=2)
    rng = np.random.RandomState(11)
    data = {w: [[rng.randn(n).astype(np.float32) for n in (300, 5000, 4096)]
                for _ in range(3)] for w in (0, 1)}
    got = {}

    def worker(wid, cls):
        s = cls(["127.0.0.1"], [port], worker_id=wid, num_servers=1,
                partition_bytes=8192, min_compress_bytes=0)
        s.register_compressor(12, {"compressor": "onebit"})
        got[wid] = [[h.wait(60) for h in s.push_pull_group(
            [(10 + k, x, k) for k, x in enumerate(rnd)])]
            for rnd in data[wid]]
        s.close()

    ts = [threading.Thread(target=worker,
                           args=(0, reference_client.PSSession)),
          threading.Thread(target=worker, args=(1, PSSession))]
    [t.start() for t in ts]
    [t.join(120) for t in ts]
    for r in range(3):
        for k in range(2):
            want = data[0][r][k] + data[1][r][k]
            np.testing.assert_array_equal(got[0][r][k], want)
            np.testing.assert_array_equal(got[1][r][k], want)
        np.testing.assert_array_equal(got[0][r][2], got[1][r][2])
        assert not np.array_equal(got[0][r][2],
                                  data[0][r][2] + data[1][r][2])


# ---------------------------------------------------------------------------
# Behaviour: the reference's tests of its client, on the port's
# ---------------------------------------------------------------------------
class _LogCapture(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.records = []

    def emit(self, record):
        self.records.append(record)

    def text(self) -> str:
        return "\n".join(r.getMessage() for r in self.records)


@contextmanager
def capture_logs(level=logging.DEBUG):
    lg = get_logger()
    h = _LogCapture()
    old_level = lg.level
    lg.addHandler(h)
    lg.setLevel(level)
    try:
        yield h
    finally:
        lg.removeHandler(h)
        lg.setLevel(old_level)


def _session(port, wid=0, **kw):
    return PSSession(["127.0.0.1"], [port], worker_id=wid, num_servers=1,
                     **kw)


def _run_threads(*targets, timeout=120):
    ts = [threading.Thread(target=t) for t in targets]
    [t.start() for t in ts]
    [t.join(timeout=timeout) for t in ts]
    assert not any(t.is_alive() for t in ts)


def push_pull_sums_across_workers(start):
    port = start(num_workers=2)
    a = np.arange(100, dtype=np.float32)
    b = 10 * np.arange(100, dtype=np.float32)
    out = {}

    def worker(wid, data):
        s = _session(port, wid)
        out[wid] = s.push_pull(7, data)
        s.close()

    _run_threads(lambda: worker(0, a), lambda: worker(1, b), timeout=60)
    np.testing.assert_allclose(out[0], a + b)
    np.testing.assert_allclose(out[1], a + b)


def large_tensor_partitioned_across_servers(start):
    port_a, port_b = start.many(2, num_workers=2)
    n = (17 * 1024 * 1024) // 4  # 17MB of f32
    rng = np.random.RandomState(0)
    a = rng.randn(n).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    out = {}

    def worker(wid, data):
        s = PSSession(["127.0.0.1"] * 2, [port_a, port_b], worker_id=wid,
                      num_servers=2)
        plan = s._plan(11, data.nbytes)
        assert len(plan) >= 5
        assert len({srv for (_, _, _, srv) in plan}) >= 2
        keys = [pkey for (pkey, _, _, _) in plan]
        assert len(set(keys)) == len(keys)
        assert all(k >> 16 == 11 for k in keys)
        out[wid] = s.push_pull(11, data)
        s.close()

    _run_threads(lambda: worker(0, a), lambda: worker(1, b))
    expect = a + b
    np.testing.assert_array_equal(out[0], expect)
    np.testing.assert_array_equal(out[1], expect)


def wire_conns_spread_partitions_over_lanes(start):
    port = start(num_workers=1)
    for hash_fn in ("naive", "djb2"):
        s = _session(port, hash_fn=hash_fn, partition_bytes=65536,
                     wire_conns=2)
        data = np.arange(8 * 65536 // 4, dtype=np.float32)
        plan = s._plan(3, data.nbytes)
        assert len(plan) == 8
        assert all(srv == 0 for (_, _, _, srv) in plan)
        for _ in range(3):
            np.testing.assert_array_equal(s.push_pull(3, data), data)
        lanes = s.transport_stats()["lanes"]
        assert len(lanes) == 2
        assert all(l["sends"] > 0 for l in lanes), lanes
        assert all(l["outstanding_bytes"] == 0 for l in lanes), lanes
        s.close()


def priority_scheduling_with_credit(start):
    port = start(num_workers=1)
    s = _session(port, partition_bytes=1024, scheduling_credit=1)
    s.record_push_order = True
    s.pause_dispatch()
    a = np.ones(1024, np.float32)   # 4096 bytes -> 4 partitions
    b = np.ones(512, np.float32)    # 2048 bytes -> 2 partitions
    ha = s.push_pull_async(1, a, priority=0)   # low, enqueued first
    hb = s.push_pull_async(2, b, priority=10)  # high, enqueued second
    s.resume_dispatch()
    np.testing.assert_array_equal(ha.wait(), a)
    np.testing.assert_array_equal(hb.wait(), b)
    expect_b = [(2 << 16) | i for i in range(2)]
    expect_a = [(1 << 16) | i for i in range(4)]
    assert list(s.push_order) == expect_b + expect_a
    s.close()


def barrier(start):
    port = start(num_workers=2)
    order = []

    def worker(wid, delay):
        s = _session(port, wid)
        time.sleep(delay)
        order.append(("before", wid, time.monotonic()))
        s.barrier()
        order.append(("after", wid, time.monotonic()))
        s.close()

    _run_threads(lambda: worker(0, 0.0), lambda: worker(1, 0.5), timeout=60)
    afters = [t for tag, _, t in order if tag == "after"]
    befores = [t for tag, _, t in order if tag == "before"]
    assert len(afters) == 2
    assert max(befores) <= min(afters) + 1e-3  # nobody crossed early


def reconnect_compressed_bit_identical_to_uninterrupted(start):
    port_a, port_b = start.many(2)
    n = 16 * 1024
    rng = np.random.RandomState(3)
    rounds = [rng.randn(n).astype(np.float32) for _ in range(4)]

    def run(port, fault_proxy=None):
        s = _session(port, reconnect_attempts=8, reconnect_backoff_ms=20.0,
                     wire_conns=1, min_compress_bytes=0)
        s.register_compressor(5, {"compressor": "onebit"})
        outs = []
        for i, g in enumerate(rounds):
            if fault_proxy is not None and i == 2:
                fault_proxy.reset_after(1024)    # mid-blob, one-shot
            outs.append(np.asarray(s.push_pull(5, g)))
        st = s.transport_stats()
        s.close()
        return outs, st

    ref, _ = run(port_a)
    with ChaosProxy("127.0.0.1", port_b) as proxy:
        got, st = run(proxy.port, fault_proxy=proxy)
        assert st["reconnects"] >= 1, st
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(r, g, err_msg=f"round {i}")


def two_workers_midround_reset_no_double_count(start):
    port = start(num_workers=2)
    n = 64 * 1024
    a = np.full(n, 3.0, np.float32)
    b = np.full(n, 5.0, np.float32)
    with ChaosProxy("127.0.0.1", port) as proxy:
        s0 = _session(proxy.port, 0, reconnect_attempts=8,
                      reconnect_backoff_ms=20.0, wire_conns=1)
        s1 = _session(port, 1, wire_conns=1)
        h0 = s0.push_pull_async(7, a)
        time.sleep(0.5)          # worker 0's push reaches the server
        proxy.kill_connections()
        time.sleep(0.2)
        out1 = {}
        t1 = threading.Thread(
            target=lambda: out1.update(r=s1.push_pull(7, b)))
        t1.start()
        got0 = h0.wait(timeout=120.0)
        t1.join(timeout=120)
        np.testing.assert_array_equal(got0, a + b)
        np.testing.assert_array_equal(out1["r"], a + b)
        s0.close()
        s1.close()


def watchdog_dumps_and_fails_blackholed_partition(start):
    port = start()
    with ChaosProxy("127.0.0.1", port) as proxy:
        s = _session(proxy.port, stall_timeout_s=1.5, wire_conns=1)
        x = np.ones(1024, np.float32)
        np.testing.assert_array_equal(s.push_pull(6, x), x)  # key inited
        proxy.blackhole(True)
        with capture_logs() as logs:
            t0 = time.monotonic()
            h = s.push_pull_async(6, x)
            with pytest.raises(RuntimeError, match="stalled"):
                h.wait(timeout=30.0)
            elapsed = time.monotonic() - t0
        assert elapsed < 15.0, f"watchdog too slow: {elapsed:.1f}s"
        dump = logs.text()
        assert "PS STALL" in dump
        assert f"key={6 << 16}" in dump
        assert s.transport_stats()["watchdog_trips"] == 1
        proxy.pass_through()
        s.close()


def graceful_leave_refinalizes_next_round(start):
    port = start(num_workers=2)
    s0 = _session(port, 0, wire_conns=1)
    s1 = _session(port, 1, wire_conns=1)
    try:
        a = np.arange(16, dtype=np.float32)
        h0 = s0.push_pull_async(1, a)
        h1 = s1.push_pull_async(1, a * 10)
        np.testing.assert_array_equal(h0.wait(20), a + a * 10)
        np.testing.assert_array_equal(h1.wait(20), a + a * 10)
        s1.leave()
        m = s0.membership()
        assert m["epoch"] == 1
        assert m["alive"] == [0]
        t0 = time.monotonic()
        got = s0.push_pull_async(1, a).wait(20)     # solo round publishes
        assert time.monotonic() - t0 < 10
        np.testing.assert_array_equal(got, a)
    finally:
        s0.close()
        s1.close()


def drain_handoff_exactness(start):
    ports = start.group(3, num_workers=2, extra_env={"BYTEPS_TPU_RING": 1})

    def ring_session(wid):
        return PSSession(["127.0.0.1"] * 3, ports, worker_id=wid,
                         num_servers=3, ring=True, wire_conns=1,
                         partition_bytes=1 << 16)

    s0, s1 = ring_session(0), ring_session(1)
    try:
        keys = list(range(1, 13))
        x = np.arange(1 << 12, dtype=np.float32)

        def round_all(mult):
            h0 = [s0.push_pull_async(k, x * mult) for k in keys]
            h1 = [s1.push_pull_async(k, x * (10 * mult)) for k in keys]
            want = x * mult + x * (10 * mult)
            for h in h0 + h1:
                np.testing.assert_array_equal(h.wait(30), want)

        round_all(1.0)
        round_all(2.0)
        by_slot: dict = {}
        for slot in s0._pkey_srv.values():
            by_slot[slot] = by_slot.get(slot, 0) + 1
        target = max(by_slot, key=by_slot.get)
        assert by_slot[target] > 0
        h0 = [s0.push_pull_async(k, x * 3) for k in keys]
        time.sleep(0.4)
        doc = s0.drain_server(target)
        assert doc["keys_owned"] == 0
        assert doc["draining"] == 1
        h1 = [s1.push_pull_async(k, x * 30) for k in keys]
        want = x * 3 + x * 30
        for h in h0 + h1:
            np.testing.assert_array_equal(h.wait(30), want)
        round_all(4.0)
        st = s0.server_stats()
        assert st["ring_epoch"] >= 1
        assert st["servers"][target]["keys_owned"] == 0
        assert st["servers"][target]["draining"] is True
        survivors = [sid for sid in st["servers"] if sid != target]
        assert sum(st["servers"][sid]["migrations_in"]
                   for sid in survivors) > 0
        assert target not in set(s0._pkey_srv.values())
    finally:
        s0.close()
        s1.close()


CASES = {f.__name__: f for f in (
    push_pull_sums_across_workers,
    large_tensor_partitioned_across_servers,
    wire_conns_spread_partitions_over_lanes,
    priority_scheduling_with_credit,
    barrier,
    reconnect_compressed_bit_identical_to_uninterrupted,
    two_workers_midround_reset_no_double_count,
    watchdog_dumps_and_fails_blackholed_partition,
    graceful_leave_refinalizes_next_round,
    drain_handoff_exactness)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_client_behaves_as_the_reference(port_server, case):
    CASES[case](port_server)
