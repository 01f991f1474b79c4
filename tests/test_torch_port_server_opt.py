"""The port's server-resident optimizer (``byteps_tpu_torch/parallel/
server_opt.py``) against the JAX package's, on the port's server.

The law: with fixed membership the server mode (the owner runs the step
on the merged sum, workers pull parameters) and the local mode (workers
pull the sum and run the step themselves) give bit-equal float32
parameters round by round.  Here the port's local mode (float32 torch ops
in the server's order) is held bit-equal to the port's server mode and to
the JAX package's local mode (optax under ``jax.disable_jit()``), for SGD,
momentum and Adam, including ``grad_scale`` != 1 and two workers with a
raw -> onebit codec switch mid-run.  Also the reference's other cases
(tests/test_server_opt.py): exactly one update under replay, slots that
migrate byte-equal across a drain, the SIGKILL failover's re-seed, no
CMD_OPT frame in local mode, the signal window's ``opt_keys`` slice.
"""

import os
import socket
import struct
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from byteps_tpu.parallel import server_opt as rso
from byteps_tpu_torch.parallel import server_opt as pso
from byteps_tpu_torch.server.client import (CMD_HELLO, CMD_INIT, CMD_OPT,
                                            CMD_PULL, CMD_PUSH, PSSession)

from testutil import StubPSServer
from torch_port_ps import port_server, reference_client  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from chaos_proxy import ChaosProxy  # noqa: E402


def _tensors(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _flatcat(p):
    return np.concatenate([np.asarray(p[k]).ravel() for k in sorted(p)])


def _session(cls, port, wid=0, **kw):
    return cls(["127.0.0.1"], [port], worker_id=wid, num_servers=1, **kw)


@pytest.mark.parametrize("kwargs,scale", [
    ({}, 1.0), ({"opt": "sgd", "lr": 0.05}, 1.0),
    ({"opt": "momentum", "lr": 1, "mu": 0.5}, 0.25),
    ({"opt": "adam"}, 0.5), ({"opt": "adam", "lr": 1e-4, "eps": 1e-6}, 1),
    ({"opt": "adagrad"}, 1.0), ({"opt": "sgd", "mu": 0.9}, 1.0)])
def test_canonical_opt_kwargs_equal_reference(kwargs, scale):
    try:
        want = rso._canonical_opt_kwargs(kwargs, scale)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pso._canonical_opt_kwargs(kwargs, scale)
        assert str(got.value) == str(e)
        return
    assert pso._canonical_opt_kwargs(kwargs, scale) == want


def test_int_pow_f32_is_float32_square_and_multiply():
    for x in (0.9, 0.999, 0.5):
        acc = np.float32(1.0)
        for y in range(40):
            got = pso.int_pow_f32(x, y)
            assert got.dtype == np.float32
            if y:
                acc = np.float32(acc * np.float32(x))
            # Exactly a power of two has no rounding either way.
            if x == 0.5:
                assert got == acc
            assert abs(float(got) - float(x) ** y) <= 1e-6 * y + 1e-7


# ---------------------------------------------------------------------------
# The law, one worker: SGD and momentum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kw", [{"opt": "sgd", "lr": 0.05},
                                {"opt": "momentum", "lr": 0.01, "mu": 0.9}],
                         ids=["sgd", "momentum"])
def test_sgd_and_momentum_equal_local_and_optax(kw, port_server,
                                                reference_client):
    rng = np.random.RandomState(0)
    params0 = {"w": rng.randn(257, 9).astype(np.float32),
               "b": rng.randn(33).astype(np.float32)}
    grads = [{"w": rng.randn(257, 9).astype(np.float32) * 3,
              "b": rng.randn(33).astype(np.float32) * 3}
             for _ in range(6)]
    trajs = {}
    for side, mode in (("port", "server"), ("port", "local"),
                       ("ref", "local")):
        cls = PSSession if side == "port" else reference_client.PSSession
        s = _session(cls, port_server())
        try:
            if side == "port":
                tr = pso.ServerOptTrainer(s, _tensors(params0), kw,
                                          mode=mode, declared_key=31)
                trajs[side, mode] = [_flatcat(tr.step(_tensors(g), 60.0))
                                     for g in grads]
                assert tr.opt_state_bytes() == (
                    0 if mode == "server" or kw["opt"] == "sgd"
                    else 4 * (257 * 9 + 33))
                if mode == "server":
                    docs = tr.server_docs()
                    assert docs and all(
                        d["param_version"] == d["opt_step"] == len(grads)
                        for d in docs.values())
            else:
                tr = rso.ServerOptTrainer(s, params0, kw, mode=mode,
                                          declared_key=31)
                with jax.disable_jit():
                    trajs[side, mode] = [_flatcat(tr.step(g, timeout=60.0))
                                         for g in grads]
        finally:
            s.close()
    for r in range(len(grads)):
        a = trajs["port", "server"][r]
        np.testing.assert_array_equal(a, trajs["port", "local"][r],
                                      err_msg=f"local round {r}")
        np.testing.assert_array_equal(a, trajs["ref", "local"][r],
                                      err_msg=f"optax round {r}")


# ---------------------------------------------------------------------------
# The law, two workers: Adam, grad_scale 1/2, a codec switch at round 4
# ---------------------------------------------------------------------------
def _both_step(tr0, tr1, g0, g1):
    out, err = [None, None], []

    def run1():
        try:
            # disable_jit is thread-local: worker 1's optax runs eagerly too.
            with jax.disable_jit():
                out[1] = tr1.step(g1, timeout=60.0)
        except Exception as e:
            err.append(e)

    t = threading.Thread(target=run1)
    t.start()
    out[0] = tr0.step(g0, timeout=60.0)
    t.join(60)
    assert not t.is_alive()
    if err:
        raise err[0]
    return out


def test_adam_two_workers_codec_switch_equivalence(port_server,
                                                   reference_client):
    n = 1 << 14                    # 64 KiB >= the compress floor
    rng = np.random.RandomState(1)
    params0 = {"w": rng.randn(n - 16).astype(np.float32),
               "b": rng.randn(16).astype(np.float32)}
    gs = [[{"w": rng.randn(n - 16).astype(np.float32),
            "b": rng.randn(16).astype(np.float32)} for _ in range(8)]
          for _ in range(2)]
    kw = {"opt": "adam", "lr": 1e-3}

    def run(side, mode, dk):
        port = port_server(num_workers=2)
        cls = PSSession if side == "port" else reference_client.PSSession
        ss = [_session(cls, port, w) for w in range(2)]
        try:
            if side == "port":
                trs = [pso.ServerOptTrainer(s, _tensors(params0), kw,
                                            mode=mode, declared_key=dk,
                                            grad_scale=0.5) for s in ss]
                conv = _tensors
            else:
                trs = [rso.ServerOptTrainer(s, params0, kw, mode=mode,
                                            declared_key=dk, grad_scale=0.5)
                       for s in ss]
                conv = dict
            traj = []
            with jax.disable_jit():
                for r in range(8):
                    if r == 3:
                        res = ss[0].propose_codec(
                            dk, {"compressor": "onebit", "ef": "vanilla"},
                            effective_round=4)
                        assert res["accepted"]
                    p0, p1 = _both_step(*trs, conv(gs[0][r]),
                                        conv(gs[1][r]))
                    a, b = _flatcat(p0), _flatcat(p1)
                    np.testing.assert_array_equal(
                        a, b, err_msg=f"{side} {mode} round {r} w0 vs w1")
                    traj.append(a)
            stale = ss[1].transport_stats()["codec_stale_retries"]
            docs = trs[0].server_docs() if mode == "server" else {}
            return traj, stale, docs
        finally:
            for s in ss:
                s.close()

    srv, srv_stale, docs = run("port", "server", 61)
    loc, loc_stale, _ = run("port", "local", 62)
    ref, _, _ = run("ref", "local", 63)
    for r in range(8):
        np.testing.assert_array_equal(srv[r], loc[r], err_msg=f"round {r}")
        np.testing.assert_array_equal(srv[r], ref[r], err_msg=f"round {r}")
    assert srv_stale >= 1 and loc_stale >= 1
    assert docs and all(d["param_version"] == 8 and d["opt_mode"] == 3
                        for d in docs.values())


# ---------------------------------------------------------------------------
# Replay never double-steps
# ---------------------------------------------------------------------------
def test_replay_never_double_steps(port_server):
    rng = np.random.RandomState(5)
    params0 = {"w": rng.randn(1 << 12).astype(np.float32)}
    grads = [{"w": rng.randn(1 << 12).astype(np.float32)}
             for _ in range(7)]
    kw = {"opt": "adam", "lr": 1e-3}

    def run(port, dk, proxy=None):
        s = _session(PSSession, port, wire_conns=1, reconnect_attempts=8,
                     reconnect_backoff_ms=20.0)
        try:
            tr = pso.ServerOptTrainer(s, _tensors(params0), kw,
                                      mode="server", declared_key=dk)
            outs = []
            for i, g in enumerate(grads):
                if proxy is not None and i == 3:
                    proxy.reset_after(1024)      # mid-blob, one-shot
                outs.append(_flatcat(tr.step(_tensors(g), timeout=60.0)))
            return outs, tr.server_docs(), s.transport_stats()
        finally:
            s.close()

    ref, _, _ = run(port_server(), 71)
    with ChaosProxy("127.0.0.1", port_server()) as proxy:
        got, docs, st = run(proxy.port, 72, proxy=proxy)
        assert st["reconnects"] >= 1, st
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(r, g, err_msg=f"round {i}")
    assert docs and all(d["param_version"] == d["opt_step"] == len(grads)
                        for d in docs.values())


# ---------------------------------------------------------------------------
# Drain and SIGKILL failover on a two-server ring
# ---------------------------------------------------------------------------
def _ring_session(ports, wid=0, srv_evict=0.0, **kw):
    kw.setdefault("wire_conns", 1)
    kw.setdefault("partition_bytes", 1 << 16)
    return PSSession(["127.0.0.1"] * len(ports), list(ports),
                     worker_id=wid, num_servers=len(ports), ring=True,
                     server_evict_timeout_s=srv_evict, **kw)


def test_drain_migrates_optimizer_slots_byte_equal(port_server):
    rng = np.random.RandomState(7)
    nel = 6 * (1 << 14)            # 384 KiB -> 6 partitions at 64 KiB
    params0 = {"w": rng.randn(nel).astype(np.float32)}
    grads = [{"w": rng.randn(nel).astype(np.float32)} for _ in range(10)]
    kw = {"opt": "adam", "lr": 1e-3}

    def run(ports, dk, drain_at=None):
        s = _ring_session(ports)
        try:
            tr = pso.ServerOptTrainer(s, _tensors(params0), kw,
                                      mode="server", declared_key=dk)
            traj, pre, post = [], None, None
            for i, g in enumerate(grads):
                if drain_at is not None and i == drain_at:
                    by_slot = {}
                    for pk in s._opt_pkeys(dk):
                        slot = s._pkey_srv.get(pk, 0)
                        by_slot[slot] = by_slot.get(slot, 0) + 1
                    # Server 0 holds the startup barrier: drain another.
                    target = max((sl for sl in by_slot if sl != 0),
                                 key=lambda sl: by_slot[sl], default=None)
                    assert target is not None and by_slot[target] > 0
                    pre = s.fetch_opt_docs(dk)
                    assert s.drain_server(target)["keys_owned"] == 0
                    post = s.fetch_opt_docs(dk)
                traj.append(tr.step(_tensors(g), timeout=60.0)["w"].numpy())
            return traj, pre, post
        finally:
            s.close()

    ring = {"BYTEPS_TPU_RING": 1}
    ref, _, _ = run(port_server.group(2, extra_env=ring), 81)
    got, pre, post = run(port_server.group(2, extra_env=ring), 81,
                         drain_at=4)
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_array_equal(r, g, err_msg=f"round {i}")
    assert pre and post and set(pre) == set(post)
    for pk in pre:
        for field in ("param_version", "opt_step", "slots_crc", "kwargs"):
            assert post[pk][field] == pre[pk][field], (pk, field)


def _kill_listener(port: int) -> None:
    """SIGKILL the process listening on 127.0.0.1:``port``."""
    import glob
    import signal
    hexp = "%04X" % port
    inode = None
    with open("/proc/net/tcp") as f:
        for line in f:
            fl = line.split()
            if len(fl) > 9 and fl[1].endswith(":" + hexp) and fl[3] == "0A":
                inode = fl[9]
    pid = None
    for fd in glob.glob("/proc/[0-9]*/fd/*"):
        try:
            if os.readlink(fd) == f"socket:[{inode}]":
                pid = int(fd.split("/")[2])
                break
        except OSError:
            pass
    assert inode and pid, f"no listener found on port {port}"
    os.kill(pid, signal.SIGKILL)
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.3).close()
            time.sleep(0.1)
        except OSError:
            return


def test_sigkill_failover_reseeds_params(port_server):
    lr = 0.05
    rng = np.random.RandomState(9)
    nel = 8 * (1 << 14)
    params0 = {"w": rng.randn(nel).astype(np.float32)}
    grads = [{"w": rng.randn(nel).astype(np.float32)} for _ in range(8)]
    ports = port_server.group(2, extra_env={"BYTEPS_TPU_RING": 1})
    s = _ring_session(ports, srv_evict=0.8)
    try:
        tr = pso.ServerOptTrainer(s, _tensors(params0),
                                  {"opt": "sgd", "lr": lr}, mode="server",
                                  declared_key=91)
        assert [pk for pk, srv in s._pkey_srv.items()
                if pk >> 16 == 91 and srv == 1], "nothing on server 1"
        traj = []
        for i, g in enumerate(grads):
            if i == 3:
                _kill_listener(ports[1])
            traj.append(tr.step(_tensors(g), timeout=120.0)["w"].numpy())
        st = s.transport_stats()
        assert st["server_failovers"] >= 1 and st["opt_reseeds"] >= 1
        assert tr.server_docs()
    finally:
        s.close()
    p = params0["w"].copy()
    nlr = np.float32(-1.0 * lr)
    for i, g in enumerate(grads):
        p = p + nlr * g["w"]
        np.testing.assert_array_equal(traj[i], p, err_msg=f"round {i}")


# ---------------------------------------------------------------------------
# Local mode: no CMD_OPT frame, the plain push_pull loop's wire
# ---------------------------------------------------------------------------
def _stub_roundtrip(use_trainer):
    store = {}

    def handler(cmd, dt, fl, req_id, wid, key, payload):
        if cmd == CMD_HELLO:
            return 0, b"\x00\x00"
        if cmd == CMD_INIT:
            return 0, struct.pack("<Q", 0)
        if cmd == CMD_PUSH:
            store[key] = bytes(payload)
            return 0, b""
        if cmd == CMD_PULL:
            return 0, store[key]
        return 1, b""

    srv = StubPSServer(handler, record=True)
    try:
        s = _session(PSSession, srv.port, wire_conns=1)
        rng = np.random.RandomState(3)
        params0 = {"w": rng.randn(256).astype(np.float32)}
        grads = [{"w": rng.randn(256).astype(np.float32)} for _ in range(3)]
        if use_trainer:
            tr = pso.ServerOptTrainer(s, _tensors(params0),
                                      {"opt": "sgd", "lr": 0.1},
                                      mode="local", declared_key=3)
            for g in grads:
                tr.step(_tensors(g))
        else:
            for g in grads:
                s.push_pull(3, g["w"].ravel())
        s.close()
        with srv.lock:
            return list(srv.frames)
    finally:
        srv.close()


def test_local_mode_wire_identity_no_opt_frames():
    off = _stub_roundtrip(use_trainer=False)
    on = _stub_roundtrip(use_trainer=True)
    assert [h for h, _, _ in off] == [h for h, _, _ in on]
    assert [b for _, _, b in off] == [b for _, _, b in on]
    assert all(c != CMD_OPT for _, c, _ in on)


def test_signal_window_carries_opt_keys_slice(port_server):
    from byteps_tpu_torch.common import doctor, signals

    s = _session(PSSession, port_server())
    plane = signals.arm(window_s=60.0, start_thread=False,
                        refresh=lambda: s.server_stats())
    try:
        rng = np.random.RandomState(11)
        tr = pso.ServerOptTrainer(
            s, {"w": torch.from_numpy(rng.randn(1 << 10).astype(np.float32))},
            {"opt": "adam", "lr": 1e-3}, mode="server", declared_key=95)
        tr.step({"w": torch.from_numpy(
            rng.randn(1 << 10).astype(np.float32))})
        sec = plane.roll().get("server") or {}
        assert "keys" not in sec
        row = next(iter((sec.get("opt_keys") or {}).values()))
        assert row["opt_mode"] == 3 and row["param_version"] == 1
        frozen = [{"window": i, "metrics": {}, "events": {}, "keys": {},
                   "server": {"opt_keys": {"9": {
                       "completed_round": 2 + i, "param_version": 1,
                       "opt_mode": 3}}}} for i in range(3)]
        fired = {f["rule"] for f in
                 doctor.evaluate_stream(frozen)["history"]}
        assert "param_version_stall" in fired
    finally:
        signals.disarm()
        s.close()


def test_modes_refuse_what_they_cannot_serve(monkeypatch):
    class Async:
        server_async = True
    with pytest.raises(RuntimeError, match="sync rounds"):
        pso.ServerOptTrainer(Async(), {"w": torch.zeros(2)}, {})

    class Sync:
        server_async = False
    with pytest.raises(ValueError, match="mode"):
        pso.ServerOptTrainer(Sync(), {"w": torch.zeros(2)}, {}, mode="x")
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 6c\)"):
        pso.ServerOptTrainer(Sync(), {"w": torch.zeros(2)}, {},
                             hierarchy=object())
    monkeypatch.setenv("BYTEPS_TPU_HIERARCHY", "1")
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 6c\)"):
        pso.ServerOptTrainer(Sync(), {"w": torch.zeros(2)}, {})
