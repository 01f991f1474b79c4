"""The port's API in PS mode (``BYTEPS_TPU_PS_MODE=1``) against the JAX
package's, on the port's server.

Worker subprocesses (``tests/torch_port_ps_worker.py``) run the eager API
and the Horovod face; their outputs are held to what the reference's PS
tests assert on the same inputs (tests/test_ps_server.py), and to the same
workers on gloo.  Also here: the configuration's PS fields and the PS
telemetry feeds against the reference's, the traced-round wire flag
following the trace window, and no fallback when there is no server or no
native library.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from byteps_tpu.common import config as rconfig
from byteps_tpu.common import telemetry as rtm
import byteps_tpu_torch as bps
from byteps_tpu_torch.common import config as pconfig
from byteps_tpu_torch.common import telemetry as ptm
from byteps_tpu_torch.core import build, native

from testutil import free_port
from torch_port_ps import (  # noqa: F401  (fixtures)
    REPO, RecordingProxy, port_server, reference_client)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

WORKER = os.path.join(REPO, "tests", "torch_port_ps_worker.py")
FLAG_TRACED, PUSH = 0x8000, 2


def _env(port, wid=0, n=1, ps=True, extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BYTEPS_", "DMLC_"))}
    env.update({"PYTHONPATH": REPO, "DMLC_NUM_WORKER": str(n),
                "DMLC_WORKER_ID": str(wid), "DMLC_NUM_SERVER": "1",
                "DMLC_PS_ROOT_URI": "127.0.0.1",
                "DMLC_PS_ROOT_PORT": str(port - 1 if ps else port),
                "BYTEPS_LOG_LEVEL": "ERROR",
                "BYTEPS_TPU_SIGNAL_WINDOW_S": "0"})
    if ps:
        env["BYTEPS_TPU_PS_MODE"] = "1"
    env.update({k: str(v) for k, v in (extra or {}).items()})
    return env


def _run_workers(mode, prefix, envs, timeout=120):
    procs = [subprocess.Popen([sys.executable, WORKER, mode, prefix],
                              env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for e in envs]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=timeout)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        errs.append(err)
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]


# ---------------------------------------------------------------------------
# The eager API in PS mode
# ---------------------------------------------------------------------------
def test_ps_mode_eager_api_equals_reference(port_server, reference_client,
                                            tmp_path):
    port = port_server(num_workers=1)
    proxy = RecordingProxy(port)
    try:
        _run_workers("api", str(tmp_path / "api"), [_env(
            proxy.port, extra={
                "BYTEPS_PARTITION_BYTES": 65536,
                "BYTEPS_SCHEDULING_CREDIT": 4,
                "BYTEPS_MIN_COMPRESS_BYTES": 0,
                "BYTEPS_TPU_FUSION_BYTES": 1024,
                "BYTEPS_TRACE_ON": 1, "BYTEPS_TRACE_START_STEP": 1,
                "BYTEPS_TRACE_END_STEP": 1,
                "BYTEPS_TRACE_DIR": tmp_path / "trace"})])
        time.sleep(0.2)
        frames = [f for conn in proxy.frames() for f in conn]
    finally:
        proxy.close()
    out = np.load(tmp_path / "api.0.npz")
    meta = json.loads((tmp_path / "api.0.json").read_text())
    # tests/test_ps_server.py: test_api_push_pull_via_ps_mode
    x = np.arange(100000, dtype=np.float32)
    np.testing.assert_array_equal(out["pp"], x)
    np.testing.assert_array_equal(out["async"], 2 * x)
    want_bf16 = torch.linspace(-3, 3, 64, dtype=torch.bfloat16).float()
    np.testing.assert_array_equal(out["avg_bf16"], want_bf16.numpy())
    # ...: test_push_pull_tree_preserves_wire_compression
    rwire = sys.modules["byteps_tpu.server.wire"]
    g = np.linspace(-2.0, 3.0, 4096, dtype=np.float32)
    wc = rwire.WireCompressor({"compressor": "onebit"})
    want = rwire.decode(wc.encode(0, g), g.size)
    want = rwire.decode(wc.encode(0, want), want.size)
    np.testing.assert_allclose(out["tree.comp.g"], want, rtol=1e-6)
    assert not np.allclose(out["tree.comp.g"], g)
    np.testing.assert_array_equal(out["tree.plain.h"], np.full(64, 7.0))
    np.testing.assert_array_equal(out["tree.plain.i"], np.arange(5))
    np.testing.assert_array_equal(out["tree.plain.k"],
                                  torch.linspace(0, 1, 33).numpy())
    np.testing.assert_array_equal(
        out["rounds"], np.repeat(np.arange(1, 4, dtype=np.float32)[:, None],
                                 16, axis=1))
    # rank/size from the job, a session and no process group
    assert (meta["rank"], meta["size"]) == (0, 1)
    assert meta["session"] and not meta["process_group"]
    assert meta["staging"]["copies"] > 0
    assert meta["staging"]["to_host_bytes"] >= 2 * 4 * 100000
    # The traced-round flag rides exactly the pushes of the trace
    # window's step (1 of steps 0-2), on the key pushed at each step.
    traced = {f[4] >> 16 for f in frames if f[0] == PUSH
              and f[2] & FLAG_TRACED}
    assert len(traced) == 1
    dk = traced.pop()
    flags = [f[2] for f in frames if f[0] == PUSH and f[4] >> 16 == dk]
    assert sorted((fl & 0x7FFF, bool(fl & FLAG_TRACED))
                  for fl in flags) == [(0, False), (1, True), (2, False)]
    assert not any(f[2] & FLAG_TRACED for f in frames
                   if f[0] == PUSH and f[4] >> 16 != dk)
    trace = json.loads((tmp_path / "trace" / "0" / "comm.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]}
    assert "step_1" in names
    # The getters' keys are the reference's.
    s = reference_client.PSSession(["127.0.0.1"], [port], worker_id=0,
                                   num_servers=1)
    try:
        assert meta["server_stats"] == sorted(
            [*s.server_stats(), "round_lag"])
        assert meta["transport_stats"] == sorted(s.transport_stats())
        assert meta["codec_stats"] == sorted(s.codec_stats())
    finally:
        s.close()


def test_ps_init_without_server_raises(monkeypatch):
    """BYTEPS_TPU_PS_MODE is honoured: with no server reachable init()
    raises within the barrier timeout, and neither a session nor a
    process group is left; a native library that does not build raises
    too (there is no fallback)."""
    for k, v in {"BYTEPS_TPU_PS_MODE": "1", "DMLC_NUM_WORKER": "2",
                 "DMLC_WORKER_ID": "0",
                 "DMLC_PS_ROOT_PORT": str(free_port() - 1),
                 "BYTEPS_TPU_BARRIER_TIMEOUT_S": "5",
                 "BYTEPS_TPU_SIGNAL_WINDOW_S": "0"}.items():
        monkeypatch.setenv(k, v)
    t0 = time.monotonic()
    with pytest.raises((OSError, TimeoutError)):
        bps.init()
    assert time.monotonic() - t0 < 5
    assert bps.get_ps_session() is None and not dist.is_initialized()
    monkeypatch.setenv("BYTEPS_TPU_HIERARCHY", "1")
    with pytest.raises(NotImplementedError, match="item 6c"):
        bps.init()
    monkeypatch.delenv("BYTEPS_TPU_HIERARCHY")

    def no_build():
        raise RuntimeError("g++ failed: (no compiler)")
    monkeypatch.setattr(native, "_native", None)
    monkeypatch.setattr(build, "build", no_build)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        bps.init()
    assert bps.get_ps_session() is None and not dist.is_initialized()


# ---------------------------------------------------------------------------
# Training through the face: PS mode equals gloo bit for bit
# ---------------------------------------------------------------------------
def test_ps_training_bit_equal_to_gloo(port_server, tmp_path):
    port = port_server(num_workers=2)
    gport = free_port()
    _run_workers("train", str(tmp_path / "ps"),
                 [_env(port, w, 2) for w in (0, 1)])
    _run_workers("train", str(tmp_path / "gloo"),
                 [_env(gport, w, 2, ps=False) for w in (0, 1)])
    runs = {k: [np.load(tmp_path / f"{k}.{w}.npz") for w in (0, 1)]
            for k in ("ps", "gloo")}
    for w in (0, 1):
        ps, gl = runs["ps"][w], runs["gloo"][w]
        np.testing.assert_array_equal(ps["rank_size"], [w, 2])
        assert ps["ps"] and not gl["ps"]
        np.testing.assert_array_equal(ps["bcast_w"], np.full(5, 2.0))
        np.testing.assert_array_equal(ps["bcast_i"], np.arange(3) * 2)
        assert ps["bcast_n"] == 4.5
        assert sorted(ps.files) == sorted(gl.files)
        for k in ps.files:
            if k == "ps":
                continue
            np.testing.assert_array_equal(ps[k], gl[k], err_msg=k)
    p0, p1 = runs["ps"]
    for k in p0.files:
        if k.startswith("step"):
            np.testing.assert_array_equal(p0[k], p1[k], err_msg=k)
    assert not np.array_equal(p0["losses"], p1["losses"])  # own batches


# ---------------------------------------------------------------------------
# Plumbing: the configuration's PS fields and the telemetry feeds
# ---------------------------------------------------------------------------
_PORT_FIELDS = {f.name for f in pconfig.Config.__dataclass_fields__.values()}
_ADDED = {
    "DMLC_ROLE": ("role", "server"),
    "DMLC_NUM_SERVER": ("num_server", "3"),
    "BYTEPS_TPU_PS_MODE": ("ps_mode", "1"),
    "BYTEPS_MIN_COMPRESS_BYTES": ("min_compress_bytes", "1024"),
    "BYTEPS_TPU_WIRE_CONNS": ("wire_conns", "2"),
    "BYTEPS_TPU_SERVER_UDS": ("server_uds", "/tmp/bps.sock"),
    "BYTEPS_TPU_SOCK_BUF_KB": ("sock_buf_kb", "512"),
    "BYTEPS_TPU_COMPRESS_THREADS": ("compress_threads", "0"),
    "BYTEPS_SCHEDULING_CREDIT": ("scheduling_credit", "4"),
    "BYTEPS_TPU_RECONNECT_ATTEMPTS": ("reconnect_attempts", "8"),
    "BYTEPS_TPU_RECONNECT_BACKOFF_MS": ("reconnect_backoff_ms", "12.5"),
    "BYTEPS_TPU_STALL_TIMEOUT_S": ("stall_timeout_s", "1.5"),
    "BYTEPS_TPU_BARRIER_TIMEOUT_S": ("barrier_timeout_s", "30"),
    "BYTEPS_TPU_EVICT_TIMEOUT_S": ("evict_timeout_s", "0.6"),
    "BYTEPS_TPU_MEMBERSHIP_POLL_S": ("membership_poll_s", "0.25"),
    "BYTEPS_TPU_SERVER_EVICT_TIMEOUT_S": ("server_evict_timeout_s", "3"),
    "BYTEPS_TPU_AUDIT": ("audit", "yes"),
    "BYTEPS_TPU_AUDIT_WINDOW": ("audit_window", "8"),
    "BYTEPS_TPU_HEALTH_SAMPLE_ROUNDS": ("health_sample_rounds", "5"),
    "BYTEPS_KEY_HASH_FN": ("key_hash_fn", "sdbm"),
    "BYTEPS_TPU_CLOCK_SYNC_S": ("clock_sync_s", "7.5"),
    "BYTEPS_TPU_STRAGGLER_ROUNDS": ("straggler_rounds", "0"),
    "BYTEPS_TPU_FLEET": ("fleet", "on"),
    "BYTEPS_TPU_FLEET_WINDOWS": ("fleet_windows", "4"),
    "BYTEPS_TPU_HIERARCHY": ("hierarchy", "true"),
    "BYTEPS_TPU_SLICE_SIZE": ("slice_size", "4"),
}


def test_every_added_field_is_covered():
    assert {f for f, _ in _ADDED.values()} <= _PORT_FIELDS
    for env in _ADDED:
        assert env in open(pconfig.__file__).read()


@pytest.mark.parametrize("env", sorted(_ADDED))
def test_config_field_equals_reference(env, monkeypatch):
    field, value = _ADDED[env]
    default_p = getattr(pconfig.Config.from_env(), field)
    assert default_p == getattr(rconfig.Config.from_env(), field)
    monkeypatch.setenv(env, value)
    got = getattr(pconfig.Config.from_env(), field)
    assert got == getattr(rconfig.Config.from_env(), field)
    assert got != default_p


_STATS = {
    "bytes_in": 10, "bytes_out": 20, "async": False, "num_workers": 3,
    "workers": {"0": {"round": 9}, "1": {"round": 4}, "2": {"round": 9}},
    "keys": {"65536": {"opt_mode": 1, "param_version": 7},
             "131072": {"opt_mode": 0}},
    "epoch": 2, "members": {0: {"alive": 1}, 1: {"alive": 0}, 2: {"alive": 1}},
    "ring_epoch": 1, "repl_armed": True, "repl_bytes_total": 4096,
    "fleet_armed": True, "fleet_publishes": 6, "embed_rows_served": 12,
    "embed_table_bytes": 1024, "opt_updates": 3,
    "servers": {0: {"alive": True, "keys_owned": 5, "migrations_in": 1,
                    "migrations_out": 0, "opt_slot_bytes": 96,
                    "repl_lag_rounds": 1, "fleet_windows_held": 2,
                    "embed_table_bytes": 1024},
                1: {"alive": False, "keys_owned": 0, "migrations_in": 0,
                    "migrations_out": 5, "opt_slot_bytes": 0,
                    "repl_lag_rounds": 0, "fleet_windows_held": 0,
                    "embed_table_bytes": 0}},
}


def test_ps_telemetry_feeds_equal_reference():
    regs = []
    for mod in (rtm, ptm):
        reg = mod.MetricsRegistry()
        lags = mod.update_round_lag(_STATS, 2, registry=reg)
        mod.update_membership({"epoch": 2, "workers": _STATS["members"]},
                              registry=reg)
        for feed in ("update_ring", "update_server_opt", "update_embed",
                     "update_repl", "update_fleet"):
            getattr(mod, feed)(_STATS, registry=reg)
        regs.append((lags, reg.render_prometheus()))
    assert regs[0] == regs[1]
    assert regs[1][0] == {0: 0, 1: 5, 2: 0}
    for name in ("bps_worker_round_lag", "bps_membership_epoch",
                 "bps_ring_epoch", "bps_param_version", "bps_repl_lag_rounds",
                 "bps_fleet_windows_held", "bps_embed_table_bytes"):
        assert name in regs[1][1]
