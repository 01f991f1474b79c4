"""The port's metrics plane against the JAX package's
(``byteps_tpu_torch/common/telemetry.py`` vs ``byteps_tpu/common/
telemetry.py``): the same operations under the same fake clock give the
same snapshot, Prometheus text and push_pull speed; ``tools/bps_top.py``
reads the port's text as the reference's; the exporter serves
``/metrics`` and the JSON routes over HTTP, rotates its JSONL log, and a
taken port does not stop ``init()``; the stubs that stay name their
ROADMAP item."""

import json
import logging
import os
import socket
import sys
import types
import urllib.error
import urllib.request

import pytest
import torch

from torch_port_threads import one_torch_thread  # noqa: F401

from byteps_tpu.common import telemetry as ref_tm
import byteps_tpu_torch as bps
from byteps_tpu_torch.common import api as port_api
from byteps_tpu_torch.common import signals as port_signals
from byteps_tpu_torch.common import telemetry as port_tm
from byteps_tpu_torch.common.config import get_config

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)


@pytest.fixture(autouse=True)
def fresh_config():
    """Re-read the environment once monkeypatch has restored it: init()
    leaves its config behind for later get_config() calls."""
    yield
    get_config(refresh=True)


class FakeClock:
    """Stands in for a telemetry module's ``time``: both clocks advance
    only when the test says so."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1.7e9 + self.now


@pytest.fixture
def clocks(monkeypatch):
    """One fake clock in both telemetry modules, and fresh push_pull rate
    windows (the module-level ones are restored afterwards)."""
    clock = FakeClock()
    for mod in (ref_tm, port_tm):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(
            monotonic=clock.monotonic, time=clock.time))
        monkeypatch.setattr(mod, "_pushpull_rate", mod.MovingRate(10.0))
    return clock


def _drive(tm, clock):
    """One sequence of registry operations; returns the registry."""
    reg = tm.MetricsRegistry()
    c = reg.counter("bps_pushpull_bytes_total", help="bytes")
    c.inc(123)
    c.inc(4_000_000_001)
    lab = reg.counter("bps_doctor_findings_total", help="findings",
                      labels={"rule": 'odd "name"\\x'})
    lab.inc()
    reg.gauge("bps_mfu", help="mfu", labels={"worker": "0"}).set(0.0625)
    reg.gauge("bps_device_step_ms", labels={"worker": "0"}).set(221.992)
    reg.gauge("bps_lazy", fn=lambda: 7)
    h = reg.histogram("bps_step_time_seconds", bounds=tm.STEP_TIME_BUCKETS,
                      help="step wall")
    for v in (0.0005, 0.001, 0.2221, 3.5, 7200.0):
        clock.now += v
        h.observe(v)
    lat = reg.histogram("bps_push_rtt_seconds", labels={"lane": "0"})
    for v in (0.0001, 0.00025, 0.3, 11.0):
        lat.observe(v)
    reg.register_collector("fusion", lambda: {"buckets_built": 3,
                                              "fused_bytes": 1 << 20,
                                              "note": "not a number"})
    return reg


def test_registry_snapshot_and_text_equal_the_reference(clocks):
    ref, port = _drive(ref_tm, clocks), _drive(port_tm, clocks)
    assert port.snapshot() == ref.snapshot()
    text = port.render_prometheus()
    assert text == ref.render_prometheus()
    import bps_top
    assert bps_top.parse(text) == bps_top.parse(ref.render_prometheus())
    assert bps_top.parse(text)["bps_mfu"] == {(("worker", "0"),): 0.0625}


def test_pushpull_speed_equals_the_reference(clocks):
    """The same byte sequence at the same fake instants: the same MB/s
    at every reading, window edge included (events older than 10 s are
    pruned)."""
    sizes = [4096, 1 << 20, 12345, 7 << 20, 1, 3 << 20]
    for i, n in enumerate(sizes):
        clocks.now += 2.5 if i % 2 else 0.75
        ref_tm.record_pushpull(n)
        port_tm.record_pushpull(n)
        assert port_tm.pushpull_speed_mbps() == ref_tm.pushpull_speed_mbps()
    clocks.now += 9.0
    assert port_tm.pushpull_speed_mbps() == ref_tm.pushpull_speed_mbps()
    clocks.now += 20.0
    assert port_tm.pushpull_speed_mbps() == 0.0


def test_get_pushpull_speed_reads_the_registry(clocks, monkeypatch):
    """The port's getter and the endpoint's counter are fed by the same
    push_pull call."""
    monkeypatch.setenv("BYTEPS_TPU_SIGNAL_WINDOW_S", "0")
    bps.init()
    try:
        before = port_tm.get_registry().snapshot().get(
            "bps_pushpull_bytes_total", 0)
        bps.push_pull(torch.ones(1000), name="tm.speed")
        ts, mbps = bps.get_pushpull_speed()
        assert mbps == 4000 / 1e6 / 10.0 == port_tm.pushpull_speed_mbps()
        assert bps.get_metrics()["bps_pushpull_bytes_total"] == before + 4000
    finally:
        bps.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read().decode()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_init_serves_metrics_and_json_routes(tmp_path, monkeypatch):
    """init() with a port, a log, the signal plane and the device plane:
    /metrics, /signals, /diagnosis and /device over HTTP, anything else
    404; shutdown() stops the server and writes the log's last line."""
    port = _free_port()
    log = tmp_path / "metrics.jsonl"
    for k, v in {"BYTEPS_TPU_METRICS_PORT": port,
                 "BYTEPS_TPU_METRICS_LOG": log,
                 "BYTEPS_TPU_SIGNAL_WINDOW_S": 60,
                 "BYTEPS_TPU_DEVPROF": 1}.items():
        monkeypatch.setenv(k, str(v))
    bps.init()
    try:
        bps.push_pull(torch.ones(8), name="tm.routes")
        port_signals.plane().roll()
        base = f"http://127.0.0.1:{port}"
        status, ctype, text = _get(f"{base}/metrics")
        assert status == 200 and ctype.startswith("text/plain")
        assert "bps_pushpull_bytes_total " in text
        assert "bps_fusion_buckets_built " in text
        _, ctype, body = _get(f"{base}/signals")
        sig = json.loads(body)
        assert ctype == "application/json"
        assert sig["schema"] == "bps-signal-window-v1"
        assert sig["window"] == 0 and len(sig["windows"]) == 1
        assert sig["windows"][0]["device"]["schema"] == "bps-device-v1"
        diag = json.loads(_get(f"{base}/diagnosis")[2])
        assert diag == bps.get_diagnosis() and diag["armed"] is True
        dev = json.loads(_get(f"{base}/device")[2])
        assert dev["armed"] is True and dev["schema"] == "bps-device-v1"
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(f"{base}/nope")
        assert e.value.code == 404
    finally:
        bps.shutdown()
    with pytest.raises(urllib.error.URLError):
        _get(f"http://127.0.0.1:{port}/metrics")
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert lines and "bps_pushpull_bytes_total" in lines[-1]["metrics"]


def test_taken_port_logs_and_init_goes_on(monkeypatch, caplog):
    blocker = socket.socket()
    blocker.bind(("", 0))
    blocker.listen(1)
    monkeypatch.setenv("BYTEPS_TPU_METRICS_PORT",
                       str(blocker.getsockname()[1]))
    monkeypatch.setenv("BYTEPS_TPU_SIGNAL_WINDOW_S", "0")
    logger = logging.getLogger("byteps_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        bps.init()
        assert port_api._state.initialized and port_api._state.exporter \
            is None
        assert float(bps.push_pull(torch.ones(2), name="tm.taken")[0]) == 1
        bps.shutdown()
    finally:
        logger.removeHandler(caplog.handler)
        blocker.close()
    assert any("metrics exporter failed to start" in r.getMessage()
               and r.levelno == logging.ERROR for r in caplog.records)


def test_jsonl_rotation_at_the_limit(tmp_path, monkeypatch):
    """Past BYTEPS_TPU_METRICS_LOG_MB the log moves to .1, the old .1 to
    .2, and older generations are dropped."""
    path = str(tmp_path / "m.jsonl")
    reg = port_tm.MetricsRegistry()
    reg.gauge("bps_big", labels={"pad": "x" * 4096}).set(1)
    ex = port_tm.TelemetryExporter(reg, jsonl_path=path, max_log_mb=1)
    with open(path, "w") as f:
        f.write("0" * (1 << 20))
    ex.write_snapshot()           # over the cap: rotates, then writes
    assert os.path.getsize(path + ".1") == 1 << 20
    first = json.loads(open(path).read())
    assert first["metrics"]['bps_big{pad="' + "x" * 4096 + '"}'] == 1
    with open(path, "a") as f:
        f.write("1" * (1 << 20))
    ex.write_snapshot()
    with open(path, "a") as f:
        f.write("2" * (1 << 20))
    ex.write_snapshot()
    assert sorted(os.listdir(tmp_path)) == ["m.jsonl", "m.jsonl.1",
                                            "m.jsonl.2"]
    assert open(path + ".2").read(1) == "{"   # the first rotated live file


def _init_with(**env):
    def run(monkeypatch):
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        bps.init()
    return run


_STUBS = {
    "get_hierarchy": lambda mp: bps.get_hierarchy(),
    "get_tuner": lambda mp: bps.get_tuner(),
    "get_autoscaler": lambda mp: bps.get_autoscaler(),
    "get_fleet": lambda mp: bps.get_fleet(),
    "BYTEPS_TPU_HIERARCHY": _init_with(BYTEPS_TPU_PS_MODE="1",
                                       BYTEPS_TPU_HIERARCHY="1"),
}


@pytest.mark.parametrize("name,item", [
    ("get_hierarchy", "6c"), ("BYTEPS_TPU_HIERARCHY", "6c"),
    ("get_tuner", "7b"), ("get_autoscaler", "7b"), ("get_fleet", "7b")])
def test_stubs_name_their_roadmap_item(name, item, monkeypatch):
    with pytest.raises(NotImplementedError,
                       match=rf"Queue 1 item {item}\)"):
        _STUBS[name](monkeypatch)
    assert bps.get_ps_session() is None


@pytest.fixture
def collective_world(monkeypatch):
    monkeypatch.setenv("BYTEPS_TPU_SIGNAL_WINDOW_S", "0")
    bps.init()
    yield
    bps.shutdown()


@pytest.mark.parametrize("name", [
    "get_codec_stats", "get_transport_stats", "get_server_stats",
    "get_health", "get_audit", "get_membership", "get_ring", "leave",
    "drain_ps_server", "on_membership_change"])
def test_ps_getters_outside_ps_mode(name, collective_world):
    """The PS tier's getters outside PS mode give the JAX package's
    shapes (the collective plane has no session): all-zero stats, the
    fixed launch world, and RuntimeError for what needs a session."""
    from byteps_tpu.common import api as ref_api
    if name in ("get_codec_stats", "get_transport_stats",
                "get_server_stats", "get_health", "get_audit"):
        assert getattr(bps, name)() == getattr(ref_api, name)()
    elif name == "get_membership":
        assert bps.get_membership() == {
            "epoch": 0, "workers": {0: {"alive": True, "age_ms": 0.0}},
            "alive": [0], "barrier": {}}
    elif name == "get_ring":
        assert bps.get_ring() == {"epoch": 0, "armed": 0, "vnodes": 64,
                                  "servers": []}
    elif name == "leave":
        assert bps.leave() is None
    else:
        with pytest.raises(RuntimeError, match="requires PS mode"):
            if name == "drain_ps_server":
                bps.drain_ps_server(0)
            else:
                bps.on_membership_change(lambda m: None)


def test_observability_getters_unarmed(monkeypatch):
    """Planes off: the reference's empty shapes, and no device gauges."""
    monkeypatch.setenv("BYTEPS_TPU_SIGNAL_WINDOW_S", "0")
    monkeypatch.setattr(port_tm, "_registry", port_tm.MetricsRegistry())
    bps.init()
    try:
        assert bps.get_key_signals() == {
            "schema": "bps-signal-window-v1", "armed": False,
            "window": -1, "keys": {}}
        assert bps.get_diagnosis() == {"armed": False, "healthy": True,
                                       "open": [], "findings_total": 0}
        assert bps.get_device_profile()["armed"] is False
        assert not any(k.startswith(("bps_mfu", "bps_device"))
                       for k in bps.get_metrics())
    finally:
        bps.shutdown()
