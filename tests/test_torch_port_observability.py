"""The port's flight recorder, doctor, signal classification, trace
analysis and device plane against the JAX package's, on the CPU.

- Bundles: the same events and providers give the reference's bundle,
  apart from pid, host and time; ``tools/postmortem.py`` renders a port
  bundle and ``tools/bps_doctor.py`` (a subprocess) replays it to the
  verdict the port's engine gave.
- Doctor: synthetic window streams that fire each per-worker rule give
  identical findings (rule, severity, subject, evidence, anchor) in both
  engines; ``classify`` agrees on a table of records; ``RULE_IDS`` match.
- Trace analysis: ``analyze``, ``format_report`` and the critical-path
  gauges agree on the same events, and ``tools/trace_analyze.py`` reads a
  port ``comm.json`` with its device lane.
- Device plane: ``build_train_step`` on the ``tiny`` transformer at
  ``device="cpu"`` counts every step, reports an MFU under
  ``BYTEPS_TPU_PEAK_FLOPS`` and counts exactly the model's analytic FLOPs
  (flash through its FLOP formula, dense through its products); armed
  losses and parameters are bit-equal to unarmed ones; unarmed there are
  no device gauges, lanes or syncs; an intended ``gpu`` convicts a CPU
  run in one window.
"""

import copy
import json
import os
import subprocess
import sys

import pytest
import torch

from torch_port_threads import one_torch_thread  # noqa: F401
from testutil import cpu_env

from byteps_tpu.common import doctor as ref_doctor
from byteps_tpu.common import flightrec as ref_flightrec
from byteps_tpu.common import signals as ref_signals
from byteps_tpu.common import telemetry as ref_tm
from byteps_tpu.common import trace_analysis as ref_ta
import byteps_tpu_torch as bps
from byteps_tpu_torch.common import devprof
from byteps_tpu_torch.common import doctor as port_doctor
from byteps_tpu_torch.common import flightrec as port_flightrec
from byteps_tpu_torch.common import signals as port_signals
from byteps_tpu_torch.common import telemetry as port_tm
from byteps_tpu_torch.common import trace_analysis as port_ta
from byteps_tpu_torch.common.config import get_config
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import transformer as tfm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
if TOOLS not in sys.path:
    sys.path.insert(0, TOOLS)


@pytest.fixture(autouse=True)
def fresh_config():
    """Re-read the environment once monkeypatch has restored it."""
    yield
    get_config(refresh=True)


# ---------------------------------------------------------------------------
# Flight recorder bundles
# ---------------------------------------------------------------------------
def _bundle(fr, tm, directory, monkeypatch):
    """One bundle from the same events, providers and metrics."""
    reg = tm.MetricsRegistry()
    reg.counter("bps_pushpull_bytes_total").inc(4096)
    reg.histogram("bps_step_time_seconds",
                  bounds=tm.STEP_TIME_BUCKETS).observe(0.25)
    monkeypatch.setattr(tm, "get_registry", lambda: reg)
    monkeypatch.setattr(fr, "_providers", {})
    fr.reset(capacity=3)
    for i in range(5):                      # two fall off the ring
        fr.record("round", key=i, value=float("inf") if i == 4 else i)
    fr.set_extra_provider(lambda: {"step": 7})
    fr.set_extra_provider(lambda: {"device": {"probe": {"fallback": True}}},
                          name="device")
    path = fr.dump_bundle("parity", extra={"note": "x"},
                          directory=str(directory))
    with open(path) as f:
        doc = json.load(f)
    for k in ("pid", "host", "clock"):
        doc.pop(k)
    for ev in doc["events"]:
        ev.pop("t")
        ev.pop("mono")
    return doc


def test_bundle_equals_the_reference_and_renders(tmp_path, monkeypatch):
    ref = _bundle(ref_flightrec, ref_tm, tmp_path / "ref", monkeypatch)
    port = _bundle(port_flightrec, port_tm, tmp_path / "port", monkeypatch)
    assert port == ref
    assert port["schema"] == "bps-postmortem-v1"
    assert port["events_dropped"] == 2 and port["events"][-1]["value"] == \
        "inf"
    import postmortem
    analysis = postmortem.analyze(
        postmortem.load_bundles([str(tmp_path / "port")]))
    (row,) = analysis["device"]
    assert row["fallback"] is True
    assert "device plane" in postmortem.render(analysis)


# ---------------------------------------------------------------------------
# Doctor and signals
# ---------------------------------------------------------------------------
def W(idx=0, metrics=None, events=None, **sections):
    """One synthetic window summary."""
    s = {"schema": "bps-signal-window-v1", "window": idx,
         "ts": 1000.0 + idx * 10.0, "dur_s": 10.0, "keys": {},
         "metrics": metrics or {}, "events": events or {}}
    s.update(sections)
    return s


def _lag(w0, w1):
    return {'bps_worker_round_lag{worker="0"}': w0,
            'bps_worker_round_lag{worker="1"}': w1}


def _lanes(b0, b1):
    return {"lanes": [
        {"server": 0, "lane": 0, "bytes_total": b0, "sends": 1},
        {"server": 0, "lane": 1, "bytes_total": b1, "sends": 1}]}


def _dev(mfu=None, fallback=False, **probe):
    probe = {"platform": "gpu", "intended": "gpu", "fallback": fallback,
             "reason": "", **probe}
    return {"device": {"schema": "bps-device-v1", "probe": probe,
                       "platform": probe["platform"], "steps": 10,
                       "compute_s": 1.0, "device_step_ms": 100.0,
                       "mfu": mfu}}


def _keys(wire_s):
    return {"k": {"components": {"queue": wire_s / 2,
                                 "push_wire": wire_s / 2}}}


def _owned(a, b, c):
    return {'bps_keys_owned{server="0"}': a,
            'bps_keys_owned{server="1"}': b,
            'bps_keys_owned{server="2"}': c}


def _em(hits, misses, pulled):
    return {"bps_embed_cache_hits": hits, "bps_embed_cache_misses": misses,
            "bps_embed_pull_bytes_total": pulled}


# rule id -> a window stream that fires it (and sometimes others).
STREAMS = {
    "persistent_straggler": [W(0, _lag(0, 2)), W(1, _lag(0, 2))],
    "round_lag_growth": [W(i, _lag(0, i + 1)) for i in range(3)],
    "lane_credit_imbalance": [W(0, transport=_lanes(0, 0)),
                              W(1, transport=_lanes(90 << 20, 1 << 20))],
    "recv_pool_miss_rate": [
        W(0, {"bps_transport_pool_hits": 0, "bps_transport_pool_misses": 0}),
        W(1, {"bps_transport_pool_hits": 10,
              "bps_transport_pool_misses": 90})],
    "fusion_dilution": [
        W(0, {"bps_fusion_deadline_flushes": 0,
              "bps_fusion_full_flushes": 0}),
        W(1, {"bps_fusion_deadline_flushes": 9,
              "bps_fusion_full_flushes": 1})],
    "server_hot_shard": [
        W(0, _owned(10, 10, 10), server={"servers": {
            "0": {"bytes_in": 0}, "1": {"bytes_in": 0},
            "2": {"bytes_in": 0}}}),
        W(1, _owned(10, 10, 10), server={"servers": {
            "0": {"bytes_in": 95 << 20}, "1": {"bytes_in": 1 << 20},
            "2": {"bytes_in": 1 << 20}}})],
    "nonfinite_gradients": [
        W(0, {"bps_grad_nonfinite_total": 0}),
        W(1, {"bps_grad_nonfinite_total": 2,
              'bps_grad_nonfinite{key="g.w"}': 4})],
    "audit_mismatch": [W(0, {"bps_audit_mismatch_total": 0,
                             "bps_audit_round_skew_total": 0}),
                       W(1, {"bps_audit_mismatch_total": 1,
                             "bps_audit_round_skew_total": 2})],
    "barrier_stall": [W(0, {"bps_transport_watchdog_trips": 0}),
                      W(1, {"bps_transport_watchdog_trips": 1},
                        events={"stall": 2, "barrier_timeout": 1})],
    "tuner_thrash": [W(i, {'bps_tuner_key_switches_total{key="k1"}': v},
                       keys={"k1": {"class": "wire_bound"}})
                     for i, v in enumerate([0, 1, 2, 3, 3, 3, 3])],
    "knob_thrash": [W(i, {"bps_knob_switches_total": v, "bps_knob_epoch": v,
                          'bps_knob_value{knob="fusion_bytes"}':
                          (1 << 20) * (v + 1)})
                    for i, v in enumerate([0, 1, 2, 3, 3, 3, 3])],
    "param_version_stall": [
        W(i, server={"keys": {"7": {"completed_round": c,
                                    "param_version": 4, "opt_mode": 3}}})
        for i, c in enumerate([4, 6, 8])],
    "embedding_cache_thrash": [W(0, _em(10, 90, 1 << 20)),
                               W(1, _em(20, 180, 2 << 20)),
                               W(2, _em(30, 270, 3 << 20))],
    "replication_lag": [
        W(i, server={"repl_armed": True,
                     "servers": {"0": {"repl_lag_rounds": 0},
                                 "1": {"repl_lag_rounds": lag}}})
        for i, lag in enumerate([5, 6])],
    "device_fallback": [
        W(0, **_dev(fallback=True, platform="cpu", tunnel_alive=False,
                    reason="intended platform 'gpu' but the steps ran on "
                           "'cpu'")),
        W(1, **_dev(fallback=True, platform="unknown(RuntimeError())",
                    intended="", tunnel_alive=True,
                    reason="device probe failed"))],
    "mfu_regression": [W(0, keys=_keys(1.0), **_dev(mfu=0.40)),
                       W(1, keys=_keys(1.0), **_dev(mfu=0.20)),
                       W(2, keys=_keys(1.0), **_dev(mfu=0.21))],
}

FINDING_KEYS = ("rule", "severity", "subject", "evidence", "playbook",
                "window", "first_window", "ts")


def _findings(diag):
    return {part: [{k: f[k] for k in FINDING_KEYS} for f in diag[part]]
            for part in ("open", "history")}


@pytest.mark.parametrize("rule", sorted(STREAMS))
def test_doctor_findings_equal_the_reference(rule):
    stream = STREAMS[rule]
    ref = ref_doctor.evaluate_stream(copy.deepcopy(stream))
    port = port_doctor.evaluate_stream(copy.deepcopy(stream))
    assert rule in {f["rule"] for f in port["history"]}
    assert _findings(port) == _findings(ref)
    assert (port["healthy"], port["findings_total"],
            port["windows_evaluated"]) == (ref["healthy"],
                                           ref["findings_total"],
                                           ref["windows_evaluated"])


def test_rule_ids_thresholds_and_streams_match():
    assert port_doctor.RULE_IDS == ref_doctor.RULE_IDS
    assert port_doctor.DEFAULT_THRESHOLDS == ref_doctor.DEFAULT_THRESHOLDS
    assert [(r.id, r.severity) for r in port_doctor.RULES] == \
        [(r.id, r.severity) for r in ref_doctor.RULES]
    assert set(STREAMS) == {r.id for r in port_doctor.RULES}
    assert all(port_doctor.playbook_anchor(r) == ref_doctor.playbook_anchor(r)
               for r in port_doctor.RULE_IDS)


def test_metrics_jsonl_replay_equals_the_reference():
    lines = [{"ts": 100.0 + i, "metrics": {
        "bps_transport_pool_hits": 10 * i, "bps_transport_pool_misses": 90 * i,
        'bps_worker_round_lag{worker="1"}': i, "h": {"buckets": []}}}
        for i in range(4)]
    ref = ref_doctor.summaries_from_metrics_jsonl(lines)
    port = port_doctor.summaries_from_metrics_jsonl(lines)
    assert port == ref
    assert _findings(port_doctor.evaluate_stream(port)) == \
        _findings(ref_doctor.evaluate_stream(ref))


CLASSIFY_TABLE = [
    {},
    {"pushes": 0},
    {"pushes": 4, "push_bytes": 4 * 1024},
    {"pushes": 2, "push_bytes": 1 << 21,
     "components": {"queue": 0.2, "push_wire": 0.3, "serve": 0.1}},
    {"pushes": 2, "push_bytes": 1 << 21,
     "components": {"encode": 0.4, "decode": 0.3, "queue": 0.1}},
    {"pushes": 2, "push_bytes": 1 << 21,
     "components": {"serve": 0.9, "queue": 0.1}},
    {"pushes": 2, "push_bytes": 1 << 21, "components": {}},
    {"pushes": 2, "push_bytes": 1 << 21, "health": {"nonfinite": 3}},
    {"pushes": 2, "push_bytes": 1 << 21, "audit_bad": True,
     "components": {"serve": 1.0}},
    {"pushes": 2, "push_bytes": 1 << 21,
     "components": {"serve": 0.5, "encode": 0.25, "decode": 0.25}},
]


def test_classify_and_signal_window_equal_the_reference():
    got = [port_signals.classify(r) for r in CLASSIFY_TABLE]
    assert got == [ref_signals.classify(r) for r in CLASSIFY_TABLE]
    assert set(got) == set(port_signals.CLASSES)
    assert port_signals.classify(CLASSIFY_TABLE[2], tiny_bytes=1024) == \
        ref_signals.classify(CLASSIFY_TABLE[2], tiny_bytes=1024)
    # One window through both planes from the same feeds.
    wins = []
    for mod in (ref_signals, port_signals):
        plane = mod.SignalPlane(window_s=60, providers={
            "device": lambda: _dev(mfu=0.1)["device"]})
        plane._collect_metrics = lambda: {"bps_x": 1}
        plane._collect_events = lambda lo, upto: {"stall": 1}
        plane.note_part("w.part0", 1 << 20, 1 << 20, queue_s=0.01,
                        rtt_s=0.02, serve_s=0.005, wire_bytes=1 << 18)
        plane.note_part("w.part1", 1 << 20, 1 << 20, rtt_s=0.03)
        plane.note_codec("w.part0", "encode", 1500.0)
        plane.note_part("b", 512, 512)
        win = plane.roll(now=plane._last_roll_mono + 2.0)
        for k in ("ts", "anchor", "mono"):
            win.pop(k)
        wins.append(win)
    assert wins[1] == wins[0]
    assert wins[1]["keys"]["w"]["class"] == "wire_bound"


# ---------------------------------------------------------------------------
# Trace analysis
# ---------------------------------------------------------------------------
def _trace_events():
    ev = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
           "args": {"name": "worker0"}}]
    for s in range(2):
        t0 = 1000 * s * 100
        ev.append({"name": f"step_{s}", "ph": "X", "pid": 0, "tid": "STEP",
                   "ts": t0, "dur": 90_000})
        for key in (1 << 16, 2 << 16):
            for stage, off, dur in (("QUEUE", 0, 500), ("ENCODE", 500, 700),
                                    ("PUSH", 1200, 4000),
                                    ("PULL", 5200, 6000 + key // 4096),
                                    ("DECODE", 11300 + key // 4096, 300)):
                ev.append({"name": f"g{key >> 16}.part0", "ph": "X",
                           "pid": 0, "tid": stage, "ts": t0 + off,
                           "dur": dur, "args": {"key": key,
                                                "members": ["a", "b"]}})
        for w, wait in ((0, 3000), (1, 100)):
            ev.append({"name": "g1.part0", "ph": "X", "pid": 10000,
                       "tid": "MERGE_WAIT", "ts": t0 + 5300, "dur": wait,
                       "args": {"key": 1 << 16, "round": s, "worker": w}})
        ev.append({"name": "device_step", "ph": "X", "pid": 20000,
                   "tid": "DEVICE", "ts": t0, "dur": 80_000,
                   "args": {"step": s}})
    return ev


def test_trace_analysis_equals_the_reference():
    ev = _trace_events()
    ref = ref_ta.analyze(copy.deepcopy(ev), worker=0, top_k=1)
    port = port_ta.analyze(copy.deepcopy(ev), worker=0, top_k=1)
    assert port == ref and port["straggler_wait_us"] == {1: 6000}
    assert port_ta.format_report(port) == ref_ta.format_report(ref)
    assert (port_ta.SERVER_PID_BASE, port_ta.DEVICE_PID_BASE) == \
        (ref_ta.SERVER_PID_BASE, ref_ta.DEVICE_PID_BASE)
    regs = (ref_tm.MetricsRegistry(), port_tm.MetricsRegistry())
    ref_ta.update_critical_path_gauges(ref, regs[0])
    port_ta.update_critical_path_gauges(port, regs[1])
    port_ta.update_critical_path_gauges(dict(port, straggler_wait_us={}),
                                        regs[1])
    ref_ta.update_critical_path_gauges(dict(ref, straggler_wait_us={}),
                                       regs[0])
    assert regs[1].snapshot() == regs[0].snapshot()
    assert regs[1].snapshot()[
        'bps_step_critical_path_seconds{component="other"}'] > 0


# ---------------------------------------------------------------------------
# The device plane through build_train_step
# ---------------------------------------------------------------------------
B, S = 2, 64


def _analytic_flops(cfg, attn):
    """The tiny model's training FLOPs: every product forward, in the
    recompute of each checkpointed block except its last (mlp_out, whose
    output no backward needs: torch's early stop), and twice in backward;
    the unfused LM head forward and twice in backward; flash by its
    visible pairs (4 · pairs · D forward and again in the recompute, 6 and
    8 backward), dense by its two [S, S] products (forward, recompute and
    two backward each)."""
    n, d, f, dh = B * S, cfg.d_model, cfg.d_ff, cfg.head_dim
    fwd = 2 * n * d * 3 * d + 2 * n * d * d + 2 * 2 * n * d * f
    matmuls = cfg.num_layers * (4 * fwd - 2 * n * f * d)
    head = 3 * 2 * n * d * cfg.vocab_size
    bh = B * cfg.num_heads
    if attn == "flash":
        per = (2 * 4 + 6 + 8) * bh * S * (S + 1) // 2 * dh
    else:
        per = 4 * 2 * 2 * bh * S * S * dh
    return matmuls + head + cfg.num_layers * per


def _train(cfg, steps, device=None):
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    batch = tfm.synthetic_batch(torch.Generator().manual_seed(1), B, S, cfg,
                                device="cpu")
    opt = bps.DistributedOptimizer(torch.optim.AdamW(tree_leaves(params),
                                                     lr=1e-3))
    step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt,
                                device=device)
    losses = []
    for _ in range(steps):
        losses.append(float(step(params, batch)))
        bps.mark_step()
    return losses, tree_leaves(params)


def _trace_env(monkeypatch, tmp, **extra):
    s0 = bps.current_step()
    env = {"BYTEPS_TRACE_ON": 1, "BYTEPS_TRACE_START_STEP": s0 + 1,
           "BYTEPS_TRACE_END_STEP": s0 + 2, "BYTEPS_TRACE_DIR": tmp,
           "BYTEPS_TPU_SIGNAL_WINDOW_S": 3600, **extra}
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))


@pytest.mark.parametrize("attn", ["flash", "dense"])
def test_device_plane_counts_flops_and_changes_nothing(attn, tmp_path,
                                                       monkeypatch, capsys):
    cfg = tfm.get_config("tiny", causal=True, attn_impl=attn)
    syncs = []
    real_sync = devprof._sync
    monkeypatch.setattr(devprof, "_sync",
                        lambda out: (syncs.append(1), real_sync(out)))
    monkeypatch.setattr(port_tm, "_registry", port_tm.MetricsRegistry())
    # Unarmed: no sync, no device gauges, no device lane.
    _trace_env(monkeypatch, tmp_path / "off")
    bps.init()
    try:
        plain, plain_params = _train(cfg, 4, device="cpu")
        port_signals.plane().roll()
        assert syncs == []
        assert not any(k.startswith(("bps_mfu", "bps_device"))
                       for k in bps.get_metrics())
    finally:
        bps.shutdown()
    off = json.loads((tmp_path / "off" / "0" / "comm.json").read_text())
    assert off["traceEvents"] and not any(
        e.get("pid", 0) >= 20000 for e in off["traceEvents"])
    # Armed: the first step counted, the other three timed.
    _trace_env(monkeypatch, tmp_path / "on", BYTEPS_TPU_DEVPROF=1,
               BYTEPS_TPU_PEAK_FLOPS="1e12")
    bps.init()
    try:
        armed, armed_params = _train(cfg, 4, device="cpu")
        port_signals.plane().roll()
        prof = bps.get_device_profile()
        metrics = bps.get_metrics()
    finally:
        bps.shutdown()
    assert armed == plain
    assert all(torch.equal(a, b) for a, b in zip(armed_params, plain_params))
    assert prof["platform"] == "cpu" and not prof["probe"]["fallback"]
    assert prof["steps_total"] == 3 and len(syncs) == 4
    assert prof["cost_cache"] == {"hits": 3, "misses": 1, "entries": 1,
                                  "flops": [float(_analytic_flops(cfg,
                                                                  attn))]}
    assert prof["mfu"] is not None and 0 < prof["mfu"] < 1
    assert metrics['bps_mfu{worker="0"}'] == prof["mfu"]
    assert metrics['bps_device_step_ms{worker="0"}'] > 0
    path = tmp_path / "on" / "0" / "comm.json"
    lanes = [e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("pid", 0) >= 20000]
    assert any(e.get("ph") == "X" and e["tid"] == "DEVICE" for e in lanes)
    assert any(e.get("ph") == "M" and "device0 (cpu)" in e["args"]["name"]
               for e in lanes)
    import trace_analyze
    assert trace_analyze.main([str(path), "--json"]) == 0
    assert len(json.loads(capsys.readouterr().out)["steps"]) == 2  # STEPs


def test_intended_gpu_on_the_cpu_convicts_and_replays(tmp_path, monkeypatch):
    """BYTEPS_TPU_DEVICE_PLATFORM=gpu, steps on the CPU: one window roll
    opens a CRITICAL device_fallback; the bundle dumped then carries the
    device and diagnosis sections, and tools/bps_doctor.py replays it to
    the same verdict."""
    for k, v in {"BYTEPS_TPU_DEVPROF": 1, "BYTEPS_TPU_DEVICE_PLATFORM": "gpu",
                 "BYTEPS_TPU_SIGNAL_WINDOW_S": 3600,
                 "BYTEPS_TPU_POSTMORTEM_DIR": tmp_path}.items():
        monkeypatch.setenv(k, str(v))
    bps.init()
    try:
        assert not bps.get_device_profile()["probe"]["fallback"]  # no step
        _train(tfm.get_config("tiny", causal=True, attn_impl="flash"), 1,
               device="cpu")
        port_signals.plane().roll()
        diag = bps.get_diagnosis()
        path = port_flightrec.dump_bundle("replay")
    finally:
        bps.shutdown()
        port_flightrec.disarm_postmortem()
    (f,) = [f for f in diag["open"] if f["rule"] == "device_fallback"]
    assert f["severity"] == "critical" and f["evidence"]["platform"] == "cpu"
    assert f["evidence"]["intended"] == "gpu"
    extra = json.loads(open(path).read())["extra"]
    assert extra["device"]["probe"]["fallback"] is True
    assert extra["diagnosis"]["open"][0]["rule"] == "device_fallback"
    out = subprocess.run([sys.executable, os.path.join(TOOLS,
                                                       "bps_doctor.py"),
                          path, "--json"], env=cpu_env(), cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    (src,) = json.loads(out.stdout)["sources"]
    assert _findings(src["diagnosis"])["open"] == _findings(diag)["open"]


def test_profiler_capture_parse_and_anchor(tmp_path):
    """``parse_torch_trace`` keeps a Chrome trace's device events (kernels,
    memcpy, memset) and the anchor annotation's timestamp;
    ``merge_profiler_events`` moves them onto the monotonic-µs timebase
    through that anchor.  A CPU capture finds the anchor and no device
    work."""
    trace = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": devprof.ANCHOR,
         "ts": 5000.5, "dur": 1, "pid": 1, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_mma_kernel",
         "ts": 5100.25, "dur": 44.6, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 5200.0, "dur": 0.2, "pid": 0, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5000.0,
         "dur": 9.0, "pid": 1, "tid": 1},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5300.0}]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    parsed = devprof.parse_torch_trace(str(path))
    assert parsed["anchor_us"] == 5000.5
    assert [(e["name"], e["lane"], e["cat"]) for e in parsed["events"]] == [
        ("flash_fwd_mma_kernel", "stream 7", "kernel"),
        ("Memcpy HtoD", "stream 7", "gpu_memcpy")]
    prof = devprof.DeviceProfiler(telemetry_on=False)
    merged = prof.merge_profiler_events(
        parsed["events"] + [{"name": "junk"}], rank=2,
        anchor={"profiler_us": 5000.5, "mono_us": 10_000_000.0})
    assert [(e["ts"], e["dur"], e["pid"], e["tid"]) for e in merged] == [
        (10_000_100, 45, 20002, "stream 7"), (10_000_200, 1, 20002,
                                              "stream 7")]
    assert merged[0]["args"] == {"cat": "kernel"}
    cap = prof.capture(out_dir=str(tmp_path / "cap"),
                       fn=lambda: torch.ones(4) @ torch.ones(4))
    assert cap["anchor"] is not None and cap["events"] == []
    assert not cap["ok"] and "no device events" in cap["note"]
