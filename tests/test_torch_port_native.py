"""The port's native host core, held against its Python twin and the JAX
package's.

Every test that needs the port's C++ library (``byteps_tpu_torch/core/
build.py``) is in this file, so that under ``--dist loadfile`` one worker
builds it.  The reference's cores and wire run only as their Python and
numpy paths here (``_PyCore``, ``wire._CWIRE = None``): its own build
writes into the JAX package's directory.
"""

import hashlib
import json
import os
import time

import numpy as np
import pytest
import torch

from byteps_tpu.common import ring as rring
from byteps_tpu.core.native import _PyCore
from byteps_tpu.server import wire as rwire
from byteps_tpu_torch.common import ring
from byteps_tpu_torch.core import build, native
from byteps_tpu_torch.server import wire

from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_build_native_library():
    """Builds the library (once per source hash, under the file lock) and
    reports the build's seconds; a second call reuses it."""
    t0 = time.perf_counter()
    path = build.build()
    secs = time.perf_counter() - t0
    print(f"native core build: {secs:.1f} s (compile "
          f"{build.last_build_seconds} s) -> {path}")
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path).startswith("libbyteps_core_")
    assert build.build() == path
    assert isinstance(native.get_native_core(), native._CCore)
    assert native.is_native()


def test_sources_are_pinned_copies_of_the_reference():
    for src in ("core.cc", "server.cc"):
        digests = []
        for pkg in ("byteps_tpu", "byteps_tpu_torch"):
            with open(os.path.join(REPO, pkg, "core", src), "rb") as f:
                digests.append(hashlib.sha256(f.read()).hexdigest())
        assert digests[0] == digests[1], src


# ---------------------------------------------------------------------------
# Core parity: the native twin and the Python twin, each against the
# reference's _PyCore on the same inputs (tests/test_core_native.py's cases).
# ---------------------------------------------------------------------------
@pytest.fixture(params=["native", "python"])
def core(request):
    if request.param == "native":
        c = native.get_native_core()
        c.reset_registry()
        return c
    return native.Core()


def test_declare_is_deterministic_and_idempotent(core):
    ref = _PyCore()
    for c in (core, ref):
        assert (c.declare_tensor("grad.layer0"),
                c.declare_tensor("grad.layer1")) == (0, 1)
        assert c.declare_tensor("grad.layer0") == 0
        assert c.get_declared_key("grad.layer1") == 1
        assert c.get_declared_key("missing") == -1
        assert c.num_declared() == 2
        assert c.declared_name(0) == "grad.layer0"
        assert c.declared_name(5) is None
    core.reset_registry()
    assert core.num_declared() == 0


def test_key_encoding_roundtrip(core):
    ref = _PyCore()
    for k, p in ((7, 3), (0, 0), (40000, 65535), (1, 1)):
        key = core.encode_key(k, p)
        assert key == ref.encode_key(k, p) == (k << 16) | p
        assert tuple(core.decode_key(key)) == tuple(ref.decode_key(key)) \
            == (k, p)


def test_partition_bounds(core):
    ref = _PyCore()
    mb = 1024 * 1024
    assert core.partition_bounds(10 * mb, 4 * mb) == [
        (0, 4 * mb), (4 * mb, 4 * mb), (8 * mb, 2 * mb)]
    for nbytes in (0, 1, 100, 4 * mb, 10 * mb + 3, 1_234_567):
        for part in (1024, 4 * mb):
            assert core.partition_bounds(nbytes, part) == [
                tuple(b) for b in ref.partition_bounds(nbytes, part)]


@pytest.mark.parametrize("hash_fn", ["djb2", "built_in", "sdbm", "mixed",
                                     "naive"])
def test_key_to_server_hashes(core, hash_fn):
    ref = _PyCore()
    keys = [core.encode_key(i, p) for i in range(64) for p in (0, 3)]
    keys += [12345, 2**40 + 7, 2**63 + 11]
    for n in (1, 2, 4, 7, 8):
        got = [core.key_to_server(k, n, hash_fn) for k in keys]
        assert got == [ref.key_to_server(k, n, hash_fn) for k in keys]
        assert all(0 <= p < n for p in got)
    assert len({core.key_to_server(k, 4, hash_fn) for k in keys}) > 1


def _drain(q):
    out = []
    while True:
        t = q.get()
        if t is None:
            return out
        out.append(tuple(t))


def test_scheduled_queue_priority_order(core):
    qs = [core.queue_create(), _PyCore().queue_create()]
    for q in qs:
        for key, prio in ((10, -10), (1, -1), (5, -5), (7, 3), (2, 3)):
            q.add(key=key, priority=prio, nbytes=100)
    got, want = (_drain(q) for q in qs)
    assert got == want
    assert [k for k, _, _ in got] == [2, 7, 1, 5, 10]


def test_scheduled_queue_tie_break_by_key(core):
    q = core.queue_create()
    q.add(key=9, priority=0, nbytes=1)
    q.add(key=2, priority=0, nbytes=1)
    assert q.get()[0] == 2
    assert q.get()[0] == 9
    assert q.get() is None


def test_scheduled_queue_credit_flow_control(core):
    qs = [core.queue_create(credit_bytes=150),
          _PyCore().queue_create(credit_bytes=150)]
    seen = []
    for q in qs:
        q.add(key=1, priority=0, nbytes=100)
        q.add(key=2, priority=0, nbytes=100)
        a = q.get()
        b = q.get()                  # second task exceeds the credit
        q.report_finish(100)
        c = q.get()
        seen.append((tuple(a), b, tuple(c)))
    assert seen[0] == seen[1] == ((1, 0, 100), None, (2, 0, 100))


def test_scheduled_queue_get_key(core):
    for q in (core.queue_create(), _PyCore().queue_create()):
        q.add(key=1, priority=0, nbytes=10)
        q.add(key=2, priority=0, nbytes=20)
        assert q.get_key(2) == 20
        assert q.get_key(2) is None
        assert q.pending() == 1
    for q in (core.queue_create(credit_bytes=150),
              _PyCore().queue_create(credit_bytes=150)):
        q.add(key=1, priority=0, nbytes=100)
        q.add(key=2, priority=0, nbytes=100)
        assert q.get_key(1) == 100
        assert q.get_key(2) is None
        assert q.pending() == 1
        q.report_finish(100)
        assert q.get_key(2) == 100
        q.report_finish(100)
        q.add(key=3, priority=0, nbytes=1000)
        q.add(key=4, priority=0, nbytes=10)
        assert q.get_key(3) is None
        assert q.get_key(4) == 10


def test_telemetry_speed(core):
    ref = _PyCore()
    for c in (core, ref):
        c.telemetry_reset()
        c.telemetry_set_window_us(1_000_000)
        for _ in range(10):
            c.telemetry_record(1_000_000)
        assert c.telemetry_speed_mbps() == pytest.approx(10.0, rel=0.2)
        c.telemetry_reset()
        assert c.telemetry_speed_mbps() == 0.0
        c.telemetry_set_window_us(10_000_000)


def test_trace_record_and_dump(core, tmp_path):
    docs = []
    for i, c in enumerate((core, _PyCore())):
        c.trace_enable(True)
        assert c.trace_on
        c.trace_record("Gradient.layer0", "PUSH_PULL", 100, 123)
        c.trace_record("Gradient.layer1", "REDUCE", 110, 45)
        c.trace_record_part("Gradient.layer1", "PUSH", 120, 7,
                            key=(3 << 16) | 1, nbytes=4096, priority=-2)
        assert c.trace_count() == 3
        path = str(tmp_path / f"comm{i}.json")
        assert c.trace_dump(path, rank=2) == 0
        assert c.trace_count() == 0
        c.trace_enable(False)
        with open(path) as f:
            docs.append(json.load(f))
    assert docs[0] == docs[1]
    ev = docs[0]["traceEvents"]
    assert [e["dur"] for e in ev] == [123, 45, 7]
    assert "args" not in ev[0]
    assert ev[2]["args"] == {"key": (3 << 16) | 1, "bytes": 4096,
                             "priority": -2}


def test_handle_manager(core):
    ref = _PyCore()
    polls = []
    for c in (core, ref):
        h = [c.handle_allocate() for _ in range(3)]
        assert h == list(range(h[0], h[0] + 3))
        c.handle_mark_done(h[1])
        c.handle_release(h[2])
        polls.append([c.handle_poll(x) for x in h])
        c.handle_release(h[0])
        c.handle_release(h[1])
        assert c.handle_poll(h[0]) == -1
    assert polls[0] == polls[1] == [0, 1, -1]


# ---------------------------------------------------------------------------
# Wire parity: the port's C path, the port's numpy path and the reference's
# numpy path (tests/test_ps_compression.py's case table).
# ---------------------------------------------------------------------------
WIRE_CONFIGS = [
    {"compressor": "onebit"},
    {"compressor": "onebit", "onebit_scaling": "0"},
    {"compressor": "onebit", "ef": "vanilla"},
    {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov",
     "momentum_mu": "0.9"},
    {"compressor": "topk", "k": "32", "ef": "vanilla"},
    {"compressor": "randomk", "k": "32", "seed": "7"},
    {"compressor": "dithering", "k": "15"},
    {"compressor": "dithering", "k": "15", "coding": "elias"},
    {"compressor": "dithering", "k": "7", "partition": "natural",
     "normalize": "l2", "coding": "elias", "ef": "vanilla"},
    {"compressor": "qblock", "bits": "8", "block": "256", "ef": "vanilla"},
    {"compressor": "qblock", "bits": "4", "block": "64", "ef": "vanilla",
     "momentum": "nesterov"},
]


def _cases():
    rng = np.random.default_rng(7)
    cases = []
    for n in (1, 7, 255, 2048, 65537):
        x = (rng.standard_normal(n) * 0.01).astype(np.float32)
        cases.append(x)
        cases.append(np.where(rng.random(n) < 0.002, x, 0.0).astype(
            np.float32))
    bad = (rng.standard_normal(1024) * 0.01).astype(np.float32)
    bad[::100] = np.inf
    bad[::173] = np.nan
    cases.append(bad)
    cases.append(np.full(17, np.inf, np.float32))
    return cases


def _run(mod, kwargs, x):
    wc = mod.WireCompressor(kwargs)
    blobs = [wc.encode(3, x), wc.encode(3, x)]
    return (blobs, {k: v.copy() for k, v in wc._err.items()},
            {k: v.copy() for k, v in wc._mom.items()})


def _same_state(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=str(what))


@pytest.fixture
def wire_paths(monkeypatch):
    """Yields set_c(bool) to switch the port's wire between its C and
    numpy paths; the reference's stays numpy."""
    monkeypatch.setattr(rwire, "_CWIRE", None)
    monkeypatch.setattr(wire, "_CWIRE", False)
    assert wire.native_codec()
    lib = wire._c_wire()

    def set_c(on):
        wire._CWIRE = lib if on else None
    yield set_c


@pytest.mark.parametrize("kwargs", WIRE_CONFIGS,
                         ids=lambda kw: ",".join(f"{k}={v}" for k, v in
                                                 sorted(kw.items())))
def test_wire_bytes_state_and_decode_match(wire_paths, kwargs):
    for x in _cases():
        what = (kwargs, x.size)
        wire_paths(False)
        blobs_p, err_p, mom_p = _run(wire, kwargs, x)
        blobs_r, err_r, mom_r = _run(rwire, kwargs, x)
        assert blobs_p == blobs_r, what
        _same_state(err_p, err_r, what)
        _same_state(mom_p, mom_r, what)
        if kwargs["compressor"] == "qblock" and not np.isfinite(x).all():
            # qblock's two paths part on non-finite input (NaN cast to
            # int8 is undefined); the reference holds them on finite input.
            continue
        wire_paths(True)
        blobs_c, err_c, mom_c = _run(wire, kwargs, x)
        assert blobs_c == blobs_p, what
        _same_state(err_c, err_p, what)
        _same_state(mom_c, mom_p, what)
        got = wire.decode(blobs_c[1], x.size)
        np.testing.assert_array_equal(got, wire._decode_py(blobs_c[1],
                                                           x.size))
        np.testing.assert_array_equal(got, rwire._decode_py(blobs_c[1],
                                                            x.size))
        out = np.empty(x.size, np.float32)
        assert wire.decode(bytearray(blobs_c[1]), x.size, out=out) is out
        np.testing.assert_array_equal(out, got)


def test_wire_truncated_payload_raises(wire_paths):
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    for kwargs in WIRE_CONFIGS:
        wire_paths(True)
        blob = wire.WireCompressor(kwargs).encode(0, x)
        with pytest.raises(ValueError):
            wire.decode(blob[:len(blob) // 2], x.size)
        with pytest.raises(ValueError, match="wire n="):
            wire.decode(blob, x.size + 1)


def test_wire_caps_lr_scale_and_kwargs(wire_paths):
    x = np.random.default_rng(4).standard_normal(5000).astype(np.float32)
    for kwargs in WIRE_CONFIGS:
        mine, ref = wire.WireCompressor(kwargs), rwire.WireCompressor(kwargs)
        assert mine.kwargs_string() == ref.kwargs_string()
        for n in (1, 255, 4096, 1 << 20):
            assert mine.wire_cap_bytes(n) == ref.wire_cap_bytes(n)
        for on in (True, False):
            wire_paths(on)
            assert len(mine.encode(1, x)) <= mine.wire_cap_bytes(x.size)
        ref.encode(1, x)
        ref.encode(1, x)
        mine.set_lr_scale(0.5)
        ref.set_lr_scale(0.5)
        _same_state(mine._err, ref._err, kwargs)
        assert mine.ef_residual_norm() == ref.ef_residual_norm()
        taken = mine.take_ef_state()
        assert mine._err == {} and sorted(taken) == sorted(ref._err)
        mine.adopt_ef_state(taken)
        mine.adopt_ef_state(taken)
        for k, e in ref._err.items():
            np.testing.assert_array_equal(mine._err[k], e + e)
    for bad in ({"compressor": "nope"}, {"compressor": "topk"},
                {"compressor": "qblock", "bits": "3"},
                {"compressor": "dithering", "coding": "huffman"}):
        with pytest.raises(ValueError) as mine_err:
            wire.WireCompressor(bad)
        with pytest.raises(ValueError) as ref_err:
            rwire.WireCompressor(bad)
        assert str(mine_err.value) == str(ref_err.value)


def test_sparse_index_and_block_codecs():
    rng = np.random.default_rng(5)
    for idx in (np.zeros(0, np.uint32), np.array([0], np.uint32),
                np.arange(0, 3000, 3, dtype=np.uint32),
                np.unique(rng.integers(0, 1 << 30, 200)).astype(np.uint32)):
        assert wire.encode_sparse_indices(idx) == \
            rwire.encode_sparse_indices(idx)
        codec, data = wire.encode_sparse_indices(idx)
        np.testing.assert_array_equal(
            wire.decode_sparse_indices(codec, data, idx.size), idx)
        rows = rng.standard_normal((idx.size, 3)).astype(np.float32)
        for r in (rows, None):
            blob = wire.encode_sparse_block(idx, r, 3)
            assert blob == rwire.encode_sparse_block(idx, r, 3)
            got_idx, got_rows = wire.decode_sparse_block(blob)
            np.testing.assert_array_equal(got_idx, idx)
            if r is None:
                assert got_rows is None
            else:
                np.testing.assert_array_equal(got_rows, r)
        resp = np.uint64(9).tobytes() + rows.tobytes()
        v, got = wire.decode_sparse_response(resp, idx.size, 3)
        assert v == 9
        np.testing.assert_array_equal(got, rows)
    with pytest.raises(ValueError, match="sorted and unique"):
        wire.encode_sparse_indices(np.array([3, 3], np.uint32))
    with pytest.raises(ValueError, match="sparse response"):
        wire.decode_sparse_response(b"\0" * 8, 2, 3)


def test_wire_matches_the_torch_compressors(wire_paths):
    """The wire's reconstructions equal the port's collective-plane
    compressors' on the same input (one compression semantics across both
    planes)."""
    from byteps_tpu_torch.ops.compressor.onebit import OnebitCompressor
    from byteps_tpu_torch.ops.compressor.topk import TopkCompressor
    x = np.random.RandomState(1).randn(1000).astype(np.float32)
    for on in (True, False):
        wire_paths(on)
        got = wire.decode(wire.WireCompressor(
            {"compressor": "onebit"}).encode(0, x), x.size)
        oc = OnebitCompressor(scaled=True)
        payload, _ = oc.compress(torch.from_numpy(x), ())
        np.testing.assert_allclose(got, oc.decompress(payload, x.size)
                                   .numpy(), rtol=1e-6)
        got = wire.decode(wire.WireCompressor(
            {"compressor": "topk", "k": "32"}).encode(0, x), x.size)
        tc = TopkCompressor(k=32)
        payload, _ = tc.compress(torch.from_numpy(x), ())
        np.testing.assert_array_equal(got, tc.decompress(payload, x.size)
                                      .numpy())
        assert (got != 0).sum() == 32


# ---------------------------------------------------------------------------
# Ring: the port's Python ring against the library's bps_ring_owner
# (tests/test_server_elastic.py's law).
# ---------------------------------------------------------------------------
def test_ring_owner_matches_the_library():
    c = native.get_native_core()
    for ids in ([0, 1], [0, 1, 2], [0, 2, 7], [3]):
        for vnodes in (64, 7):
            pts = ring.build_points(ids, vnodes)
            table = ring.RingTable([(i, "h", 1) for i in ids], vnodes)
            for k in range(2000):
                key = ring.splitmix64(k) ^ (k << 16)
                want = c.ring_owner(key, ids, vnodes)
                assert ring.owner_of(key, pts) == want, (ids, key)
                assert table.owner(key) == want
                assert rring.owner_of(key, rring.build_points(
                    ids, vnodes)) == want
    assert c.ring_owner(1, [], 64) == -1
