"""The port's row-sparse embedding table (``byteps_tpu_torch/parallel/
embedding.py``) and ``push_pull_sparse``, mirroring tests/
test_sparse_embedding.py on the port's server.

  - sparse equals dense when every row is touched (two workers);
  - the servers' row-wise Adagrad and Adam at 1% density equal a float32
    replay of ``EmbedUpdateStage`` (core/server.cc) and the reference's
    ``EmbeddingTable`` bit for bit; Adam also equals optax.  Adagrad does
    not: optax takes ``lax.rsqrt`` where the server takes ``1 /
    std::sqrt`` (two roundings); the same replay with XLA's rsqrt in that
    one place equals optax bit for bit (the reference's own ``[adagrad]``
    case is red for this);
  - wire bytes at 1% density within 5% of the dense round's, a warm lookup
    with no wire frame, a pull-only reader that never stalls a round and
    sees monotone versions, a table sharded across two servers, a reader
    riding a ring drain;
  - ``push_pull_sparse`` through the API in PS mode, and refused outside.
"""

import struct
import threading
import uuid

import numpy as np
import pytest
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.common import api
from byteps_tpu_torch.core.native import get_native_core
from byteps_tpu_torch.parallel.embedding import EmbeddingTable
from byteps_tpu_torch.server import wire
from byteps_tpu_torch.server.client import (CMD_HELLO, CMD_INIT, CMD_PULL,
                                            CMD_PUSH, DT_SPARSE,
                                            DT_SPARSE_READ, PSSession)

from testutil import StubPSServer
from torch_port_ps import port_server, reference_client  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)


def _session(ports, wid=0, **kw):
    kw.setdefault("wire_conns", 1)
    kw.setdefault("compress_threads", 0)
    return PSSession(["127.0.0.1"] * len(ports), list(ports),
                     worker_id=wid, num_servers=len(ports), **kw)


def _name(tag):
    """A table name no earlier test of this process declared."""
    return f"{tag}.{uuid.uuid4().hex[:8]}"


# ---------------------------------------------------------------------------
# sparse == dense when every row is touched
# ---------------------------------------------------------------------------
def test_sparse_matches_dense_when_all_rows_touched(port_server):
    rows, width, rounds, nw = 64, 8, 3, 2
    port = port_server(num_workers=nw)
    name = _name("dense")

    def grad(wid, rnd):
        rng = np.random.RandomState(1000 + 31 * wid + rnd)
        return (rng.randn(rows, width) * 3).astype(np.float32)

    results = {}

    def worker(wid):
        s = _session([port], wid=wid)
        try:
            t = EmbeddingTable(s, rows, width, name=name)
            idx = torch.arange(rows)
            dense, sparse = [], []
            for rnd in range(rounds):
                g = grad(wid, rnd)
                dense.append(np.asarray(s.push_pull(11, g.ravel().copy()),
                                        np.float32).reshape(rows, width))
                sparse.append(t.push_pull(idx, torch.from_numpy(g)))
            results[wid] = (dense, sparse)
        finally:
            s.close()

    ts = [threading.Thread(target=worker, args=(w,)) for w in range(nw)]
    [t.start() for t in ts]
    for t in ts:
        t.join(timeout=120)
        assert not t.is_alive()
    for wid, (dense, sparse) in results.items():
        for rnd in range(rounds):
            assert sparse[rnd].dtype == np.float32
            np.testing.assert_array_equal(dense[rnd],
                                          grad(0, rnd) + grad(1, rnd))
            np.testing.assert_array_equal(sparse[rnd], dense[rnd])


# ---------------------------------------------------------------------------
# The row-wise optimizer at 1% density
# ---------------------------------------------------------------------------
def _coalesce(idx, g):
    """The client's wire form: unique rows, duplicates summed in order."""
    uniq, inv = np.unique(idx, return_inverse=True)
    acc = np.zeros((uniq.size, g.shape[1]), np.float32)
    np.add.at(acc, inv, g)
    return uniq, acc


class _Replay:
    """``EmbedUpdateStage`` in float32 numpy, row by row."""

    def __init__(self, table, kw, rsqrt=None):
        self.rsqrt = rsqrt or (lambda x: np.float32(1.0) / np.sqrt(x))
        self.p = table.copy()
        self.kind = kw["opt"]
        self.nlr = np.float32(-1.0 * kw["lr"])
        self.steps = np.zeros(len(table), np.int64)
        if self.kind == "adagrad":
            self.eps = np.float32(kw.get("eps", 1e-7))
            self.v = np.full(table.shape, np.float32(kw.get("acc0", 0.1)),
                             np.float32)
        else:
            from byteps_tpu_torch.parallel.server_opt import int_pow_f32
            self.pow = int_pow_f32
            self.b1, self.b2 = np.float32(0.9), np.float32(0.999)
            self.eps = np.float32(1e-8)
            self.m = np.zeros(table.shape, np.float32)
            self.v = np.zeros(table.shape, np.float32)

    def step(self, rows, g):
        for r, gi in zip(rows, g):
            p = self.p[r]
            if self.kind == "adagrad":
                s = self.v[r] + gi * gi
                self.v[r] = s
                scale = np.where(s > 0, self.rsqrt(s + self.eps),
                                 np.float32(0.0)).astype(np.float32)
                self.p[r] = p + self.nlr * (scale * gi)
            else:
                t = self.steps[r] + 1
                bc1 = np.float32(1.0) - self.pow(self.b1, t)
                bc2 = np.float32(1.0) - self.pow(self.b2, t)
                m = np.float32(1 - 0.9) * gi + self.b1 * self.m[r]
                v = np.float32(1 - 0.999) * (gi * gi) + self.b2 * self.v[r]
                self.m[r], self.v[r] = m, v
                self.p[r] = p + self.nlr * ((m / bc1)
                                            / (np.sqrt(v / bc2) + self.eps))
            self.steps[r] += 1


@pytest.mark.parametrize("kw", [{"opt": "adagrad", "lr": 0.5},
                                {"opt": "adam", "lr": 0.01}],
                         ids=["adagrad", "adam"])
def test_rowwise_opt_matches_replay_and_reference_at_1pct_density(
        kw, port_server, reference_client):
    import jax
    import jax.numpy as jnp
    import optax
    from byteps_tpu.parallel.embedding import EmbeddingTable as RTable

    rows, width = 400, 16
    rng = np.random.RandomState(42)
    table0 = rng.randn(rows, width).astype(np.float32)
    batches = [rng.choice(rows, size=5, replace=True) for _ in range(3)]
    batches = [np.concatenate([b, b[:1]]) for b in batches]   # duplicates
    grads = [rng.randn(b.size, width).astype(np.float32) for b in batches]
    outs = {}
    for side in ("port", "ref"):
        if side == "port":
            s = _session([port_server()])
            t = EmbeddingTable(s, rows, width, name=_name("opt"),
                               opt_kwargs=kw, init=torch.from_numpy(table0))
            conv = torch.from_numpy
        else:
            s = reference_client.PSSession(["127.0.0.1"], [port_server()],
                                           worker_id=0, num_servers=1,
                                           wire_conns=1)
            t = RTable(s, rows, width, name="opt", opt_kwargs=kw,
                       init=table0)
            conv = np.asarray
        try:
            outs[side] = [t.push_pull(conv(b), conv(g))
                          for b, g in zip(batches, grads)]
            outs[side].append(t.lookup(conv(np.arange(rows))))
        finally:
            s.close()
    replay = _Replay(table0, kw)

    def xla_rsqrt(x):
        with jax.disable_jit():
            return np.asarray(jax.lax.rsqrt(jnp.asarray(x)))
    replay_rsqrt = _Replay(table0, kw, rsqrt=xla_rsqrt)
    tx = optax.adagrad(kw["lr"]) if kw["opt"] == "adagrad" \
        else optax.adam(kw["lr"])
    params, states = table0.copy(), {}
    for rnd, (b, g) in enumerate(zip(batches, grads)):
        uniq, acc = _coalesce(b, g)
        replay.step(uniq, acc)
        replay_rsqrt.step(uniq, acc)
        for r, gr in zip(uniq, acc):
            p = jnp.asarray(params[r])
            st = states.get(r) or tx.init(p)
            with jax.disable_jit():
                u, st = tx.update(jnp.asarray(gr), st, p)
                params[r] = np.asarray(optax.apply_updates(p, u))
            states[r] = st
        got = outs["port"][rnd]
        np.testing.assert_array_equal(got, replay.p[b], err_msg=f"{rnd}")
        np.testing.assert_array_equal(got, outs["ref"][rnd])
        if kw["opt"] == "adam":
            np.testing.assert_array_equal(got, params[b])
        else:
            np.testing.assert_array_equal(replay_rsqrt.p[b], params[b])
    np.testing.assert_array_equal(outs["port"][-1], replay.p)
    untouched = np.setdiff1d(np.arange(rows), np.concatenate(batches))
    np.testing.assert_array_equal(outs["port"][-1][untouched],
                                  table0[untouched])


# ---------------------------------------------------------------------------
# Wire economy and the warm cache, against a recording stub
# ---------------------------------------------------------------------------
def _sparse_stub():
    store, resp_log = {}, []

    def handler(cmd, dt, fl, req_id, wid, key, payload):
        if cmd == CMD_HELLO:
            out = (0, b"\x00\x00")
        elif cmd == CMD_INIT:
            out = (0, struct.pack("<Q", 0))
        elif cmd == CMD_PUSH:
            if dt == DT_SPARSE:
                idx, rows = wire.decode_sparse_block(payload)
                tbl = store.setdefault(("sparse", key), {})
                if rows is not None:
                    for j, r in enumerate(idx):
                        tbl[int(r)] = rows[j]
            else:
                store[key] = bytes(payload)
            out = (0, b"")
        elif cmd == CMD_PULL:
            if dt in (DT_SPARSE, DT_SPARSE_READ):
                idx, _ = wire.decode_sparse_block(payload)
                tbl = store.get(("sparse", key), {})
                width = wire.SPARSE_HDR.unpack_from(payload)[1]
                rows = np.zeros((len(idx), width), np.float32)
                for j, r in enumerate(idx):
                    if int(r) in tbl:
                        rows[j] = tbl[int(r)]
                out = (0, struct.pack("<Q", 1) + rows.tobytes())
            else:
                out = (0, store[key])
        else:
            out = (1, b"")
        resp_log.append((cmd, len(out[1])))
        return out

    return StubPSServer(handler, record_payload=True), resp_log


def test_sparse_wire_bytes_within_5pct_of_dense_at_1pct_density():
    rows, width = 10000, 32

    def run(sparse):
        srv, resp_log = _sparse_stub()
        try:
            s = _session([srv.port], partition_bytes=1 << 22)
            rng = np.random.RandomState(5)
            if sparse:
                t = EmbeddingTable(s, rows, width, name=_name("wire"))
                idx = np.unique(rng.choice(rows, size=rows // 100,
                                           replace=False))
                t.push_pull(idx, rng.randn(idx.size, width))
            else:
                s.push_pull(9, rng.randn(rows * width).astype(np.float32))
            s.close()
            with srv.lock:
                frames = list(zip(srv.frames, srv.payloads))
            req = sum(len(h) + len(p) for (h, c, f), p in frames
                      if c in (CMD_PUSH, CMD_PULL))
            return req + sum(n for c, n in resp_log
                             if c in (CMD_PUSH, CMD_PULL))
        finally:
            srv.close()

    dense, sparse = run(False), run(True)
    assert dense >= rows * width * 4 * 2
    assert sparse <= 0.05 * dense, (sparse, dense)


def test_warm_cache_lookup_is_zero_wire_frames(monkeypatch):
    monkeypatch.setenv("BYTEPS_TPU_SPARSE_CACHE_TTL_MS", "60000")
    srv, _ = _sparse_stub()
    try:
        s = _session([srv.port])
        t = EmbeddingTable(s, 500, 8, name=_name("warm"))
        idx = torch.tensor([7, 3, 499, 3])
        first = t.lookup(idx)
        with srv.lock:
            n_before = len(srv.frames)
        again = t.lookup(idx)
        with srv.lock:
            assert len(srv.frames) == n_before, "warm lookup hit the wire"
        np.testing.assert_array_equal(first, again)
        st = s.embed_cache_stats()
        assert st["hits"] >= 3 and st["rows_cached"] >= 3
        t.lookup(np.array([7, 100]))
        with srv.lock:
            assert len(srv.frames) == n_before + 1
        s.close()
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# Pull-only readers
# ---------------------------------------------------------------------------
def test_pull_only_reader_never_stalls_rounds(port_server):
    port = port_server(num_workers=1)
    s = _session([port])
    r = _session([port], wid=99, pull_only=True)
    name = _name("reader")
    try:
        t = EmbeddingTable(s, 1000, 8, name=name)
        reader = EmbeddingTable(r, 1000, 8, name=name)
        out = t.push_pull([3], np.ones((1, 8), np.float32))
        assert np.allclose(out[0], 1.0)
        got = reader.lookup([3, 5])
        assert np.allclose(got[0], 1.0) and np.allclose(got[1], 0.0)
        out2 = t.push_pull([9], np.full((1, 8), 0.5, np.float32))
        assert np.allclose(out2[0], 0.5)
        with pytest.raises(RuntimeError):
            reader.push_pull([1], np.ones((1, 8), np.float32))
        with pytest.raises(RuntimeError, match="pull-only"):
            EmbeddingTable(r, 1000, 8, name=name,
                           opt_kwargs={"opt": "sgd", "lr": 0.1})
    finally:
        r.close()
        s.close()


def test_pull_only_sees_monotone_param_version(port_server):
    port = port_server()
    s = _session([port])
    r = _session([port], wid=50, pull_only=True)
    name = _name("versions")
    try:
        t = EmbeddingTable(s, 100, 4, name=name)
        reader = EmbeddingTable(r, 100, 4, name=name)
        seen = []
        for rnd in range(4):
            t.push_pull([rnd], np.ones((1, 4), np.float32))
            reader.lookup([rnd])
            seen.append(reader.versions()[0])
        assert all(v is not None for v in seen)
        assert seen == sorted(seen) and seen[-1] > seen[0], seen
    finally:
        r.close()
        s.close()


def test_pull_only_survives_ring_drain_mid_read(port_server, monkeypatch):
    monkeypatch.setenv("BYTEPS_TPU_SPARSE_CACHE_TTL_MS", "0")
    ports = port_server.group(2, extra_env={"BYTEPS_TPU_RING": 1})
    kw = dict(num_servers=2, ring=True, wire_conns=1, compress_threads=0)
    s = PSSession(["127.0.0.1"] * 2, list(ports), worker_id=0, **kw)
    r = PSSession(["127.0.0.1"] * 2, list(ports), worker_id=77,
                  pull_only=True, **kw)
    try:
        rows, width = 300, 8
        rng = np.random.RandomState(2)
        table0 = rng.randn(rows, width).astype(np.float32)
        name = _name("drain")
        t = EmbeddingTable(s, rows, width, name=name, shards=1,
                           opt_kwargs={"opt": "adagrad", "lr": 0.1},
                           init=table0)
        reader = EmbeddingTable(r, rows, width, name=name, shards=1)
        idx = np.arange(0, rows, 7)
        for _ in range(2):
            want = t.push_pull(idx, rng.randn(idx.size, width))
        np.testing.assert_array_equal(reader.lookup(idx), want)
        v_pre = reader.versions()[0]
        pkey = s._embed_pkey(t.keys[0])
        s.drain_server(s._embed_srv(pkey) or 1)
        np.testing.assert_array_equal(reader.lookup(idx), want)
        assert reader.versions()[0] >= v_pre
        want2 = t.push_pull(idx, rng.randn(idx.size, width))
        np.testing.assert_array_equal(reader.lookup(idx), want2)
        assert reader.versions()[0] >= v_pre
    finally:
        r.close()
        s.close()


# ---------------------------------------------------------------------------
# A table sharded across two servers
# ---------------------------------------------------------------------------
def test_embedding_table_shards_across_servers(port_server):
    ports = port_server.group(2)
    s = _session(ports)
    try:
        # The shards' keys decide their servers: declare fillers until
        # the table's two keys (the next two) land on different ones.
        core = get_native_core()
        name = _name("t")

        def srv(k):
            return core.key_to_server(core.encode_key(k, 0), 2, s.hash_fn)
        while srv(core.num_declared()) == srv(core.num_declared() + 1):
            core.declare_tensor(_name("filler"))
        rows, width = 1001, 16
        rng = np.random.RandomState(0)
        init = rng.randn(rows, width).astype(np.float32)
        t = EmbeddingTable(s, rows, width, name=name,
                           opt_kwargs={"opt": "adagrad", "lr": 0.1},
                           init=lambda n, w, sh: init[sh::2])
        assert t.shards == 2 and t.table_bytes == rows * width * 4
        ids = np.array([0, 1, 2, 1000, 999, 500])
        np.testing.assert_array_equal(t.lookup(ids), init[ids])
        out = t.push_pull(ids, np.ones((ids.size, width), np.float32))
        assert not np.array_equal(out, init[ids])
        np.testing.assert_array_equal(t.lookup(ids), out)
        other = np.array([3, 4, 5])
        np.testing.assert_array_equal(t.lookup(other), init[other])
        st = s.server_stats()
        assert st["embed_table_bytes"] == rows * width * 4
        assert st["embed_rows_served"] > 0
        per_srv = [int(d.get("embed_table_bytes", 0))
                   for d in st["servers"].values()]
        assert sum(per_srv) == rows * width * 4
        assert all(b > 0 for b in per_srv)
        assert all(v is not None and v >= 1 for v in t.versions())
        with pytest.raises(IndexError):
            t.lookup([rows])
    finally:
        s.close()


# ---------------------------------------------------------------------------
# push_pull_sparse through the API
# ---------------------------------------------------------------------------
def test_push_pull_sparse_in_ps_mode(port_server, monkeypatch):
    s = _session([port_server()])
    try:
        monkeypatch.setattr(api._state, "initialized", True)
        monkeypatch.setattr(api._state, "ps_session", s)
        name = _name("api")
        s.declare_embedding(bps.declare(name), 50, 4)
        got = bps.push_pull_sparse(name, np.array([2, 7, 2]),
                                   np.ones((3, 4), np.float32))
        np.testing.assert_array_equal(got, [[2] * 4, [1] * 4, [2] * 4])
        assert got.dtype == np.float32
    finally:
        s.close()


def test_push_pull_sparse_outside_ps_mode_raises(monkeypatch):
    monkeypatch.setenv("BYTEPS_TPU_SIGNAL_WINDOW_S", "0")
    bps.init()
    try:
        with pytest.raises(RuntimeError, match="needs PS mode"):
            bps.push_pull_sparse("emb", [0], np.zeros((1, 4), np.float32))
    finally:
        bps.shutdown()
    with pytest.raises(RuntimeError, match="not initialized"):
        bps.push_pull_sparse("emb", [0], np.zeros((1, 4), np.float32))
