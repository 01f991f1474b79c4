"""The port's asynchronous PS training (``byteps_tpu_torch/parallel/
async_ps.py`` and the Horovod face's ``enable_async``) against the JAX
package's.

  - The reference's own cases (tests/test_async_ps.py and the chunked
    dispatch of tests/test_fusion.py) on the port's trainer: a fake async
    session reproducing the client's sequential-use guard and a simulated
    round trip, the pipelined double buffer, the accounting, the sync-
    server refusal, data shards following the membership, and the fused
    chunks against a live port server.
  - The same deltas through the reference's ``AsyncPSTrainer`` and the
    port's against a port server under ``BYTEPS_ENABLE_ASYNC=1``: equal
    client->server frames (keys compared by their declared names) and
    bit-equal final weights.
  - The port face's ``enable_async`` and the reference face's, each in a
    worker subprocess (``tests/torch_port_ps_modes_worker.py``): equal
    frames, bit-equal weights.
"""

import threading
import time

import numpy as np
import pytest
import torch

from byteps_tpu_torch.common import api
from byteps_tpu_torch.common import config as config_mod
from byteps_tpu_torch.core.native import get_native_core
from byteps_tpu_torch.parallel.async_ps import AsyncPSTrainer
from byteps_tpu_torch.server.client import (CMD_INIT, CMD_PULL, CMD_PUSH,
                                            PSSession)

from torch_port_ps import (  # noqa: F401  (fixtures)
    RecordingProxy, port_server, reference_client, run_workers, worker_env)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

RTT = 0.15  # simulated server round-trip seconds
ASYNC = {"BYTEPS_ENABLE_ASYNC": 1}


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


class _FakeHandle:
    def __init__(self):
        self._evt = threading.Event()
        self._value = None

    def resolve(self, value):
        self._value = value
        self._evt.set()

    def wait(self, timeout=30.0):
        if not self._evt.wait(timeout):
            raise TimeoutError("fake handle never resolved")
        return self._value


class _FakeAsyncServerSession:
    """An in-memory async server (store += delta) with a simulated round
    trip and the real client's same-key sequential-use guard."""

    server_async = True

    def __init__(self, rtt: float = RTT):
        self.rtt = rtt
        self.store = None
        self.dispatches = 0
        self._prev = None

    def push_pull_async(self, key, tensor, seed=False, **kw):
        arr = np.asarray(tensor, np.float32)
        h = _FakeHandle()
        if seed:
            if self.store is None:
                self.store = arr.copy()
            h.resolve(self.store.copy())
            return h
        if self._prev is not None:
            self._prev.wait()
        self.dispatches += 1
        self.store = self.store + arr
        t = threading.Timer(self.rtt, h.resolve, args=(self.store.copy(),))
        t.daemon = True
        t.start()
        self._prev = h
        return h


def _train(pipeline: bool, steps: int = 4, compute_s: float = 0.2):
    sess = _FakeAsyncServerSession()
    t = AsyncPSTrainer(sess, {"w": torch.zeros(4)}, name=f"pipe{pipeline}",
                       pipeline=pipeline)
    t0 = time.perf_counter()
    for _ in range(steps):
        w = t.params["w"]
        time.sleep(compute_s)  # the local optimizer step
        t.step({"w": w + 1.0})
    wall = time.perf_counter() - t0
    return wall, t.finalize()["w"], sess


def test_round_trip_overlaps_compute():
    steps, compute = 4, 0.2
    wall_sync, final_sync, _ = _train(False, steps, compute)
    wall_pipe, final_pipe, sess = _train(True, steps, compute)
    for final in (final_sync, final_pipe):
        assert isinstance(final, torch.Tensor)
        np.testing.assert_allclose(final.numpy(), np.full(4, 4.0))
    assert sess.dispatches == steps
    assert wall_sync >= steps * (compute + RTT) - 0.05
    assert wall_pipe <= wall_sync - (steps - 1) * RTT / 2


def test_step_never_waits_on_its_own_round():
    sess = _FakeAsyncServerSession(rtt=0.3)
    t = AsyncPSTrainer(sess, {"w": torch.zeros(2)}, name="own")
    t0 = time.perf_counter()
    t.step({"w": t.params["w"] + 1.0})
    assert time.perf_counter() - t0 < 0.25
    assert not sess._prev._evt.is_set()
    np.testing.assert_allclose(t.finalize()["w"].numpy(), [1.0, 1.0])


def test_pipelined_accounting_never_double_counts():
    sess = _FakeAsyncServerSession(rtt=0.01)
    t = AsyncPSTrainer(sess, {"w": torch.zeros(2)}, name="acct")
    t.step({"w": t.params["w"] + 2.0})
    np.testing.assert_allclose(t.params["w"].numpy(), [2.0, 2.0])
    t.step({"w": t.params["w"] + 3.0})
    np.testing.assert_allclose(t.params["w"].numpy(), [5.0, 5.0])
    np.testing.assert_allclose(t.finalize()["w"].numpy(), [5.0, 5.0])
    np.testing.assert_allclose(sess.store, [5.0, 5.0])


def test_rejects_sync_server_and_hierarchy(monkeypatch):
    class S:
        server_async = False

    with pytest.raises(RuntimeError):
        AsyncPSTrainer(S(), {"w": torch.zeros(2)})
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 6c\)"):
        AsyncPSTrainer(_FakeAsyncServerSession(), {"w": torch.zeros(2)},
                       hierarchy=object())
    monkeypatch.setenv("BYTEPS_TPU_HIERARCHY", "1")
    with pytest.raises(NotImplementedError, match=r"Queue 1 item 6c\)"):
        AsyncPSTrainer(_FakeAsyncServerSession(), {"w": torch.zeros(2)})


def _trainer(wid=1):
    sess = _FakeAsyncServerSession()
    sess.worker_id = wid
    return AsyncPSTrainer(sess, {"w": torch.zeros(2)})


def test_data_shard_follows_membership(monkeypatch):
    monkeypatch.setattr(config_mod, "_config",
                        config_mod.Config(num_worker=4))
    tr = _trainer(wid=2)
    assert tr.data_shard() == (2, 4)
    assert tr.data_shard({"epoch": 0, "alive": [0, 1]}) == (2, 4)
    assert tr.data_shard({"epoch": 3, "alive": [0, 2, 5]}) == (1, 3)
    assert tr.data_shard({"epoch": 4, "alive": [2]}) == (0, 1)
    assert tr.data_shard({"epoch": 5, "alive": [0, 1]}) == (0, 2)


def test_membership_callback_fires_only_on_shard_change(monkeypatch):
    monkeypatch.setattr(config_mod, "_config",
                        config_mod.Config(num_worker=3))
    tr = _trainer(wid=1)
    fired = []
    cb = tr.membership_callback(
        lambda idx, n, m: fired.append((idx, n, m["epoch"])))
    cb({"epoch": 1, "alive": [0, 1, 2]})
    assert fired == []
    cb({"epoch": 2, "alive": [1, 2]})
    assert fired == [(0, 2, 2)]
    cb({"epoch": 2, "alive": [1, 2]})
    assert fired == [(0, 2, 2)]
    cb({"epoch": 3, "alive": [0, 1, 2]})
    assert fired == [(0, 2, 2), (1, 3, 3)]


def test_enable_reshard_registers_with_api(monkeypatch):
    class _Sess:
        worker_id = 0

        def membership(self, timeout=5.0):
            return {"epoch": 0, "workers": {}, "alive": [0], "barrier": {}}

    monkeypatch.setattr(config_mod, "_config",
                        config_mod.Config(num_worker=2))
    monkeypatch.setattr(api._state, "initialized", True)
    monkeypatch.setattr(api._state, "config", config_mod.Config(
        num_worker=2))
    monkeypatch.setattr(api._state, "ps_session", _Sess())
    monkeypatch.setattr(api._state, "membership", None)
    monkeypatch.setattr(api._state, "membership_cb", None)
    tr = _trainer(wid=0)
    fired = []
    try:
        tr.enable_reshard(lambda idx, n, m: fired.append((idx, n)),
                          poll_s=30.0)
        cb = api._state.membership_cb
        assert cb is not None
        cb({"epoch": 2, "alive": [0, 1, 2], "workers": {}})
        assert fired == [(0, 3)]
    finally:
        api.on_membership_change(None)


# ---------------------------------------------------------------------------
# Chunked dispatch (tests/test_fusion.py)
# ---------------------------------------------------------------------------
class _Resolved:
    def __init__(self, value):
        self._value = value

    def done(self):
        return True

    def wait(self, timeout=None):
        return self._value


class _FakeGroupSession:
    server_async = True

    def __init__(self):
        self.store = {}
        self.pushed_priorities = []

    def _apply(self, key, arr, seed):
        arr = np.asarray(arr, np.float32).ravel()
        if seed:
            self.store.setdefault(key, arr.copy())
        else:
            self.store[key] = self.store.get(key, 0) + arr
        return _Resolved(self.store[key].copy())

    def push_pull_async(self, key, tensor, seed=False, **kw):
        return self._apply(key, tensor, seed)

    def push_pull_group(self, items, seed=False, **kw):
        self.pushed_priorities.append([p for _, _, p in items])
        return [self._apply(k, t, seed) for k, t, p in items]


def test_async_trainer_chunks_through_planner():
    params = {"w1": torch.zeros(300), "w2": torch.zeros(70000),
              "b": torch.zeros(10, dtype=torch.bfloat16)}
    sess = _FakeGroupSession()
    t = AsyncPSTrainer(sess, params, name="fused", fusion_bytes=65536)
    assert t._chunks is not None and len(t._chunks) >= 2
    for prios in sess.pushed_priorities:
        assert prios == sorted(prios, reverse=True)
    for _ in range(3):
        t.step({k: v + 1.0 for k, v in t.params.items()})
    final = t.finalize()
    for k, v in params.items():
        assert final[k].dtype == v.dtype and final[k].shape == v.shape
        np.testing.assert_allclose(final[k].float().numpy(),
                                   np.full(v.shape, 3.0))
    t0 = AsyncPSTrainer(_FakeGroupSession(), params, name="solo",
                        fusion_bytes=0)
    assert t0._chunks is None
    for _ in range(3):
        t0.step({k: v + 1.0 for k, v in t0.params.items()})
    for k in params:
        assert torch.equal(t0.finalize()[k], final[k])


def test_async_trainer_fused_against_live_server(port_server):
    port = port_server(num_workers=1, extra_env=ASYNC)
    s = PSSession(["127.0.0.1"], [port], worker_id=0, num_servers=1)
    try:
        params = {"w": torch.zeros(5000), "b": torch.zeros(16)}
        t = AsyncPSTrainer(s, params, name="live", fusion_bytes=8192)
        assert t._chunks is not None
        for _ in range(2):
            t.step({k: v + 2.0 for k, v in t.params.items()})
        final = t.finalize()
        np.testing.assert_allclose(final["w"].numpy(), np.full(5000, 4.0))
        np.testing.assert_allclose(final["b"].numpy(), np.full(16, 4.0))
    finally:
        s.close()


# ---------------------------------------------------------------------------
# The reference's trainer and the port's: same frames, same weights
# ---------------------------------------------------------------------------
def _named(frames, name_of):
    """Frames with each tensor key as (declared name, partition)."""
    keyed = (CMD_INIT, CMD_PUSH, CMD_PULL)
    return [(c, d, f, w, (name_of(k >> 16), k & 0xFFFF) if c in keyed
             else ("", k), p) for c, d, f, w, k, p in frames]


def test_trainer_frames_and_weights_equal_reference(port_server,
                                                    reference_client):
    from byteps_tpu.core import native as rnative
    from byteps_tpu.parallel.async_ps import AsyncPSTrainer as RTrainer
    rng = np.random.RandomState(3)
    init = {"emb": rng.randn(64, 32).astype(np.float32),
            "layers": [{"w": rng.randn(700).astype(np.float32),
                        "b": rng.randn(8).astype(np.float32)}
                       for _ in range(2)]}
    deltas = [rng.randn(64 * 32 + 2 * 708).astype(np.float32) * 0.1
              for _ in range(3)]

    def tree(fn, t):
        return {"emb": fn(t["emb"]),
                "layers": [{k: fn(v) for k, v in d.items()}
                           for d in t["layers"]]}

    def add(delta, leaves, conv):
        out, off = [], 0
        for p in leaves:
            n = int(np.prod(p.shape))
            out.append(p + conv(delta[off:off + n].reshape(p.shape)))
            off += n
        return out

    def flat(params):
        return np.concatenate(
            [np.asarray(params["emb"]).ravel()]
            + [np.asarray(d[k]).ravel() for d in params["layers"]
               for k in sorted(d)])

    recs, finals = {}, {}
    for side in ("ref", "port"):
        proxy = RecordingProxy(port_server(num_workers=1, extra_env=ASYNC))
        try:
            if side == "ref":
                s = reference_client.PSSession(
                    ["127.0.0.1"], [proxy.port], worker_id=0,
                    num_servers=1, wire_conns=1, partition_bytes=4096)
                t = RTrainer(s, tree(np.copy, init), name="twin",
                             declared_key=5, fusion_bytes=4096)
                conv = np.asarray
            else:
                s = PSSession(["127.0.0.1"], [proxy.port], worker_id=0,
                              num_servers=1, wire_conns=1,
                              partition_bytes=4096)
                t = AsyncPSTrainer(s, tree(_t, init), name="twin",
                                   declared_key=5, fusion_bytes=4096)
                conv = _t
            assert t._chunks is not None and len(t._chunks) >= 3
            for d in deltas:
                p = t.params
                lv = [p["emb"]] + [x[k] for x in p["layers"]
                                   for k in sorted(x)]
                new = add(d, lv, conv)
                t.step({"emb": new[0],
                        "layers": [{"b": new[1], "w": new[2]},
                                   {"b": new[3], "w": new[4]}]})
            finals[side] = flat(t.finalize())
            s.close()
            time.sleep(0.2)
            recs[side] = [f for conn in proxy.frames() for f in conn]
        finally:
            proxy.close()
    np.testing.assert_array_equal(finals["port"], finals["ref"])
    ref = _named(recs["ref"], rnative._core.declared_name)
    got = _named(recs["port"], get_native_core().declared_name)
    # Pulls interleave with pushes as the acks come back: the same frames,
    # and per key the same sequence.
    assert sorted(got) == sorted(ref)
    for key in {f[4] for f in got}:
        assert [f for f in got if f[4] == key] == \
            [f for f in ref if f[4] == key], key
    assert sum(f[0] == CMD_PUSH for f in got) >= 4 * 3


# ---------------------------------------------------------------------------
# The Horovod face's enable_async
# ---------------------------------------------------------------------------
def test_face_enable_async_equals_reference(port_server, tmp_path):
    sides = ("ref", "port")
    proxies = {side: RecordingProxy(port) for side, port in
               zip(sides, port_server.many(2, extra_env=ASYNC))}
    try:
        run_workers("face_async", [
            (side, str(tmp_path / f"{side}.npz"),
             worker_env(proxies[side].port)) for side in sides])
        time.sleep(0.2)
        frames = {side: [f for conn in p.frames() for f in conn]
                  for side, p in proxies.items()}
    finally:
        for p in proxies.values():
            p.close()
    weights = {side: np.load(tmp_path / f"{side}.npz")["w"]
               for side in sides}
    assert sorted(frames["port"]) == sorted(frames["ref"])
    np.testing.assert_array_equal(weights["port"], weights["ref"])
    start = torch.nn.Linear(4, 1, bias=False)
    target = np.array([[3.0, -2.0, 0.5, 1.5]])
    assert np.abs(weights["port"] - target).max() < 0.5 * np.abs(
        start.weight.detach().numpy() - target).max() + 1.0


def test_face_enable_async_needs_an_async_server():
    import byteps_tpu_torch.torch as hvd
    m = torch.nn.Linear(2, 1)
    opt = hvd.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                   enable_async=True)
    m(torch.ones(1, 2)).sum().backward()
    with pytest.raises(RuntimeError, match="BYTEPS_ENABLE_ASYNC=1"):
        opt.step()
