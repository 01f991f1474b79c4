"""Shared harness of the port's PS tests: the port's server as a
subprocess, a recording TCP proxy, the reference client pinned to its
Python core and numpy wire, and the worker subprocesses of
``tests/torch_port_ps_modes_worker.py`` (``worker_env``, ``run_workers``).

The server is ``python -m byteps_tpu_torch.server``, built from the port's
own copy of the C++ sources (``byteps_tpu_torch/core/build.py``, one build
per source hash under a file lock).  ``free_port()`` is bind-then-close, so
under parallel test processes another one can take the port before the
server binds it: a server that dies at startup is retried on a fresh port,
and each start waits at most 30 s for the listening socket.
"""

import os
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest

from testutil import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# client.py's request header: cmd dtype flags req_id worker_id key len
REQ = struct.Struct("<BBHIIQQ")
WORKER = os.path.join(REPO, "tests", "torch_port_ps_modes_worker.py")


def server_env(port: int, num_workers: int, extra=None) -> dict:
    """The environment of a port server listening on ``port``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BYTEPS_", "DMLC_"))}
    env.update({"PYTHONPATH": REPO,
                "DMLC_PS_ROOT_PORT": str(port - 1),
                "DMLC_NUM_WORKER": str(num_workers),
                "BYTEPS_SERVER_ENGINE_THREAD": "2",
                "BYTEPS_LOG_LEVEL": "ERROR"})
    env.update({k: str(v) for k, v in (extra or {}).items()})
    return env


def wait_listening(port: int, proc=None, timeout: float = 30.0) -> None:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            return
        except OSError:
            if proc is not None and proc.poll() is not None:
                raise RuntimeError(f"server died rc={proc.returncode}")
            time.sleep(0.05)
    raise TimeoutError(f"nothing listening on {port} after {timeout} s")


def wait_closed(port: int, timeout: float = 15.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", port), 0.3).close()
            time.sleep(0.1)
        except OSError:
            return True
    return False


def worker_env(port, wid=0, n=1, ps=True, extra=None):
    """A worker's environment: PS mode against the server on ``port``, or
    (``ps=False``) a process group rooted there."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BYTEPS_", "DMLC_"))}
    env.update({"PYTHONPATH": REPO, "DMLC_NUM_WORKER": str(n),
                "DMLC_WORKER_ID": str(wid), "DMLC_NUM_SERVER": "1",
                "DMLC_PS_ROOT_URI": "127.0.0.1",
                "DMLC_PS_ROOT_PORT": str(port - 1 if ps else port),
                "BYTEPS_LOG_LEVEL": "ERROR",
                "BYTEPS_TPU_SIGNAL_WINDOW_S": "0", "JAX_PLATFORMS": "cpu"})
    if ps:
        env["BYTEPS_TPU_PS_MODE"] = "1"
    env.update({k: str(v) for k, v in (extra or {}).items()})
    return env


def run_workers(mode, jobs, timeout=120):
    """``tests/torch_port_ps_modes_worker.py MODE SIDE OUT`` for each
    (SIDE, OUT, environment) of ``jobs``, side by side; each must exit 0."""
    procs = [subprocess.Popen([sys.executable, WORKER, mode, side, out],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for side, out, env in jobs]
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


@pytest.fixture
def port_server():
    """``start(num_workers=1, extra_env=None) -> port``: a live port
    server; every one started is killed afterwards."""
    from byteps_tpu_torch.core import build
    build.build()        # once per source hash, before any timed wait
    made = []

    def _spawn(num_workers, extra_env):
        port = free_port()
        proc = subprocess.Popen(
            [sys.executable, "-m", "byteps_tpu_torch.server"],
            env=server_env(port, num_workers, extra_env),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        made.append(proc)
        return port, proc

    def start(num_workers=1, extra_env=None):
        last = None
        for _ in range(3):
            try:
                port, proc = _spawn(num_workers, extra_env)
                wait_listening(port, proc)
                return port
            except RuntimeError as e:       # died at startup (bind race)
                last = e
        raise last

    def many(n, num_workers=1, extra_env=None):
        """``n`` independent servers, started side by side."""
        spawned = [_spawn(num_workers, extra_env) for _ in range(n)]
        ports = []
        for port, proc in spawned:
            try:
                wait_listening(port, proc)
                ports.append(port)
            except RuntimeError:
                ports.append(start(num_workers, extra_env))
        return ports

    def _group(n, num_workers, extra_env):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            base = sk.getsockname()[1]
        procs = []
        for i in range(n):
            env = server_env(base, num_workers, {
                "DMLC_NUM_SERVER": n, "DMLC_SERVER_ID": i,
                **(extra_env or {})})
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "byteps_tpu_torch.server"], env=env,
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        made.extend(procs)
        for i, proc in enumerate(procs):
            wait_listening(base + i, proc)
        return [base + i for i in range(n)]

    def group(n, num_workers=1, extra_env=None):
        """``n`` servers on consecutive ports (server i on base + i, the
        launch ring's convention)."""
        last = None
        for _ in range(3):
            try:
                return _group(n, num_workers, extra_env)
            except (RuntimeError, TimeoutError) as e:
                last = e
        raise last

    start.group = group
    start.many = many
    start.procs = made
    yield start
    for p in made:
        p.kill()
        p.wait()


@pytest.fixture
def reference_client(monkeypatch):
    """The JAX package's client on its Python core and numpy wire codec:
    its own native build writes into its package directory."""
    from byteps_tpu.core import native as rnative
    from byteps_tpu.server import client as rclient
    from byteps_tpu.server import wire as rwire
    monkeypatch.setattr(rnative, "_core", rnative._PyCore())
    monkeypatch.setattr(rwire, "_CWIRE", None)
    monkeypatch.setattr(rclient, "_AUDIT_C", None)
    return rclient


class RecordingProxy:
    """A TCP forwarder that keeps every client->server byte, one stream
    per accepted connection, in accept order."""

    def __init__(self, upstream_port: int):
        self.upstream = upstream_port
        self.streams = []          # one bytearray per connection
        self.lock = threading.Lock()
        self._lsock = socket.socket()
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(16)
        self.port = self._lsock.getsockname()[1]
        self._socks = []
        threading.Thread(target=self._accept, daemon=True).start()

    def _accept(self):
        while True:
            try:
                c, _ = self._lsock.accept()
            except OSError:
                return
            u = socket.create_connection(("127.0.0.1", self.upstream))
            for s in (c, u):
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            buf = bytearray()
            with self.lock:
                self.streams.append(buf)
                self._socks += [c, u]
            threading.Thread(target=self._pump, args=(c, u, buf),
                             daemon=True).start()
            threading.Thread(target=self._pump, args=(u, c, None),
                             daemon=True).start()

    def _pump(self, src, dst, buf):
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                if buf is not None:
                    with self.lock:
                        buf += data
                dst.sendall(data)
        except OSError:
            pass
        for s in (src, dst):
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def frames(self):
        """Each connection's frames as (cmd, dtype, flags, worker_id, key,
        payload), the request id left out."""
        out = []
        with self.lock:
            streams = [bytes(b) for b in self.streams]
        for data in streams:
            conn, off = [], 0
            while off + REQ.size <= len(data):
                cmd, dt, fl, _req, wid, key, n = REQ.unpack_from(data, off)
                off += REQ.size
                conn.append((cmd, dt, fl, wid, key, data[off:off + n]))
                off += n
            assert off == len(data), "torn frame in the recording"
            out.append(conn)
        return out

    def close(self):
        self._lsock.close()
        with self.lock:
            socks = list(self._socks)
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
