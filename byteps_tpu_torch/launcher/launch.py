"""bpslaunch for the port: runs this host's worker, server or scheduler.

Counterpart of ``byteps_tpu/launcher/launch.py``, dispatching on
``DMLC_ROLE`` with the same environment.  A worker runs the training
command once, with ``BYTEPS_LOCAL_RANK``/``BYTEPS_LOCAL_SIZE`` defaulted to
0 and 1 (one process per card: a host with several cards runs one launch
per card, each with its own ``DMLC_WORKER_ID`` and ``BYTEPS_LOCAL_RANK``).
Outside PS mode the workers meet in ``torch.distributed``'s TCP
rendezvous at ``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``, which worker 0
serves, so no scheduler process is needed.

The server role runs the port's native PS server (``python -m
byteps_tpu_torch.server``, on ``DMLC_PS_ROOT_PORT + 1 + DMLC_SERVER_ID``),
the scheduler role the same server on the root port itself
(``DMLC_SERVER_ID=-1``), and the joint role a server beside the worker,
terminated when the worker's command exits; the worker starts once the
server accepts connections (at most 30 s) and runs with
``DMLC_ROLE=worker``.  PS-mode workers
(``BYTEPS_TPU_PS_MODE=1``) reach the servers and meet at server 0's
barrier.

Usage:  DMLC_ROLE=worker python -m byteps_tpu_torch.launcher.launch \\
            python train.py ...
        DMLC_ROLE=server python -m byteps_tpu_torch.launcher.launch
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional


def build_worker_env(env: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """Environment of the worker training process."""
    e = dict(os.environ if env is None else env)
    e.setdefault("BYTEPS_LOCAL_RANK", "0")
    e.setdefault("BYTEPS_LOCAL_SIZE", "1")
    return e


def worker_command(argv: List[str],
                   env: Optional[Dict[str, str]] = None) -> List[str]:
    """The worker's command, under gdb when BYTEPS_ENABLE_GDB=1."""
    e = os.environ if env is None else env
    if e.get("BYTEPS_ENABLE_GDB", "0") == "1":
        return ["gdb", "-ex", "run", "-ex", "bt", "-batch", "--args"] + argv
    return list(argv)


def server_command(role: str) -> List[str]:
    """The PS tier's command: the scheduler runs the server on the root
    port (``serve(port=None)`` under ``DMLC_SERVER_ID=-1``)."""
    if role == "scheduler":
        return [sys.executable, "-c",
                "import byteps_tpu_torch.server as s; s.serve(port=None)"]
    return [sys.executable, "-m", "byteps_tpu_torch.server"]


def _server_port(env: Dict[str, str]) -> int:
    """The port ``serve()`` binds: root port + 1 + DMLC_SERVER_ID."""
    return (int(env.get("DMLC_PS_ROOT_PORT") or 9000) + 1
            + int(env.get("DMLC_SERVER_ID") or 0))


def _wait_listening(proc: subprocess.Popen, port: int,
                    timeout: float = 30.0) -> None:
    """Wait (at most ``timeout`` s) until this host's server accepts
    connections, so that the worker beside it does not dial a port
    nobody listens on yet; the worker's own dial reports a server that
    never came up."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            return
        except OSError:
            time.sleep(0.05)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    role = os.environ.get("DMLC_ROLE", "worker").lower()
    procs = []
    if role in ("server", "scheduler", "joint"):
        env = dict(os.environ)
        if role == "scheduler":
            env["DMLC_SERVER_ID"] = "-1"  # port = root_port + 1 + (-1)
        cmd = server_command(role)
        if role != "joint":
            return subprocess.call(cmd, env=env)
        procs.append(subprocess.Popen(cmd, env=env))
        _wait_listening(procs[-1], _server_port(env))
    if not argv:
        print("bpslaunch: no training command given", file=sys.stderr)
        rc = 2
    else:
        env = build_worker_env()
        env["DMLC_ROLE"] = "worker"    # a joint host's worker is a worker
        rc = subprocess.call(worker_command(argv), env=env)
    for p in procs:
        p.terminate()
        p.wait()
    return rc


if __name__ == "__main__":
    sys.exit(main())
