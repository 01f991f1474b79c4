"""SSH fan-out launcher for multi-host runs of the port.

Counterpart of ``byteps_tpu/launcher/dist_launcher.py``: read the worker
and server hostfiles, ssh to every host with the right ``DMLC_*``
environment, and stream each log to ``sshlog/``.  Workers run
``python -m byteps_tpu_torch.launcher.launch <command>``.  Without servers,
worker 0's host is the rendezvous (``--scheduler-host``, default the first
worker) and no scheduler process is started.  With ``--num-servers`` > 0
the job runs in PS mode, as the JAX package's does: a scheduler on the
first server host (or ``--scheduler-host``), one server on each of the
first ``--num-servers`` server hosts, and workers with
``BYTEPS_TPU_PS_MODE=1``.
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys
import threading
from typing import Dict, List, Optional


def read_hostfile(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()
                and not ln.startswith("#")]


def role_env(role: str, rank: int, args) -> Dict[str, str]:
    env = {
        "DMLC_ROLE": role,
        "DMLC_PS_ROOT_URI": args.scheduler_host,
        "DMLC_PS_ROOT_PORT": str(args.scheduler_port),
        "DMLC_NUM_WORKER": str(args.num_workers),
        "DMLC_NUM_SERVER": str(args.num_servers),
    }
    if role == "worker":
        env["DMLC_WORKER_ID"] = str(rank)
        if args.num_servers:
            env["BYTEPS_TPU_PS_MODE"] = "1"
    if role == "server":
        env["DMLC_SERVER_ID"] = str(rank)
    return env


def ssh_command(host: str, env: Dict[str, str], cmd: str) -> List[str]:
    exports = " ".join(f"{k}={shlex.quote(v)}" for k, v in env.items())
    return ["ssh", "-o", "StrictHostKeyChecking=no", host,
            f"export {exports}; {cmd}"]


def _stream(proc: subprocess.Popen, logfile: str) -> None:
    with open(logfile, "wb") as f:
        for line in proc.stdout:  # type: ignore[union-attr]
            f.write(line)
            f.flush()


def launch(args, dry_run: bool = False) -> List[List[str]]:
    """Builds (and unless dry_run, starts) every ssh command.
    Returns the command list for inspection/testing."""
    workers = read_hostfile(args.worker_hostfile)[:args.num_workers]
    servers = read_hostfile(args.server_hostfile)[:args.num_servers] \
        if args.num_servers else []
    if not args.scheduler_host:
        args.scheduler_host = (servers or workers)[0]

    cmds = []
    plans = []
    if servers:
        plans.append(("scheduler", 0, args.scheduler_host,
                      "python -m byteps_tpu_torch.launcher.launch"))
    for i, h in enumerate(servers):
        plans.append(("server", i, h,
                      "python -m byteps_tpu_torch.launcher.launch"))
    for i, h in enumerate(workers):
        plans.append(("worker", i, h, "python -m "
                      f"byteps_tpu_torch.launcher.launch {args.command}"))

    os.makedirs(args.log_dir, exist_ok=True)
    threads = []
    for role, rank, host, cmd in plans:
        full = ssh_command(host, role_env(role, rank, args), cmd)
        cmds.append(full)
        if not dry_run:
            p = subprocess.Popen(full, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT)
            t = threading.Thread(
                target=_stream, args=(p, os.path.join(
                    args.log_dir, f"{role}-{rank}-{host}.log")), daemon=True)
            t.start()
            threads.append((p, t))
    for p, t in threads:
        p.wait()
        t.join()
    return cmds


def parse_args(argv: Optional[List[str]] = None):
    ap = argparse.ArgumentParser(
        description="byteps_tpu_torch distributed launcher (ssh fan-out)")
    ap.add_argument("--num-workers", type=int, required=True)
    ap.add_argument("--num-servers", type=int, default=0)
    ap.add_argument("--worker-hostfile", required=True)
    ap.add_argument("--server-hostfile", default="")
    ap.add_argument("--scheduler-host", default="")
    ap.add_argument("--scheduler-port", type=int, default=9000)
    ap.add_argument("--log-dir", default="sshlog")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="training command for workers")
    args = ap.parse_args(argv)
    # Preserve each token through the remote shell (spaces, $, ; ...).
    args.command = " ".join(shlex.quote(t) for t in args.command)
    return args


def main(argv: Optional[List[str]] = None) -> int:
    launch(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
