"""bpslaunch for the port: runs this host's worker.

Counterpart of ``byteps_tpu/launcher/launch.py``, dispatching on
``DMLC_ROLE`` with the same environment.  A worker runs the training
command once, with ``BYTEPS_LOCAL_RANK``/``BYTEPS_LOCAL_SIZE`` defaulted to
0 and 1 (one process per card: a host with several cards runs one launch
per card, each with its own ``DMLC_WORKER_ID`` and ``BYTEPS_LOCAL_RANK``).
The workers meet in ``torch.distributed``'s TCP rendezvous at
``DMLC_PS_ROOT_URI:DMLC_PS_ROOT_PORT``, which worker 0 serves, so no
scheduler process is needed.  The server, scheduler and joint roles start
the PS tier, which is not ported: they raise ``NotImplementedError``
(ROADMAP.md Queue 1 item 6).

Usage:  DMLC_ROLE=worker python -m byteps_tpu_torch.launcher.launch \\
            python train.py ...
"""

from __future__ import annotations

import os
import subprocess
import sys
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
    raise NotImplementedError(
        f"DMLC_ROLE={role} starts the PS tier, which is not ported to "
        f"byteps_tpu_torch yet (ROADMAP.md Queue 1 item 6)")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    role = os.environ.get("DMLC_ROLE", "worker").lower()
    if role in ("server", "scheduler", "joint"):
        server_command(role)
    if not argv:
        print("bpslaunch: no training command given", file=sys.stderr)
        return 2
    return subprocess.call(worker_command(argv), env=build_worker_env())


if __name__ == "__main__":
    sys.exit(main())
