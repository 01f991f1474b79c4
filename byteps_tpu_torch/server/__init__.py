"""PS server tier.

Counterpart of ``byteps_tpu/server/__init__.py``.  ``python -m
byteps_tpu_torch.server`` starts the native KV server of the port's own
library (``core/build.py``), mirroring the reference's ``import
byteps.server`` entry that dlopens the C++ library and calls
``byteps_server()`` (reference: byteps/server/__init__.py:21-27,
server.cc:450-523).  Configuration comes from the reference's environment
variables (DMLC_PS_ROOT_PORT, DMLC_NUM_WORKER, DMLC_SERVER_ID,
BYTEPS_SERVER_ENGINE_THREAD, BYTEPS_SERVER_ENABLE_SCHEDULE,
BYTEPS_ENABLE_ASYNC — reference: server.cc:416-448).

The worker side of the tier here is its base: the wire codec
(``wire.py``) and the codec pool (``codec_pool.py``).
"""

from __future__ import annotations

import ctypes
import os


def serve(port: int | None = None, num_workers: int | None = None,
          engine_threads: int | None = None, schedule: bool | None = None,
          async_mode: bool | None = None) -> int:
    """Run the native PS server (blocking).  Returns its exit code —
    except under a sanitizer (BYTEPS_TPU_TSAN=1 / BYTEPS_TPU_ASAN=1),
    where this call never returns: the server runs as a standalone
    sanitized binary (sanitizer runtimes cannot be dlopen'd into an
    interpreter) and os.execv replaces the calling process with it, so
    the binary's exit code becomes the process's.
    """
    from ..common.config import get_config
    from ..core import build
    cfg = get_config(refresh=True)
    # Single-host port convention: server i listens on
    # scheduler_port + 1 + i (the scheduler port itself is reserved for
    # the workers' rendezvous).  DMLC_SERVER_ID selects i.
    server_id = int(os.environ.get("DMLC_SERVER_ID", "0"))
    default_port = cfg.scheduler_port + 1 + server_id
    args = (
        int(port if port is not None else default_port),
        int(num_workers if num_workers is not None else cfg.num_worker),
        int(engine_threads if engine_threads is not None
            else cfg.server_engine_threads),
        int(schedule if schedule is not None else cfg.server_enable_schedule),
        int(async_mode if async_mode is not None else cfg.enable_async),
    )
    if build.sanitized():
        # exec, don't spawn: a child would outlive a supervisor killed by
        # SIGTERM (holding its stderr pipe open), and signals would not
        # reach the server.
        exe = build.build_server_exe()
        os.execv(exe, [exe] + [str(a) for a in args])
    lib = ctypes.CDLL(build.build())
    lib.bps_ps_server_run.argtypes = [ctypes.c_int] * 5
    lib.bps_ps_server_run.restype = ctypes.c_int
    return lib.bps_ps_server_run(*args)
