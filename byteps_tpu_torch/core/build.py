"""Build the native host core (``libbyteps_core_<hash>.so``).

``core.cc`` and ``server.cc`` beside this file are byte-identical copies
of ``byteps_tpu/core/``'s (a test holds their SHA-256 equal), so the PS
wire, the placement hashes and the ring are the reference's by
construction, and the port reads no file of the JAX package at run time.

The library is built with g++ at its first use into
``build/byteps_tpu_torch/`` at the root of the checkout, named by a hash
of the sources and the flags, so edited sources or flags build anew and
an unchanged build is reused.  The compiler writes a temporary file that
``os.replace`` puts in place while an ``fcntl`` lock is held: processes
that build at once (a parallel test run) compile once, and none loads a
half-written library.

Sanitizer variants, as in the reference: ``BYTEPS_TPU_TSAN=1`` builds
ThreadSanitizer, ``BYTEPS_TPU_ASAN=1`` AddressSanitizer + UBSan.  They
apply only to the standalone PS server binary (``build_server_exe``;
``server.serve()`` execs it): a sanitizer runtime cannot be dlopen'd
into a running interpreter, so the ctypes-loaded library is always the
plain build.

    python -m byteps_tpu_torch.core.build [--force]
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import subprocess
import sys
import threading
import time
from typing import List, Optional

_CORE_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("core.cc", "server.cc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_CORE_DIR)),
                         "build", "byteps_tpu_torch")

# -O3: the wire codec's inner loops (onebit expand, dense level gather)
# vectorize only at -O3.  -ffp-contract=off: the codec's byte- and
# EF-state parity with the numpy paths needs numpy's two roundings for
# mu*m + x, which -O3 may otherwise contract to one fused multiply-add.
# -include memory: server.cc calls std::atomic_load_explicit and
# std::atomic_store_explicit on shared_ptr (its ring tables) without
# including <memory>, which libstdc++ 12 no longer pulls in through the
# headers it does include; the sources stay byte-identical copies, so
# the header comes in by a flag.
CXX_FLAGS = ["-O3", "-ffp-contract=off", "-std=c++17", "-pthread",
             "-include", "memory"]
LIB_FLAGS = ["-shared", "-fPIC", "-fvisibility=hidden"]

# env var -> (-fsanitize value, artifact suffix)
_SANITIZERS = (
    ("BYTEPS_TPU_TSAN", "thread", "_tsan"),
    ("BYTEPS_TPU_ASAN", "address,undefined", "_asan"),
)

_lock = threading.Lock()
# Seconds the last compile of this process took (None: nothing compiled).
last_build_seconds: Optional[float] = None


def _sanitizer():
    """(fsanitize_value, suffix) for the first enabled sanitizer, else
    (None, "")."""
    for env, value, suffix in _SANITIZERS:
        if os.environ.get(env, "0") == "1":
            return value, suffix
    return None, ""


def sanitized() -> bool:
    """True when a sanitizer variant is selected (the server must exec the
    standalone binary)."""
    return _sanitizer()[0] is not None


def _san_flags() -> List[str]:
    value, _ = _sanitizer()
    if value is None:
        return []
    flags = ["-g", f"-fsanitize={value}"]
    if "address" in value:
        flags.append("-fno-omit-frame-pointer")
    if "undefined" in value:
        # UBSan reports are recoverable by default: the binary would print
        # and run on, and a server whose stderr is discarded would hide the
        # finding.  Make undefined behaviour abort.
        flags.append("-fno-sanitize-recover=undefined")
    return flags


def _digest(flags: List[str], sources) -> str:
    h = hashlib.sha256()
    h.update(" ".join(flags).encode())
    for src in sources:
        with open(os.path.join(_CORE_DIR, src), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path() -> str:
    """Where the plain library of these sources and flags lives."""
    flags = CXX_FLAGS + LIB_FLAGS
    return os.path.join(BUILD_DIR,
                        f"libbyteps_core_{_digest(flags, _SOURCES)}.so")


def exe_path() -> str:
    """Where the standalone server binary of the selected variant lives."""
    _, suffix = _sanitizer()
    flags = _san_flags() + CXX_FLAGS + ["-DBPS_SERVER_MAIN"]
    return os.path.join(BUILD_DIR, f"bps_ps_server_"
                        f"{_digest(flags, ('server.cc',))}{suffix}")


@contextlib.contextmanager
def _locked(path: str):
    """Hold this thread's lock and an exclusive ``fcntl`` lock beside
    ``path`` (other processes building the same file wait on it)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with _lock, open(path + ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _compile(out: str, args: List[str], verbose: bool) -> None:
    global last_build_seconds
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *args, "-o", tmp]
    if verbose:
        print(" ".join(cmd), file=sys.stderr)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:                  # no compiler on this host
        raise RuntimeError(f"{cmd[0]} could not run: {e}") from e
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(tmp)
        raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    last_build_seconds = time.perf_counter() - t0


def build(force: bool = False, verbose: bool = False) -> str:
    """Compile the native core if it is not built yet; returns the .so
    path.  Raises RuntimeError with the compiler's output on failure."""
    out = lib_path()
    if not force and os.path.exists(out):
        return out
    with _locked(out):
        if force or not os.path.exists(out):
            srcs = [os.path.join(_CORE_DIR, s) for s in _SOURCES]
            _compile(out, [*CXX_FLAGS, *LIB_FLAGS, *srcs], verbose)
    return out


def build_server_exe(force: bool = False) -> str:
    """The standalone PS-server binary (required under sanitizers, usable
    generally)."""
    out = exe_path()
    if not force and os.path.exists(out):
        return out
    with _locked(out):
        if force or not os.path.exists(out):
            _compile(out, [*_san_flags(), *CXX_FLAGS, "-DBPS_SERVER_MAIN",
                           os.path.join(_CORE_DIR, "server.cc")], False)
    return out


if __name__ == "__main__":
    print(build(force="--force" in sys.argv, verbose=True))
