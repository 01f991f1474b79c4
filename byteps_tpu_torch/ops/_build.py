"""Build and load the package's CUDA kernels.

The sources under ``byteps_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface and loaded with
``ctypes``; no PyTorch header is compiled, which keeps a build to seconds.
A library is built at its first use into ``build/byteps_tpu_torch/`` at the
root of the checkout, named by a hash of its source, so an edited source is
rebuilt and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
# nvcc's output of each build (ptxas register and shared-memory report).
build_logs: Dict[str, str] = {}


BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "byteps_tpu_torch")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return "/usr/local/cuda/bin/nvcc"


def _source_hash(path: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(ARCH_FLAGS).encode())
    with open(path, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:16]


def build(source: str) -> str:
    """Compile ``csrc/<source>`` (if not built yet) and return the .so path.

    Raises RuntimeError with nvcc's output when the compile fails."""
    src = os.path.join(CSRC_DIR, source)
    stem = os.path.splitext(source)[0]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"lib{stem}_{_source_hash(src)}.so")
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", CSRC_DIR,
           "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_logs[source] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) for {source}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built at first use."""
    with _lock:
        if source not in _libs:
            _libs[source] = ctypes.CDLL(build(source))
        return _libs[source]
