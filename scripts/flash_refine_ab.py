#!/usr/bin/env python3
"""What bf16's third term costs the flash backward kernels, on one GPU.

    python3 scripts/flash_refine_ab.py          # on one NVIDIA GPU (H100)

The bf16 backward adds a third 16-bit term to P^T, dS and dS^T wherever a
warp's block holds |P| >= kRefineP or |dS| >= kRefineDs (one warp vote,
then a second product pass; ``byteps_tpu_torch/csrc/flash_attention.cu``).
This builds two variants of that source beside the shipped library:
"2^-3" (kRefineP = 2^-3, the first threshold) and "off" (no vote and no
third term), and times the backward kernels of each at the flagship shape
[128, 512, 64] and the long shape [16, 32768, 64], bf16 causal, in turns
shipped, 2^-3, off, off, 2^-3, shipped (CUDA events, medians).  Prints the
card's name and power limit, and one JSON line of the times.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "2^-3": ("constexpr float kRefineP = 0.03125f;",
             "constexpr float kRefineP = 0.125f;"),
    "off": ("if (warp_any_from(x, from))", "if (false)"),
}


def build_variant(_build, name):
    src = os.path.join(_build.CSRC_DIR, "flash_attention.cu")
    text = open(src).read()
    old, new = VARIANTS[name]
    if old not in text:
        raise RuntimeError(f"variant {name}: {old!r} not in {src}")
    out_dir = os.path.join(ROOT, "build", "scripts")
    os.makedirs(out_dir, exist_ok=True)
    tag = name.replace("^", "").replace("-", "m")
    vsrc = os.path.join(out_dir, f"flash_attention_{tag}.cu")
    with open(vsrc, "w") as f:
        f.write(text.replace(old, new))
    lib = os.path.join(out_dir, f"libflash_{tag}.so")
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-I",
                    _build.CSRC_DIR, "-o", lib, vsrc], check=True)
    return lib


def load(fa, path):
    lib = ctypes.CDLL(path)
    for name, argtypes in fa._SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.bps_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bps_cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_refine_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from byteps_tpu_torch.ops import _build, flash_attention as fa
    with ThreadPoolExecutor(len(VARIANTS) + 1) as pool:
        shipped = pool.submit(fa.build)
        paths = {n: pool.submit(build_variant, _build, n) for n in VARIANTS}
        shipped.result()
        libs = {"shipped": fa._lib(),
                **{n: load(fa, p.result()) for n, p in paths.items()}}
    real = fa._lib
    order = ["shipped", *VARIANTS, *reversed(VARIANTS), "shipped"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    try:
        for (bh, s, d), names, reps in (
                ((128, 512, 64), ("flash_bwd_dq", "flash_bwd_dkv"), (20, 5)),
                ((16, 32768, 64), ("flash_bwd_dq_str", "flash_bwd_dkv_str"),
                 (2, 3))):
            q, k, v, do = (torch.randn(bh, s, d, generator=gen,
                                       device="cuda").to(torch.bfloat16)
                           for _ in range(4))
            sc = d ** -0.5
            fwd = fa.flash_fwd_str if s > 512 else fa.flash_fwd
            o, lse = fwd(q, k, v, True, sc)
            dq_fn, dkv_fn = (getattr(fa, n) for n in names)
            _, delta = dq_fn(q, k, v, o, lse, do, True, sc)
            calls = {names[0]: lambda: dq_fn(q, k, v, o, lse, do, True, sc),
                     names[1]: lambda: dkv_fn(q, k, v, do, lse, delta, True,
                                              sc)}
            times = {n: {var: [] for var in libs} for n in calls}
            for var in order:
                fa._lib = lambda lib=libs[var]: lib
                for n, fn in calls.items():
                    times[n][var].append(cs.time_ms(fn, *reps))
            fa._lib = real
            for n, t in times.items():
                result[f"{n} [{bh},{s},{d}]"] = t
                print(f"{n} [{bh},{s},{d}] bf16 causal: " + ", ".join(
                    f"{var} {[round(x, 4) for x in ts]} ms"
                    for var, ts in t.items()), flush=True)
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
    finally:
        fa._lib = real
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
