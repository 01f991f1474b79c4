#!/usr/bin/env python3
"""Time sign_unpack's shipped design beside the ones it was chosen over.

    python3 scripts/sign_unpack_sweep.py        # on one NVIDIA GPU (H100)

The shipped kernel (``byteps_tpu_torch/csrc/bitpack.cu``: 16-byte word
loads, one float4 store per row, 8 rows a thread, "r8") runs through its
wrapper ``unpack_signs``; the others are built from
``scripts/sign_unpack_variants.cu``: "word" (one thread a word, 32 scalar
stores: the first design), "r1", "r2", "r4" (the shipped design with fewer
rows a thread) and "bulk" (half a tile through shared memory, one TMA bulk
store).  Every design is first held bit for bit against the plain version
at n = 1,048,576 (the flagship's bucket), 845,824, 4096 * 33 + 3, 5000 and
1, on 1 and 3 rows.  Then, at n = 1,048,576 on 1 and 2 rows, each design's
device time from CUDA-graph replay, in two passes of opposite order,
beside the byte bound (words read once, floats written once, at 3.35 TB/s)
and two floors: PyTorch's ``fill_`` of the same float32 output (the bytes
written, nothing read) and of one float (a launch that moves nothing).
Prints the card's name and power limit, and one JSON line of the times.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = ("word", "r1", "r2", "r4", "bulk")
SHIPPED = "r8"
SIZES = (1048576, 845824, 4096 * 33 + 3, 5000, 1)


def build_variants(_build):
    """nvcc the variants into the git-ignored build directory."""
    src = os.path.join(ROOT, "scripts", "sign_unpack_variants.cu")
    out = os.path.join(ROOT, "build", "scripts", "libsign_unpack_variants.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, src],
                   check=True)
    lib = ctypes.CDLL(out)
    fn = lib.sweep_sign_unpack
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sign_unpack_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from byteps_tpu_torch.ops import _build
    from byteps_tpu_torch.ops.compressor import bitpack as bp
    sweep = build_variants(_build)

    def unpack(design, words, n):
        if design == SHIPPED:
            return bp.unpack_signs(words, n)
        out = torch.empty(tuple(words.shape[:-1]) + (n,), device="cuda")
        err = sweep(words.data_ptr(), out.data_ptr(), out.numel() // n, n,
                    words.shape[-1], VARIANTS.index(design),
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sign_unpack {design}: launch failed ({err})")
        return out

    designs = (*VARIANTS, SHIPPED)
    ok = True
    for n in SIZES:
        words = bp.pack_signs(cs.signs_input(torch, n, n))
        rows = torch.stack([bp.pack_signs(cs.signs_input(torch, n, n + r))
                            for r in range(3)])
        for d in designs:
            same = (torch.equal(unpack(d, words, n),
                                bp.unpack_signs_plain(words, n))
                    and torch.equal(unpack(d, rows, n),
                                    bp.unpack_signs_plain(rows, n)))
            ok &= same
            if not same:
                print(f"FAIL {d} n={n}: not bit-identical to the plain "
                      f"version")
    print(f"every design bit-identical to the plain version at n in {SIZES},"
          f" 1 and 3 rows: {ok}")

    n = SIZES[0]
    words = bp.pack_signs(cs.signs_input(torch, n, 0))
    tiny = torch.empty(1, device="cuda")
    result = {"launch_floor_ms": cs.time_graph_ms(lambda: tiny.fill_(1.0))}
    for nrows in (1, 2):
        w = words if nrows == 1 else torch.stack([words, words.flip(0)])
        fill = torch.empty(nrows, n, device="cuda")
        times = {d: [] for d in designs}
        for order in (designs, designs[::-1]):
            for d in order:
                times[d].append(cs.time_graph_ms(lambda: unpack(d, w, n)))
        bound = nrows * cs.bitpack_bound_ms(bp, n)
        floor = cs.time_graph_ms(lambda: fill.fill_(1.0))
        result[f"{nrows}_row"] = {"bound_ms": bound, "fill_floor_ms": floor,
                                  **times}
        print(f"{nrows} x {n}: bound {bound:.5f} ms, fill_ {floor:.5f} ms, "
              f"empty launch {result['launch_floor_ms']:.5f} ms; " +
              ", ".join(f"{d} {t[0]:.5f}/{t[1]:.5f} ms" for d, t in
                        times.items()))
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0])
    print(json.dumps(result))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
