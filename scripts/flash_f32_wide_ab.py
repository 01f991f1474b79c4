#!/usr/bin/env python3
"""The float32 wide flash backward against other versions of its source.

    git show <commit>:byteps_tpu_torch/csrc/flash_attention.cu \\
        > build/other/flash_attention.cu
    python3 scripts/flash_f32_wide_ab.py build/other/flash_attention.cu
    python3 scripts/flash_f32_wide_ab.py cvt rawlo dkvunroll nobar

On one NVIDIA GPU (H100).  Builds each given ``flash_attention.cu``, or
each named variant of the checkout's own (VARIANTS: text replacements,
``+`` joins several), beside the checkout's library, and times the float32
backward pair of each, ``flash_bwd_dq`` + ``flash_bwd_dkv`` at
[128, 512, D] and their streaming forms at [16, 8192, D] (the streaming
split of ``_split_len``), for D = 384 and 512 (512 only with variants),
causal, in turns others, this, this, others reversed (CUDA events,
medians), beside PyTorch's SDPA backward on the same inputs (float32
matmuls in full float32).  Prints the largest difference between each
library's outputs and this one's over the largest element, the card's
name and power limit, and one JSON line of the times.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import flash_refine_ab as ab  # noqa: E402

SHAPES = (((128, 512), "", (5, 3)), ((16, 8192), "_str", (1, 3)))
DIMS = (384, 512)
# Variants of the float32 wide backward against the shipped source: (old,
# new) replacements.
_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_DKV = "  constexpr bool kAbtUnroll = false;"
VARIANTS = {
    # TF32 rounding by the cvt.rna instruction (the same bits)
    "cvt": [(_RNA, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : '
                   '"=r"(r) : "f"(x));\n  return r;')],
    # lo passed unrounded: the tensor cores read its top 19 bits
    "rawlo": [("  lo = tf32_rna(x - __uint_as_float(hi));",
               "  lo = __float_as_uint(x - __uint_as_float(hi));")],
    # dK/dV's first products' k steps unrolled by two too (it spills)
    "dkvunroll": [(_DKV, "  constexpr bool kAbtUnroll = true;")],
    # every product's k loop unrolled whole
    "full": [("#pragma unroll 2\n    for (int k16",
              "#pragma unroll\n    for (int k16"),
             ("#pragma unroll 1\n  for (int kk = 0; kk < kTile / 8; kk += 2)",
              "#pragma unroll\n  for (int kk = 0; kk < kTile / 8; kk += 2)"),
             (_DKV, "  constexpr bool kAbtUnroll = true;")],
    # a timing probe, wrong results: the exchange without its two cluster
    # barriers (one cluster barrier before a CTA's stores and exit)
    "nobar": [("  cluster_sync();  // every partial is at its owner",
               "  __syncthreads();"),
              ("  cluster_sync();  // P and dS complete in every CTA",
               "  __syncthreads();"),
              ("    if (jo < n) store_tc_rows(out,",
               "    cluster_sync();\n    if (jo < n) store_tc_rows(out,"),
              ("    if (jo < n) {\n#pragma unroll\n      for (int h = 0;",
               "    cluster_sync();\n    if (jo < n) {\n#pragma unroll\n"
               "      for (int h = 0;")],
}


def variant_source(_build, name):
    """The checkout's source with the replacements of ``name`` (names
    joined by +), written under build/scripts/."""
    text = open(os.path.join(_build.CSRC_DIR, "flash_attention.cu")).read()
    for part in name.split("+"):
        for old, new in VARIANTS[part]:
            if old not in text:
                raise RuntimeError(f"variant {part}: {old!r} not found")
            text = text.replace(old, new)
    out_dir = os.path.join(ROOT, "build", "scripts")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"flash_attention_{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build_other(_build, name, src):
    out_dir = os.path.join(ROOT, "build", "scripts")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"libflash_{name}.so")
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.ARCH_FLAGS, "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I",
         _build.CSRC_DIR, "-o", lib, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}: {proc.stdout}{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_f32_wide_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from byteps_tpu_torch.ops import _build, flash_attention as fa
    sources = {}
    for arg in sys.argv[1:]:
        if arg.endswith(".cu"):
            sources[os.path.basename(os.path.dirname(os.path.abspath(
                arg)))] = os.path.abspath(arg)
        else:
            sources[arg] = variant_source(_build, arg)
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        this = pool.submit(fa.build)
        built = {n: pool.submit(build_other, _build, n.replace("+", "_"),
                                src) for n, src in sources.items()}
        this.result()
        libs = {"this": fa._lib()}
        for n, fut in built.items():
            path, log = fut.result()
            libs[n] = ab.load(fa, path)
            for kernel, report in cs.ptxas_reports(log):
                if kernel in cs.F32_WIDE_BWD:
                    print(f"ptxas {n} {kernel}: {report}")
    real = fa._lib
    others = [n for n in libs if n != "this"]
    order = [*others, "this", "this", *reversed(others)]
    dims = DIMS if all(a.endswith(".cu") for a in sys.argv[1:]) else (512,)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    try:
        for (bh, s), fam, reps in SHAPES:
            for d in dims:
                q, k, v, do = (torch.randn(bh, s, d, generator=gen,
                                           device="cuda")
                               for _ in range(4))
                sc = d ** -0.5
                dq_fn, dkv_fn = (getattr(fa, n + fam) for n in (
                    "flash_bwd_dq", "flash_bwd_dkv"))
                fa._lib = real
                o, lse = fa.flash_fwd_plain(q, k, v, True, sc)
                _, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, True,
                                                 sc)
                calls = {
                    "flash_bwd_dq" + fam:
                        lambda: dq_fn(q, k, v, o, lse, do, True, sc),
                    "flash_bwd_dkv" + fam:
                        lambda: dkv_fn(q, k, v, do, lse, delta, True, sc)}
                outs = {}
                for var in libs:
                    fa._lib = lambda lib=libs[var]: lib
                    outs[var] = {n: fn() for n, fn in calls.items()}
                times = {n: {var: [] for var in libs} for n in calls}
                for var in order:
                    fa._lib = lambda lib=libs[var]: lib
                    for n, fn in calls.items():
                        times[n][var].append(cs.time_ms(fn, *reps))
                fa._lib = real
                q4, k4, v4 = (t.view(bh // 16, 16, s, d).clone()
                              .requires_grad_() for t in (q, k, v))
                o4 = F.scaled_dot_product_attention(q4, k4, v4,
                                                    is_causal=True)
                sdpa = cs.time_ms(lambda: torch.autograd.grad(
                    o4, (q4, k4, v4), do.view(o4.shape), retain_graph=True),
                    *reps)
                key = f"[{bh},{s},{d}] float32 causal"
                entry = {"sdpa_backward_ms": sdpa}
                for n, t in times.items():
                    diff = {var: max(
                        float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(outs[var][n], outs["this"][n]))
                        for var in others}
                    entry[n] = {**t, "max_rel_diff": diff}
                    print(f"{n} {key}: " + ", ".join(
                        f"{var} {[round(x, 4) for x in ts]} ms"
                        for var, ts in t.items())
                        + "; outputs differ from this by " + ", ".join(
                            f"{var} {x:.3g}" for var, x in diff.items())
                        + " of the largest", flush=True)
                pair = {var: sum(sum(entry[n][var]) / len(entry[n][var])
                                 for n in calls) for var in libs}
                print(f"pair {key}, mean of turns: " + ", ".join(
                    f"{var} {ms:.4f} ms ({ms / sdpa:.2f}x SDPA)"
                    for var, ms in pair.items())
                    + f"; SDPA backward {sdpa:.4f} ms", flush=True)
                result[key] = entry
                del q, k, v, do, o, lse, delta, outs, q4, k4, v4, o4
                torch.cuda.empty_cache()
    finally:
        fa._lib = real
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
