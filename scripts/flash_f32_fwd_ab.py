#!/usr/bin/env python3
"""The float32 flash forward at D <= 256 against other versions of it.

    git show <commit>:byteps_tpu_torch/csrc/flash_attention.cu \\
        > build/<name>/flash_attention.cu
    python3 scripts/flash_f32_fwd_ab.py build/<name>/flash_attention.cu \\
        ctas1 cluster128

On one NVIDIA GPU (H100).  Builds each given ``flash_attention.cu``, or
each named variant of the checkout's own (VARIANTS: text replacements,
``+`` joins several), beside the checkout's library, and times the float32
forward of each, ``flash_fwd`` at [128, 512, D] for D = 64, 128 and 256
and ``flash_fwd_str`` at [16, 8192, D] for D = 64 and 256 (the streaming
split of ``_split_len``), causal, in turns others, this, this, others
reversed (CUDA events, medians), beside PyTorch's SDPA forward on the same
inputs (float32 matmuls in full float32).  Prints each library's ptxas
report for the float32 forward kernels, the largest difference between
each version's outputs (O and LSE) and this one's over the largest
element, the card's name and power limit, and one JSON line of the times.
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import flash_f32_wide_ab as wab  # noqa: E402
import flash_refine_ab as ab  # noqa: E402

# (B*H, S, D, family, (reps, rounds))
SHAPES = ((128, 512, 64, "", (10, 5)), (16, 8192, 64, "_str", (2, 3)),
          (128, 512, 128, "", (10, 5)), (128, 512, 256, "", (10, 5)),
          (16, 8192, 256, "_str", (2, 3)))
# Variants of the float32 forward against the shipped source: (old, new)
# replacements.
VARIANTS = {
    # one CTA an SM at W <= 64 too (ptxas free to take up to 255 registers)
    "ctas1": [("  return w <= 64 ? 2 : 1;", "  return 1;")],
    # D = 128 through the wide kernels: a cluster of one CTA, with its
    # exchange rows in two stages of their own
    "cluster128": [("constexpr int kF32ClusterMin = 256;",
                    "constexpr int kF32ClusterMin = 128;")],
}


def fwd_kernels(name):
    return ("f32" in name and name.startswith("flash_fwd")
            and "merge" not in name)


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_f32_fwd_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from byteps_tpu_torch.ops import _build, flash_attention as fa
    wab.VARIANTS = VARIANTS
    sources = {}
    for arg in sys.argv[1:]:
        if arg.endswith(".cu"):
            sources[os.path.basename(os.path.dirname(os.path.abspath(
                arg)))] = os.path.abspath(arg)
        else:
            sources[arg] = wab.variant_source(_build, arg)
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        this = pool.submit(fa.build)
        built = {n: pool.submit(wab.build_other, _build, n.replace("+", "_"),
                                src) for n, src in sources.items()}
        this.result()
        libs = {"this": fa._lib()}
        logs = {"this": _build.build_logs.get(fa.SOURCE, "")}
        for n, fut in built.items():
            path, logs[n] = fut.result()
            libs[n] = ab.load(fa, path)
    for n, log in logs.items():
        for kernel, report in cs.ptxas_reports(log):
            if fwd_kernels(kernel):
                print(f"ptxas {n} {kernel}: {report}")
    real = fa._lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    others = [n for n in libs if n != "this"]
    order = [*others, "this", "this", *reversed(others)]
    result = {}
    try:
        for bh, s, d, fam, reps in SHAPES:
            q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
                       for _ in range(3))
            sc = d ** -0.5
            name = "flash_fwd" + fam
            fwd = getattr(fa, name)
            outs, times = {}, {var: [] for var in libs}
            for var, lib in libs.items():
                fa._lib = lambda lib=lib: lib
                outs[var] = fwd(q, k, v, True, sc)
            for var in order:
                fa._lib = lambda lib=libs[var]: lib
                times[var].append(cs.time_ms(
                    lambda: fwd(q, k, v, True, sc), *reps))
            fa._lib = real
            q4, k4, v4 = (t.view(bh // 16, 16, s, d) for t in (q, k, v))
            sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(
                q4, k4, v4, is_causal=True), *reps)
            diff = {var: max(float((a - b).abs().max() / b.abs().max())
                             for a, b in zip(outs[var], outs["this"]))
                    for var in others}
            mean = {var: sum(t) / len(t) for var, t in times.items()}
            bound = cs.bound_ms(name, bh, s, d, 4, True)[0]
            key = f"{name} [{bh},{s},{d}] float32 causal"
            result[key] = {
                "times_ms": times, "mean_ms": mean, "sdpa_forward_ms": sdpa,
                "bound_ms": bound, "max_rel_diff": diff,
                "tflops": {var: cs.tflops(name, bh, s, d, True, ms)
                           for var, ms in mean.items()}}
            print(f"{key}: " + ", ".join(
                f"{var} {[round(x, 4) for x in times[var]]} ms, mean "
                f"{mean[var]:.4f} ({result[key]['tflops'][var]:.1f} "
                f"TFLOP/s, {mean[var] / sdpa:.2f}x SDPA, this "
                f"{mean[var] / mean['this']:.2f}x faster)" for var in libs)
                + f"; SDPA forward {sdpa:.4f} ms; bound {bound:.4f} ms; "
                "outputs differ from this by " + ", ".join(
                    f"{var} {x:.3g}" for var, x in diff.items())
                + " of the largest", flush=True)
            del q, k, v, q4, k4, v4, outs
            torch.cuda.empty_cache()
    finally:
        fa._lib = real
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
