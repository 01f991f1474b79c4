#!/usr/bin/env python3
"""The bf16 and float16 wide flash forward against other versions of it.

    git show <commit>:byteps_tpu_torch/csrc/flash_attention.cu \\
        > build/<name>/flash_attention.cu
    python3 scripts/flash_wide16_fwd_ab.py build/<name>/flash_attention.cu \\
        ctas1

On one NVIDIA GPU (H100).  Builds each given ``flash_attention.cu``, or
each named variant of the checkout's own (VARIANTS: text replacements,
``+`` joins several), beside the checkout's library, and times the bf16
and float16 forward of each, ``flash_fwd`` at [128, 512, D] and
``flash_fwd_str`` at [16, 8192, D] (the streaming split of
``_split_len``), for D = 384 and 512, causal, in turns others, this,
this, others reversed (CUDA events, medians), beside PyTorch's SDPA
forward on the same inputs.  Prints each library's ptxas report for the
16-bit wide forward kernels, the largest difference between each
version's outputs (O and LSE) and this one's over the largest element,
the card's name and power limit, and one JSON line of the times.
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

SHAPES = (((128, 512), "", (5, 3)), ((16, 8192), "_str", (1, 3)))
DIMS = (384, 512)
# Variants of the 16-bit wide forward against the shipped source: (old,
# new) replacements.
_STR_PV = ("if constexpr (kStr) {  // unrolled whole, the streaming kernel "
           "spilled\n#pragma unroll 2")
VARIANTS = {
    # one CTA an SM (ptxas free to take up to 255 registers)
    "ctas1": [("constexpr int kFwd16Ctas = 2;",
               "constexpr int kFwd16Ctas = 1;")],
    # the streaming kernel's P V not unrolled, or unrolled whole as the
    # resident kernel's (ptxas's report says whether it spills)
    "str1": [(_STR_PV, _STR_PV.replace("unroll 2", "unroll 1"))],
    "strfull": [(_STR_PV, _STR_PV.replace("unroll 2", "unroll"))],
}


def wide16_kernels(name):
    """The 16-bit wide forward's kernels, by SASS label: this source's
    cluster kernels, or the one-slice-a-CTA kernels before them."""
    return ("_wide16_kernel" in name
            or name.startswith(("flash_fwd_wide_mma_kernel",
                                "flash_fwd_str_wide_mma_kernel")))


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_wide16_fwd_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
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
            if wide16_kernels(kernel):
                print(f"ptxas {n} {kernel}: {report}")
    real = fa._lib
    others = [n for n in libs if n != "this"]
    order = [*others, "this", "this", *reversed(others)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    try:
        for (bh, s), fam, reps in SHAPES:
            for d in DIMS:
                for dtype in (torch.bfloat16, torch.float16):
                    q, k, v = (torch.randn(bh, s, d, generator=gen,
                                           device="cuda").to(dtype)
                               for _ in range(3))
                    sc = d ** -0.5
                    name = "flash_fwd" + fam
                    fwd = getattr(fa, name)
                    outs = {}
                    for var in libs:
                        fa._lib = lambda lib=libs[var]: lib
                        outs[var] = fwd(q, k, v, True, sc)
                    times = {var: [] for var in libs}
                    for var in order:
                        fa._lib = lambda lib=libs[var]: lib
                        times[var].append(cs.time_ms(
                            lambda: fwd(q, k, v, True, sc), *reps))
                    fa._lib = real
                    q4, k4, v4 = (t.view(bh // 16, 16, s, d)
                                  for t in (q, k, v))
                    sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(
                        q4, k4, v4, is_causal=True), *reps)
                    backend = cs.sdpa_backend(torch, q4, k4, v4)
                    tag = fa._DTYPE_NAMES[dtype]
                    key = f"{name} [{bh},{s},{d}] {tag} causal"
                    diff = {var: max(
                        float((a.float() - b.float()).abs().max()
                              / b.float().abs().max())
                        for a, b in zip(outs[var], outs["this"]))
                        for var in others}
                    mean = {var: sum(t) / len(t) for var, t in times.items()}
                    rate = {var: cs.tflops(name, bh, s, d, True, ms)
                            for var, ms in mean.items()}
                    bound, by = cs.bound_ms(name, bh, s, d, 2, True)
                    result[key] = {**times, "sdpa_forward_ms": sdpa,
                                   "sdpa_backend": backend, "tflops": rate,
                                   "bound_ms": bound, "bound_by": by,
                                   "max_rel_diff": diff}
                    print(f"{key}: " + ", ".join(
                        f"{var} {[round(x, 4) for x in ts]} ms "
                        f"({rate[var]:.2f} TFLOP/s, {mean[var] / sdpa:.2f}x "
                        f"SDPA)" for var, ts in times.items())
                        + f"; SDPA forward {sdpa:.4f} ms ({backend}); bound "
                        f"{bound:.4f} ms ({by}); outputs differ from this by "
                        + ", ".join(f"{var} {x:.3g}" for var, x in diff.items())
                        + " of the largest", flush=True)
                    del q, k, v, outs, q4, k4, v4
                    torch.cuda.empty_cache()
    finally:
        fa._lib = real
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
