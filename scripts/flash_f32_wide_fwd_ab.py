#!/usr/bin/env python3
"""The float32 wide flash forward against other versions of its source.

    git show <commit>:byteps_tpu_torch/csrc/flash_attention.cu \\
        > build/<name>/flash_attention.cu
    python3 scripts/flash_f32_wide_fwd_ab.py build/<name>/flash_attention.cu
    python3 scripts/flash_f32_wide_fwd_ab.py recompute nobar

On one NVIDIA GPU (H100).  Builds each given ``flash_attention.cu``, or
each named variant of the checkout's own (VARIANTS: text replacements,
``+`` joins several), beside the checkout's library, and times the float32
forward of each, ``flash_fwd`` at [128, 512, D] and ``flash_fwd_str`` at
[16, 8192, D] (the streaming split of ``_split_len``), for D = 384 and
512, causal, in turns others, this, this, others reversed (CUDA events,
medians), beside PyTorch's SDPA forward on the same inputs (float32
matmuls in full float32).  Prints each kernel's ptxas report, the largest
difference between each library's outputs and this one's over the largest
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

SHAPES = (((128, 512), "", (5, 3)), ((16, 8192), "_str", (1, 3)))
DIMS = (384, 512)
F32_WIDE_FWD = ("flash_fwd_wide_kernel<f32>", "flash_fwd_str_wide_kernel<f32>")
# Variants of the float32 wide forward against the shipped source: (old,
# new) replacements.
VARIANTS = {
    # the fallback design: one 128-column output slice a CTA, no cluster;
    # each CTA contracts S over all of D itself (D / 128 times the shipped
    # S products) and owns all 64 rows of its softmax
    "recompute": [
        ("  const int c = ctas<kCluster>(), rank = cta_rank<kCluster>();\n"
         "  float* al = smem;",
         "  const int c = 1, rank = 0;\n  float* al = smem;"),
        ("  const int spc = kCluster ? (n + c - 1) / c : 1;  // slices a CTA "
         "outputs",
         "  const int spc = 1;"),
        ("    const int jo = rank + pass * c;  // the slice this pass "
         "writes (if < n)",
         "    const int jo = (int)blockIdx.x % n;"),
        ("(int)blockIdx.x / ctas<kCluster>();\n  const size_t row0",
         "(int)blockIdx.x / (d / W);\n  const size_t row0"),
        ("(int)blockIdx.x / ctas<kCluster>();\n  const int sp = blockIdx.y;\n"
         "  const int bh = blockIdx.z;\n  const int kt0 = sp * split;\n"
         "  const int kt1 = min(kt0 + split, causal ? qt + 1 : num_t);\n"
         "  if (kt0 >= kt1) return;  // dead pair, for the whole cluster\n\n"
         "  const size_t base = (size_t)bh * seq * d;\n"
         "  const size_t at = ws_row(",
         "(int)blockIdx.x / (d / W);\n  const int sp = blockIdx.y;\n"
         "  const int bh = blockIdx.z;\n  const int kt0 = sp * split;\n"
         "  const int kt1 = min(kt0 + split, causal ? qt + 1 : num_t);\n"
         "  if (kt0 >= kt1) return;\n\n"
         "  const size_t base = (size_t)bh * seq * d;\n"
         "  const size_t at = ws_row("),
        ("launch_split(flash_fwd_wide_kernel, dim3(seq / kTile * ctas, bh),\n"
         "                        ctas, f32_fwd_smem<kWide, true>(ctas),",
         "launch_split(flash_fwd_wide_kernel,\n"
         "                        dim3(seq / kTile * (d / kWide), bh),\n"
         "                        1, f32_fwd_smem<kWide, true>(1),"),
        ("flash_fwd_str_wide_kernel, dim3(num_t * ctas, nsplit, bh), ctas,\n"
         "        f32_fwd_smem<kWide, true>(ctas),",
         "flash_fwd_str_wide_kernel, dim3(num_t * npass, nsplit, bh), 1,\n"
         "        f32_fwd_smem<kWide, true>(1),")],
    # a timing probe, wrong results: the exchange without its cluster
    # barrier (one cluster barrier before a CTA's stores and exit)
    "nobar": [
        ("      exchange_sync<kCluster>();  // tile kt's S at its owners",
         "      __syncthreads();  //"),
        ("    if (jo < n) {\n      if (lse) {",
         "    if constexpr (kCluster) cluster_sync();\n"
         "    if (jo < n) {\n      if (lse) {")],
}


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_f32_wide_fwd_ab: no CUDA device", file=sys.stderr)
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
            if kernel in F32_WIDE_FWD:
                print(f"ptxas {n} {kernel}: {report}")
    real = fa._lib
    others = [n for n in libs if n != "this"]
    order = [*others, "this", "this", *reversed(others)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    try:
        for (bh, s), fam, reps in SHAPES:
            for d in DIMS:
                q, k, v = (torch.randn(bh, s, d, generator=gen, device="cuda")
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
                q4, k4, v4 = (t.view(bh // 16, 16, s, d) for t in (q, k, v))
                sdpa = cs.time_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=True), *reps)
                key = f"{name} [{bh},{s},{d}] float32 causal"
                diff = {var: max(
                    float((a - b).abs().max() / b.abs().max())
                    for a, b in zip(outs[var], outs["this"]))
                    for var in others}
                mean = {var: sum(t) / len(t) for var, t in times.items()}
                rate = {var: cs.tflops(name, bh, s, d, True, ms)
                        for var, ms in mean.items()}
                result[key] = {**times, "sdpa_forward_ms": sdpa,
                               "tflops": rate, "max_rel_diff": diff}
                print(f"{key}: " + ", ".join(
                    f"{var} {[round(x, 4) for x in ts]} ms "
                    f"({rate[var]:.2f} TFLOP/s, {mean[var] / sdpa:.2f}x "
                    f"SDPA)" for var, ts in times.items())
                    + f"; SDPA forward {sdpa:.4f} ms; outputs differ from "
                    "this by " + ", ".join(
                        f"{var} {x:.3g}" for var, x in diff.items())
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
