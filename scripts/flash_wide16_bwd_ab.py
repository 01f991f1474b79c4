#!/usr/bin/env python3
"""The bf16 and float16 wide flash backward against other versions of it.

    git show <commit>:byteps_tpu_torch/csrc/flash_attention.cu \\
        > build/<name>/flash_attention.cu
    python3 scripts/flash_wide16_bwd_ab.py build/<name>/flash_attention.cu \\
        dkv1

On one NVIDIA GPU (H100).  Builds each given ``flash_attention.cu``, or
each named variant of the checkout's own (VARIANTS: text replacements,
``+`` joins several), beside the checkout's library, and times the bf16
and float16 backward pair of each, ``flash_bwd_dq`` + ``flash_bwd_dkv`` at
[128, 512, D] and ``flash_bwd_dq_str`` + ``flash_bwd_dkv_str`` at
[16, 8192, D] (the streaming split of ``_split_len``), for D = 384 and
512, causal, in turns others, this, this, others reversed (CUDA events,
medians), beside PyTorch's SDPA backward (dQ, dK and dV in one call) on
the same inputs.  Prints each library's ptxas report for the 16-bit wide
backward kernels, the largest difference between each version's outputs
(dQ, delta, dK, dV) and this one's over the largest element, the card's
name and power limit, and one JSON line of the times.

Then the cluster backward at D = 256 (two CTAs a cluster): a variant of
the checkout's source whose dispatch sends D = 256 to the wide launchers,
timed the same way against the checkout's ``<bf16,256>`` and
``<f16,256>`` kernels, in turns this, wide, wide, this.
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
# Variants of the 16-bit wide backward against the shipped source: (old,
# new) replacements.
VARIANTS = {
    # one CTA an SM (ptxas free to take up to 255 registers)
    "dq1": [("constexpr int kDq16Ctas = 2;", "constexpr int kDq16Ctas = 1;")],
    "dkv1": [("constexpr int kDkv16Ctas = 2;",
              "constexpr int kDkv16Ctas = 1;")],
    # D = 256 on the wide kernels (the cluster backward, two CTAs)
    "wide256": [("if ((d) > 256) {", "if ((d) >= 256) {")],
}


def wide16_bwd_kernels(name):
    """The 16-bit wide backward's kernels, by SASS label: this source's
    cluster kernels, or the one-slice-a-CTA kernels before them."""
    return name.startswith("flash_bwd") and (
        "_wide16_kernel" in name or "_wide_mma_kernel" in name)


def backward_calls(fa, fam, q, k, v, do, sc):
    """The pair's two calls on the forward's O and LSE (of the library in
    use when this is called), and the forward's outputs."""
    o, lse = getattr(fa, "flash_fwd" + fam)(q, k, v, True, sc)
    dq_fn, dkv_fn = (getattr(fa, n + fam)
                     for n in ("flash_bwd_dq", "flash_bwd_dkv"))
    _, delta = dq_fn(q, k, v, o, lse, do, True, sc)
    return (lambda: dq_fn(q, k, v, o, lse, do, True, sc),
            lambda: dkv_fn(q, k, v, do, lse, delta, True, sc))


def time_pair(cs, fa, libs, order, fam, q, k, v, do, sc, reps):
    """Each library's (dQ ms, dK/dV ms) lists over the turns of ``order``,
    and its outputs (dQ, delta, dK, dV) on the first library's O and LSE."""
    real = fa._lib
    try:
        fa._lib = lambda lib=libs[order[0]]: lib
        calls = backward_calls(fa, fam, q, k, v, do, sc)
        outs, times = {}, {var: ([], []) for var in libs}
        for var in libs:
            fa._lib = lambda lib=libs[var]: lib
            outs[var] = [t.float() for t in (*calls[0](), *calls[1]())]
        for var in order:
            fa._lib = lambda lib=libs[var]: lib
            for j in range(2):
                times[var][j].append(cs.time_ms(calls[j], *reps))
    finally:
        fa._lib = real
    return times, outs


def sdpa_backward_ms(cs, torch, q, k, v, do, reps):
    import torch.nn.functional as F
    bh, s, d = q.shape
    q4, k4, v4 = (t.view(bh // 16, 16, s, d).detach().clone()
                  .requires_grad_() for t in (q, k, v))
    o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
    do4 = do.view(bh // 16, 16, s, d)
    ms = cs.time_ms(lambda: torch.autograd.grad(o4, (q4, k4, v4), do4,
                                                retain_graph=True), *reps)
    return ms, cs.sdpa_backend(torch, q4, k4, v4)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_wide16_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from byteps_tpu_torch.ops import _build, flash_attention as fa
    wab.VARIANTS = VARIANTS
    sources = {}
    for arg in [*sys.argv[1:], "wide256"]:
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
            if wide16_bwd_kernels(kernel):
                print(f"ptxas {n} {kernel}: {report}")
    wide = libs.pop("wide256")
    others = [n for n in libs if n != "this"]
    order = [*others, "this", "this", *reversed(others)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for dims, sets in ((DIMS, (libs, order)),
                       ((256,), ({"this": libs["this"], "wide256": wide},
                                 ["this", "wide256", "wide256", "this"]))):
        use, turns = sets
        for (bh, s), fam, reps in SHAPES:
            for d in dims:
                for dtype in (torch.bfloat16, torch.float16):
                    q, k, v, do = (torch.randn(bh, s, d, generator=gen,
                                               device="cuda").to(dtype)
                                   for _ in range(4))
                    sc = d ** -0.5
                    times, outs = time_pair(cs, fa, use, turns, fam, q, k, v,
                                            do, sc, reps)
                    sdpa, backend = sdpa_backward_ms(cs, torch, q, k, v, do,
                                                     reps)
                    tag = fa._DTYPE_NAMES[dtype]
                    key = f"bwd{fam} [{bh},{s},{d}] {tag} causal"
                    diff = {var: max(
                        float((a - b).abs().max() / b.abs().max())
                        for a, b in zip(outs[var], outs["this"]))
                        for var in use if var != "this"}
                    mean = {var: [sum(t) / len(t) for t in ts]
                            for var, ts in times.items()}
                    bounds = [cs.bound_ms(n + fam, bh, s, d, 2, True)[0]
                              for n in ("flash_bwd_dq", "flash_bwd_dkv")]
                    result[key] = {"times": times, "sdpa_backward_ms": sdpa,
                                   "sdpa_backend": backend,
                                   "bound_ms": bounds, "max_rel_diff": diff}
                    print(f"{key}: " + ", ".join(
                        f"{var} dQ {[round(x, 4) for x in ts[0]]} dK/dV "
                        f"{[round(x, 4) for x in ts[1]]} ms (pair "
                        f"{sum(mean[var]):.4f}, {sum(mean[var]) / sdpa:.2f}x "
                        f"SDPA)" for var, ts in times.items())
                        + f"; SDPA backward {sdpa:.4f} ms ({backend}); "
                        f"bounds {bounds[0]:.4f}, {bounds[1]:.4f} ms; "
                        f"outputs differ from this by " + ", ".join(
                            f"{var} {x:.3g}" for var, x in diff.items())
                        + " of the largest", flush=True)
                    del q, k, v, do, outs
                    torch.cuda.empty_cache()
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
