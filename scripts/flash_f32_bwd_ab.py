#!/usr/bin/env python3
"""The float32 flash backward at D <= 256 against other versions of it.

    git show <commit>:byteps_tpu_torch/csrc/flash_attention.cu \\
        > build/<name>/flash_attention.cu
    python3 scripts/flash_f32_bwd_ab.py build/<name>/flash_attention.cu \\
        pad128 cluster128 ctas1 dbuf

On one NVIDIA GPU (H100).  Builds each given ``flash_attention.cu``, or
each named variant of the checkout's own (VARIANTS: text replacements,
``+`` joins several), beside the checkout's library, and times the float32
backward pair of each, ``flash_bwd_dq`` + ``flash_bwd_dkv``, at
[128, 512, D] for D = 64, 128 and 256 and their streaming forms at
[16, 8192, D] for D = 64 and 256 (the streaming split of ``_split_len``),
causal, in turns others, this, this, others reversed (CUDA events,
medians), beside PyTorch's SDPA backward on the same inputs (float32
matmuls in full float32).  ``pad128`` is no source but a call: the
checkout's library at D = 64 on inputs zero-padded to D = 128 (the
no-cluster kernel at W = 128 doing the work of W = 64), timed on the
padded tensors.  Prints each library's ptxas report for the float32
backward kernels, the largest difference between each version's outputs
and this one's over the largest element, the card's name and power limit,
and one JSON line of the times.
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
SHAPES = ((128, 512, 64, "", (5, 3)), (16, 8192, 64, "_str", (1, 3)),
          (128, 512, 128, "", (5, 3)), (128, 512, 256, "", (5, 3)),
          (16, 8192, 256, "_str", (1, 3)))
_DBUF = [
    ("  return (2 * kTile + 4 * kTile * W +",
     "  return (2 * kTile + (kCluster ? 4 : 6) * kTile * W +"),
    ("  float* kc = doc + kChunk;\n  float* vc = kc + kChunk;\n"
     "  float* ex = vc + kChunk;",
     "  constexpr int kStages = kCluster ? 1 : 2;\n"
     "  float* kc = doc + kChunk;\n  float* vc = kc + kStages * kChunk;\n"
     "  float* ex = vc + kStages * kChunk;"),
    ("(vc, v + (size_t)kt0 * kTile * d + jo * W, d);\n"
     "      cp_async_commit();",
     "(vc, v + (size_t)kt0 * kTile * d + jo * W, d);\n"
     "      if constexpr (kStages == 1) cp_async_commit();"),
    ("      const size_t ko = (size_t)kt * kTile * d;\n"
     "      float s[4][4], dp[4][4];\n      zero(s);\n      zero(dp);\n"
     "      if (spc == 1) {",
     "      const size_t ko = (size_t)kt * kTile * d;\n"
     "      const int b = kStages == 2 ? (kt - kt0) & 1 : 0;\n"
     "      float* kb = kc + b * kChunk;\n"
     "      float s[4][4], dp[4][4];\n      zero(s);\n      zero(dp);\n"
     "      if constexpr (kStages == 2) {\n"
     "        if (kt + 1 < kt1) {\n"
     "          chunk_f32_async<W>(kc + (b ^ 1) * kChunk,\n"
     "                             k + ko + kTile * d + jo * W, d);\n"
     "          chunk_f32_async<W>(vc + (b ^ 1) * kChunk,\n"
     "                             v + ko + kTile * d + jo * W, d);\n"
     "        }\n        cp_async_commit();\n        cp_async_wait_prev();\n"
     "        __syncthreads();\n"
     "        mma3_abt<W, 4, true>(dp, doc, rw, vc + b * kChunk, kh, lane);\n"
     "        mma3_abt<W, 4, true>(s, qc, rw, kb, kh, lane);\n"
     "      } else if (spc == 1) {"),
    ("(acc, dst, rw, kc, oh, lane);\n      if (spc == 1) {",
     "(acc, dst, rw, kb, oh, lane);\n      if constexpr (kStages == 2) {\n"
     "        __syncthreads();\n      } else if (spc == 1) {"),
    ("  float* qc = vc + kChunk;\n  float* doc = qc + kChunk;\n"
     "  float* ex = doc + kChunk;",
     "  constexpr int kStages = kCluster ? 1 : 2;\n"
     "  float* qc = vc + kChunk;\n  float* doc = qc + kStages * kChunk;\n"
     "  float* ex = doc + kStages * kChunk;"),
    ("(doc, dout + (size_t)qt0 * kTile * d + jo * W, d);\n"
     "      cp_async_commit();",
     "(doc, dout + (size_t)qt0 * kTile * d + jo * W, d);\n"
     "      if constexpr (kStages == 1) cp_async_commit();"),
    ("      const size_t qo = (size_t)qt * kTile * d;\n"
     "      if (threadIdx.x < nown) {",
     "      const size_t qo = (size_t)qt * kTile * d;\n"
     "      const int b = kStages == 2 ? (qt - qt0) & 1 : 0;\n"
     "      float* qb = qc + b * kChunk;\n"
     "      float* dob = doc + b * kChunk;\n"
     "      if (threadIdx.x < nown) {"),
    ("      zero(dp);\n      if (spc == 1) {\n"
     "        cp_async_wait_prev();  // K, V and dO of tile qt",
     "      zero(dp);\n      if constexpr (kStages == 2) {\n"
     "        if (qt + 1 < qt1) {\n"
     "          chunk_f32_async<W>(qc + (b ^ 1) * kChunk,\n"
     "                             q + qo + kTile * d + jo * W, d);\n"
     "          chunk_f32_async<W>(doc + (b ^ 1) * kChunk,\n"
     "                             dout + qo + kTile * d + jo * W, d);\n"
     "        }\n        cp_async_commit();\n        cp_async_wait_prev();\n"
     "        __syncthreads();\n"
     "        mma3_abt<W, 4, kAbtUnroll>(dp, dob, rw, vc, kh, lane);\n"
     "        mma3_abt<W, 4, kAbtUnroll>(s, qb, rw, kc, kh, lane);\n"
     "      } else if (spc == 1) {\n"
     "        cp_async_wait_prev();  // K, V and dO of tile qt"),
    ("(dv[h], pt, rw, doc, oh + 8 * kHB * h, lane);\n      }\n"
     "      if (spc == 1) {",
     "(dv[h], pt, rw, dob, oh + 8 * kHB * h, lane);\n      }\n"
     "      if (kStages == 1 && spc == 1) {"),
    ("(dk[h], dst, rw, qc, oh + 8 * kHB * h, lane);\n      }\n"
     "      if (spc == 1) {",
     "(dk[h], dst, rw, qb, oh + 8 * kHB * h, lane);\n      }\n"
     "      if constexpr (kStages == 2) {\n        __syncthreads();\n"
     "      } else if (spc == 1) {"),
]
# Variants of the float32 backward against the shipped source: (old, new)
# replacements.
VARIANTS = {
    # D = 128 through the wide kernels: a cluster of one CTA, with its
    # exchange rows and its two cluster barriers a tile pair
    "cluster128": [("constexpr int kF32ClusterMin = 256;",
                    "constexpr int kF32ClusterMin = 128;")],
    # one CTA an SM at W <= 64 too (ptxas free to take up to 255 registers)
    "ctas1": [("  return w <= 64 ? 2 : 1;", "  return 1;")],
    # two stages of the streamed chunks without a cluster: the next tile's
    # K and V (dQ) or Q and dO (dK/dV) load into the stage the last tile
    # freed while this tile's products run; three CTA barriers a tile pair
    # instead of five (dQ) or four (dK/dV)
    "dbuf": _DBUF,
    # dK/dV's first products' k steps unrolled by two
    "dkvunroll": [("  constexpr bool kAbtUnroll = false;",
                   "  constexpr bool kAbtUnroll = true;")],
}
PAD = "pad128"   # the call variant


def bwd_kernels(name):
    return "f32" in name and ("_tc_kernel" in name or (
        "bwd" in name and "_wide" in name))


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_f32_bwd_ab: no CUDA device", file=sys.stderr)
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
        elif arg != PAD:
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
            if bwd_kernels(kernel):
                print(f"ptxas {n} {kernel}: {report}")
    real = fa._lib
    pad = PAD in sys.argv[1:]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    try:
        for bh, s, d, fam, reps in SHAPES:
            q, k, v, do = (torch.randn(bh, s, d, generator=gen,
                                       device="cuda") for _ in range(4))
            sc = d ** -0.5
            dq_fn, dkv_fn = (getattr(fa, n + fam) for n in (
                "flash_bwd_dq", "flash_bwd_dkv"))
            fa._lib = real
            o, lse = fa.flash_fwd_plain(q, k, v, True, sc)
            _, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, True, sc)
            names = ("flash_bwd_dq" + fam, "flash_bwd_dkv" + fam)

            def pair(q, k, v, o, do):
                return {names[0]: lambda: dq_fn(q, k, v, o, lse, do, True,
                                                sc),
                        names[1]: lambda: dkv_fn(q, k, v, do, lse, delta,
                                                 True, sc)}

            variants = {var: (lib, pair(q, k, v, o, do))
                        for var, lib in libs.items()}
            if pad and d == 64:
                padded = [F.pad(t, (0, 64)) for t in (q, k, v, o, do)]
                variants[PAD] = (libs["this"], pair(*padded))
            others = [n for n in variants if n != "this"]
            order = [*others, "this", "this", *reversed(others)]
            outs = {}
            for var, (lib, calls) in variants.items():
                fa._lib = lambda lib=lib: lib
                outs[var] = {n: [t[..., :d] if t.dim() == 3 else t
                                 for t in fn()]
                             for n, fn in calls.items()}
            times = {n: {var: [] for var in variants} for n in names}
            for var in order:
                lib, calls = variants[var]
                fa._lib = lambda lib=lib: lib
                for n, fn in calls.items():
                    times[n][var].append(cs.time_ms(fn, *reps))
            fa._lib = real
            q4, k4, v4 = (t.view(bh // 16, 16, s, d).clone()
                          .requires_grad_() for t in (q, k, v))
            o4 = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)
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
                mean = {var: sum(ts) / len(ts) for var, ts in t.items()}
                bound = cs.bound_ms(n, bh, s, d, 4, True)[0]
                entry[n] = {**t, "max_rel_diff": diff, "bound_ms": bound,
                            "tflops": {var: cs.tflops(n, bh, s, d, True, ms)
                                       for var, ms in mean.items()}}
                print(f"{n} {key}: " + ", ".join(
                    f"{var} {[round(x, 4) for x in ts]} ms "
                    f"({entry[n]['tflops'][var]:.1f} TFLOP/s)"
                    for var, ts in t.items())
                    + f"; bound {bound:.4f} ms; outputs differ from this by "
                    + ", ".join(f"{var} {x:.3g}" for var, x in diff.items())
                    + " of the largest", flush=True)
            pair_ms = {var: sum(sum(entry[n][var]) / len(entry[n][var])
                                for n in names) for var in variants}
            print(f"pair {key}, mean of turns: " + ", ".join(
                f"{var} {ms:.4f} ms ({ms / sdpa:.2f}x SDPA, this "
                f"{ms / pair_ms['this']:.2f}x faster)"
                for var, ms in pair_ms.items())
                + f"; SDPA backward {sdpa:.4f} ms", flush=True)
            entry["pair_ms"] = pair_ms
            result[key] = entry
            del q, k, v, do, o, lse, delta, outs, variants, q4, k4, v4, o4
            torch.cuda.empty_cache()
    finally:
        fa._lib = real
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
