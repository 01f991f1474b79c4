#!/usr/bin/env python3
"""The wide flash kernels at D = 256 against the D = 256 instantiations.

    python3 scripts/flash_wide_at_256.py        # on one NVIDIA GPU (H100)

``byteps_tpu_torch/csrc/flash_attention.cu`` runs D = 256 on kernels
templated on D (two 128-column output passes inside one CTA) and every D
above 256 on the wide kernels (D at run time, one 128-column output slice a
CTA).  The wide kernels could take D = 256 too.  This builds a variant of
the source whose dispatch sends D = 256 to the wide launchers, and times
the six flash functions of each library at [128, 512, 256] (resident) and
[16, 8192, 256] (streaming), causal, in bf16, float16 and float32, in turns
shipped, wide, wide, shipped (CUDA events, medians).  It also prints the
largest difference between the two libraries' outputs over the largest
output element.  Prints the card's name and power limit, and one JSON line
of the times.
"""

from __future__ import annotations

import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import flash_refine_ab as ab  # noqa: E402

ab.VARIANTS = {"wide": ("if ((d) > 256) {", "if ((d) >= 256) {")}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("flash_wide_at_256: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ab.ROOT)
    import chip_smoke as cs
    from byteps_tpu_torch.ops import _build, flash_attention as fa
    with ThreadPoolExecutor(2) as pool:
        shipped = pool.submit(fa.build)
        wide = pool.submit(ab.build_variant, _build, "wide")
        shipped.result()
        libs = {"shipped": fa._lib(), "wide": ab.load(fa, wide.result())}
    real = fa._lib
    order = ["shipped", "wide", "wide", "shipped"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    try:
        for (bh, s, d), fam, reps in (((128, 512, 256), "", (10, 3)),
                                      ((16, 8192, 256), "_str", (1, 3))):
            for dt in (torch.bfloat16, torch.float16, torch.float32):
                q, k, v, do = (torch.randn(bh, s, d, generator=gen,
                                           device="cuda").to(dt)
                               for _ in range(4))
                sc = d ** -0.5
                fwd, dq_fn, dkv_fn = (getattr(fa, n + fam) for n in (
                    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
                o, lse = fwd(q, k, v, True, sc)
                _, delta = dq_fn(q, k, v, o, lse, do, True, sc)
                calls = {
                    "flash_fwd" + fam: lambda: fwd(q, k, v, True, sc),
                    "flash_bwd_dq" + fam:
                        lambda: dq_fn(q, k, v, o, lse, do, True, sc),
                    "flash_bwd_dkv" + fam:
                        lambda: dkv_fn(q, k, v, do, lse, delta, True, sc)}
                outs = {}
                for var in ("shipped", "wide"):
                    fa._lib = lambda lib=libs[var]: lib
                    outs[var] = {n: [t.float() for t in fn()]
                                 for n, fn in calls.items()}
                times = {n: {var: [] for var in libs} for n in calls}
                for var in order:
                    fa._lib = lambda lib=libs[var]: lib
                    for n, fn in calls.items():
                        times[n][var].append(cs.time_ms(fn, *reps))
                fa._lib = real
                tag = str(dt).replace("torch.", "")
                for n, t in times.items():
                    diff = max(float((a - b).abs().max() / b.abs().max())
                               for a, b in zip(outs["wide"][n],
                                               outs["shipped"][n]))
                    key = f"{n} [{bh},{s},{d}] {tag}"
                    result[key] = {**t, "max_rel_diff": diff}
                    print(f"{key} causal: " + ", ".join(
                        f"{var} {[round(x, 4) for x in ts]} ms"
                        for var, ts in t.items())
                        + f", wide/shipped outputs differ by {diff:.3g}"
                        " of the largest", flush=True)
                del q, k, v, do, o, lse, delta, outs
                torch.cuda.empty_cache()
    finally:
        fa._lib = real
    print(cs.sh(["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"]).splitlines()[0])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
