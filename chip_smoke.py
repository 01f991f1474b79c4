#!/usr/bin/env python3
"""Smoke run of byteps_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass:

1. Build the package's CUDA kernels from ``byteps_tpu_torch/csrc/`` (nvcc,
   sm_90a) and print the toolchain.
2. Hold each kernel against its plain PyTorch version on the card: the
   flagship attention shape [8*16, 512, 64] bf16, causal and not, and a
   small float32 shape through the autograd op with block_q != block_k.
   Time kernel, plain version and, for the forward, PyTorch's
   scaled_dot_product_attention (timed as a yardstick only).
3. Small-input reference: the tiny transformer's loss and gradients with
   flash attention (the kernels) against dense attention, on the card.
4. The main path: the flagship configuration (bert_large geometry, causal,
   vocab 32768, seq 512, batch 8, bf16 over f32 masters, per-layer remat,
   streamed LM head, flash attention) trained for 5 steps with
   DistributedOptimizer(AdamW) + build_train_step.  Every loss must be
   finite, the last below the first, and each step must launch flash_fwd
   48 times and flash_bwd_dq / flash_bwd_dkv 24 times each.  One more
   step then runs under torch.profiler for the device-time breakdown.

Prints a ``{"kernels": [...]}`` line, the card's name and power limit, and
as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero,
without that line, when there is no CUDA device or any phase fails.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 tensor-core peak

SOURCE = "byteps_tpu_torch/csrc/flash_attention.cu"
REPLACES = {
    "flash_fwd": "byteps_tpu/ops/flash_attention.py:142",
    "flash_bwd_dq": "byteps_tpu/ops/flash_attention.py:168",
    "flash_bwd_dkv": "byteps_tpu/ops/flash_attention.py:192",
}
FLAGSHIP = dict(batch=8, heads=16, seq=512, head_dim=64)
STEPS = 5


def sh(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=120).stdout.strip()


def time_ms(fn, reps=20, rounds=5):
    """Median over rounds of the mean time per call (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def max_err(a, b):
    return float((a.detach().float() - b.detach().float()).abs().max())


def rel_err(a, b):
    return max_err(a, b) / (float(b.detach().float().abs().max()) + 1e-12)


class Checks:
    def __init__(self):
        self.failures = []

    def __call__(self, ok, what):
        print(f"  [{'ok' if ok else 'FAIL'}] {what}")
        if not ok:
            self.failures.append(what)


def bound_ms(name, bh, s, d, itemsize, causal):
    """Least time for the work: each input read and each output written
    once over HBM bandwidth, or the products' FLOPs over the bf16 peak
    (counting only the visible logits under causal masking)."""
    n = bh * s * d
    rows = bh * s * 4                      # one float32 per row (lse/delta)
    pairs = bh * (s * (s + 1) // 2 if causal else s * s)
    if name == "flash_fwd":                # q,k,v -> o, lse
        nbytes, flops = 4 * n * itemsize + rows, 4 * pairs * d
    elif name == "flash_bwd_dq":           # q,k,v,o,dO,lse -> dq, delta
        nbytes, flops = 6 * n * itemsize + 2 * rows, 6 * pairs * d
    else:                                  # q,k,v,dO,lse,delta -> dk, dv
        nbytes, flops = 6 * n * itemsize + 2 * rows, 8 * pairs * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_build(fa, build_mod, torch, gpu):
    t0 = time.perf_counter()
    fa.build()
    secs = time.perf_counter() - t0
    nvcc = sh([build_mod.nvcc_path(), "--version"]).splitlines()
    release = next((l for l in nvcc if "release" in l), "")
    print(f"toolchain: torch {torch.__version__} cuda {torch.version.cuda} "
          f"| nvcc: {nvcc[0] if nvcc else '?'} | {release} "
          f"| build {secs:.1f} s | {gpu}")
    for line in build_mod.build_logs.get(fa.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


def phase_kernels(fa, torch, check):
    """Kernel vs plain version; returns per-kernel numbers (causal)."""
    import torch.nn.functional as F
    B, H, S, D = (FLAGSHIP[k] for k in ("batch", "heads", "seq", "head_dim"))
    BH = B * H
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    q, k, v, do = (rnd(BH, S, D) for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out = {}
    for causal in (True, False):
        tag = f"[{BH},{S},{D}] bf16 causal={causal}"
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale)
        o_k, lse_k = fa.flash_fwd(q, k, v, causal, scale)
        torch.cuda.synchronize()
        e_o, e_lse = max_err(o_k, o_p), max_err(lse_k, lse_p)
        check(e_o <= 2e-2 and e_lse <= 1e-3,
              f"flash_fwd {tag}: max|dO|={e_o:.3g} (tol 2e-2), "
              f"max|dLSE|={e_lse:.3g} (tol 1e-3)")
        dq_p, delta_p = fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do,
                                              causal, scale)
        dq_k, delta_k = fa.flash_bwd_dq(q, k, v, o_p, lse_p, do, causal,
                                        scale)
        torch.cuda.synchronize()
        r_dq, e_delta = rel_err(dq_k, dq_p), max_err(delta_k, delta_p)
        check(r_dq <= 2e-2 and e_delta <= 1e-3,
              f"flash_bwd_dq {tag}: max|ddQ|/max|dQ|={r_dq:.3g} (tol 2e-2),"
              f" max|ddelta|={e_delta:.3g} (tol 1e-3)")
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p,
                                            causal, scale)
        dk_k, dv_k = fa.flash_bwd_dkv(q, k, v, do, lse_p, delta_p, causal,
                                      scale)
        torch.cuda.synchronize()
        r_dk, r_dv = rel_err(dk_k, dk_p), rel_err(dv_k, dv_p)
        check(r_dk <= 2e-2 and r_dv <= 2e-2,
              f"flash_bwd_dkv {tag}: rel dK={r_dk:.3g}, rel dV={r_dv:.3g} "
              f"(tol 2e-2)")
        if not causal:
            continue
        q4, k4, v4 = (t.view(B, H, S, D) for t in (q, k, v))
        timings = {
            "flash_fwd": (
                lambda: fa.flash_fwd(q, k, v, True, scale),
                lambda: fa.flash_fwd_plain(q, k, v, True, scale),
                lambda: F.scaled_dot_product_attention(q4, k4, v4,
                                                       is_causal=True),
                max(e_o, e_lse)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, o_p, lse_p, do, True, scale),
                lambda: fa.flash_bwd_dq_plain(q, k, v, o_p, lse_p, do, True,
                                              scale),
                None, max(max_err(dq_k, dq_p), e_delta)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse_p, delta_p, True,
                                         scale),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta_p,
                                               True, scale),
                None, max(max_err(dk_k, dk_p), max_err(dv_k, dv_p))),
        }
        for name, (kern, plain, lib, err) in timings.items():
            b_ms, b_by = bound_ms(name, BH, S, D, 2, True)
            out[name] = {
                "max_abs_err": err,
                "ms": time_ms(kern),
                "plain_ms": time_ms(plain, reps=5),
                "bound_ms": b_ms,
                "bound_by": b_by,
                "library_ms": time_ms(lib) if lib is not None else None,
            }
            print(f"  {name}: kernel {out[name]['ms']:.4f} ms, plain "
                  f"{out[name]['plain_ms']:.4f} ms, library "
                  f"{out[name]['library_ms']} ms, bound {b_ms:.4f} ms "
                  f"({b_by})")

    # Small float32 shape through the autograd op, block_q != block_k.
    for causal in (True, False):
        qs, ks, vs, dos = (rnd(4, 256, 64, dtype=torch.float32)
                           for _ in range(4))
        qs.requires_grad_()
        ks.requires_grad_()
        vs.requires_grad_()
        o = fa.flash_attention(qs, ks, vs, causal, None, 64, 128)
        gq, gk, gv = torch.autograd.grad(o, (qs, ks, vs), dos)
        torch.cuda.synchronize()
        sc = 1.0 / math.sqrt(64)
        with torch.no_grad():
            o_p, lse_p = fa.flash_fwd_plain(qs, ks, vs, causal, sc)
            pq, delta = fa.flash_bwd_dq_plain(qs, ks, vs, o_p, lse_p, dos,
                                              causal, sc)
            pk, pv = fa.flash_bwd_dkv_plain(qs, ks, vs, dos, lse_p, delta,
                                            causal, sc)
        fwd_ok = bool(torch.allclose(o, o_p, atol=2e-5, rtol=1e-4))
        rels = [rel_err(a, b) for a, b in ((gq, pq), (gk, pk), (gv, pv))]
        check(fwd_ok and max(rels) <= 1e-4,
              f"flash_attention [4,256,64] f32 causal={causal} "
              f"block_q=64 block_k=128: fwd max err {max_err(o, o_p):.3g} "
              f"(atol 2e-5 rtol 1e-4), grads rel {max(rels):.3g} (tol 1e-4)")
    return out


def phase_small_model(tfm, torch, check):
    """The tiny transformer: flash (kernels) vs dense, loss and grads, at
    the JAX package's own end-to-end tolerance (loss 2e-3, grads 5e-3)."""
    from byteps_tpu_torch.common.tree import tree_leaves
    cfg_f = tfm.get_config("tiny", causal=True, attn_impl="flash")
    cfg_d = tfm.get_config("tiny", causal=True, attn_impl="dense")
    gen = torch.Generator().manual_seed(0)
    params = tfm.init_params(gen, cfg_f)
    batch = tfm.synthetic_batch(gen, 4, 128, cfg_f)

    def loss_grads(cfg):
        loss = tfm.loss_fn(params, batch, cfg)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        return float(loss.detach()), grads

    lf, gf = loss_grads(cfg_f)
    ld, gd = loss_grads(cfg_d)
    gerr = max(max_err(a, b) for a, b in zip(gf, gd))
    check(math.isfinite(lf) and abs(lf - ld) < 2e-3 and gerr < 5e-3,
          f"tiny transformer flash vs dense: loss {lf:.6f} vs {ld:.6f}, "
          f"max grad err {gerr:.3g}")


def phase_flagship(bps, tfm, fa, torch, check, gpu):
    from byteps_tpu_torch.common.tree import tree_leaves
    B, S = FLAGSHIP["batch"], FLAGSHIP["seq"]
    # bench.py:299-302 with its flagship defaults: flash attention with the
    # auto block (512 at S=512), remat "none", 2048-row streamed LM head.
    cfg = tfm.get_config("bert_large", causal=True, vocab_size=32768,
                         max_seq_len=S, ce_chunk_rows=2048,
                         attn_impl="flash",
                         attn_block=tfm.flash_auto_block(S))
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg)
    batch = tfm.synthetic_batch(torch.Generator().manual_seed(1), B, S, cfg)
    opt = bps.DistributedOptimizer(torch.optim.AdamW(
        tree_leaves(params), lr=1e-4, weight_decay=1e-4))
    step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)
    print(f"  flagship: {tfm.num_params(params)} params, batch {B} x seq "
          f"{S}, remat={cfg.remat}/{cfg.remat_policy}, ce_chunk_rows="
          f"{cfg.ce_chunk_rows}, attn={cfg.attn_impl}/{cfg.attn_block}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    fa.reset_launches()
    for _ in range(STEPS):
        before = dict(fa.launches)
        t0 = time.perf_counter()
        loss = float(step(params, batch))     # waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        per_step.append({n: fa.launches[n] - before[n] for n in before})
    launches = dict(fa.launches)
    steady = statistics.median(step_ms[1:])
    print(f"  losses {losses}")
    print(f"  step ms {[round(t, 3) for t in step_ms]}; steady median "
          f"{steady:.3f} ms = {B * S / steady * 1e3:.1f} tokens/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"({gpu})")
    check(all(math.isfinite(l) for l in losses), "every loss is finite")
    check(losses[-1] < losses[0],
          f"loss falls: {losses[0]:.5f} -> {losses[-1]:.5f}")
    want = {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}
    check(all(p == want for p in per_step),
          f"launches per step {per_step[-1]} == {want} in every step")
    check(all(launches[n] > 0 for n in want), f"main-path launches {launches}")
    phase_profile(step, params, batch, torch, steady)
    return launches, steady


def phase_profile(step, params, batch, torch, steady_ms):
    """One more flagship step under torch.profiler: device time by kernel
    group, and the device's idle share of the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms in kernels)
    if not kernels:
        print("  profile: no device time recorded (not measured)")
        return
    groups = {"flash kernels": 0.0, "matmul": 0.0, "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        if "flash_" in low and "kernel" in low:
            groups["flash kernels"] += ms
        elif any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    print(f"  profiled step: wall {wall_ms:.3f} ms with the profiler on; "
          f"device busy {busy:.3f} ms; idle share of the unprofiled "
          f"{steady_ms:.3f} ms step {1 - busy / steady_ms:.4f}")
    print("  by group: " + ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.4f})"
                                     for g, ms in groups.items()))
    for name, ms in sorted(kernels, key=lambda r: -r[1])[:8]:
        print(f"    {ms:9.3f} ms  {name[:100]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import transformer as tfm
    from byteps_tpu_torch.ops import _build, flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    gpu = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    check = Checks()
    t_start = time.perf_counter()

    print("== phase 1: build")
    phase_build(fa, _build, torch, gpu)
    print("== phase 2: kernels vs plain versions")
    numbers = phase_kernels(fa, torch, check)
    print("== phase 3: tiny transformer, flash vs dense")
    phase_small_model(tfm, torch, check)
    print("== phase 4: flagship training (main path)")
    launches, steady = phase_flagship(bps, tfm, fa, torch, check, gpu)
    print(f"total {time.perf_counter() - t_start:.1f} s")

    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed:",
              file=sys.stderr)
        for f in check.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], "launches": launches[name],
                **numbers[name]} for name in REPLACES]
    print(json.dumps({"flagship_step_ms": steady, "flagship_tokens_per_s":
                      FLAGSHIP["batch"] * FLAGSHIP["seq"] / steady * 1e3}))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
