#!/usr/bin/env python3
"""Smoke run of byteps_tpu_torch on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass:

1. Build the package's CUDA kernels from ``byteps_tpu_torch/csrc/`` (one
   nvcc per source, all started together; sm_90a) and print the toolchain
   and each kernel's ptxas report.
2. Hold each flash kernel against its plain PyTorch version on the card:
   the flagship attention shape [8*16, 512, 64] bf16, causal and not, and
   a small float32 shape through the autograd op with block_q != block_k.
   Time kernel, plain version and, as yardsticks only, PyTorch's
   scaled_dot_product_attention forward and its backward (dQ, dK and dV
   in one call, set beside the sum of the two backward kernels).
2b. The sign-bit kernels against their plain versions, bit for bit, at
   n = 1,048,576 (the flagship's bucket), 845,824 (its ragged bucket),
   4096*33, 5000, 100 and 1, on inputs with +-0.0, +-inf and NaNs of both
   signs; timed at n = 1,048,576.
2c. Onebit and dithering (s = 127 and 15) on one flagship-size bucket:
   the CUDA run (kernels) against the same compressor on a CPU copy (plain
   versions) from the same state, two rounds: words and levels
   bit-identical, floats within 1e-6 relative.
3. Small-input reference: the tiny transformer's loss and gradients with
   flash attention (the kernels) against dense attention, on the card.
4. The main path: the flagship configuration (bert_large geometry, causal,
   vocab 32768, seq 512, batch 8, bf16 over f32 masters, per-layer remat,
   streamed LM head, flash attention) trained for 5 steps with
   DistributedOptimizer(AdamW) + build_train_step.  Every loss must be
   finite, the last below the first, and each step must launch flash_fwd
   48 times and flash_bwd_dq / flash_bwd_dkv 24 times each.  One more
   step then runs under torch.profiler for the device-time breakdown.
4b. The compressed main path: the same flagship under
   DistributedOptimizer(AdamW, inter_compressor=onebit + EF + Nesterov)
   for 5 steps.  First, on the first step's gradients, the compressed
   reduction on the card against the same reduction on a CPU copy: every
   bucket's sign words equal, reduced values within 1e-6 relative.  Then
   finite, falling losses; exactly 642 sign_pack and 1,284 sign_unpack
   launches per step (2 and 4 for each of the 321 buckets) with the flash
   launches still 48/24/24; step time, peak memory and a profiled step.

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

FLASH_SOURCE = "byteps_tpu_torch/csrc/flash_attention.cu"
BITPACK_SOURCE = "byteps_tpu_torch/csrc/bitpack.cu"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": (FLASH_SOURCE, "byteps_tpu/ops/flash_attention.py:142"),
    "flash_bwd_dq": (FLASH_SOURCE, "byteps_tpu/ops/flash_attention.py:168"),
    "flash_bwd_dkv": (FLASH_SOURCE, "byteps_tpu/ops/flash_attention.py:192"),
    "sign_pack": (BITPACK_SOURCE, "byteps_tpu/ops/compressor/bitpack.py:83"),
    "sign_unpack": (BITPACK_SOURCE,
                    "byteps_tpu/ops/compressor/bitpack.py:95"),
}
FLAGSHIP = dict(batch=8, heads=16, seq=512, head_dim=64)
STEPS = 5
BUCKET = 1048576              # elements of the flagship's 4 MiB buckets
RAGGED_BUCKET = 845824        # its one smaller bucket
COMPRESSOR = {"compressor": "onebit", "ef": "vanilla", "momentum": "nesterov"}
FLAGSHIP_BUCKETS = 321


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


def time_graph_ms(fn, reps=50, rounds=5):
    """Device time per call: ``reps`` calls captured in one CUDA graph,
    replayed; median over rounds.  Leaves out the host's launch overhead,
    which ``time_ms`` includes when a call is shorter than its launch."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
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


def phase_build(mods, build_mod, torch, gpu):
    """One nvcc per source, all started together, then load each."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: build_mod.build(m.SOURCE), mods))
    for m in mods:
        m.build()
    secs = time.perf_counter() - t0
    nvcc = sh([build_mod.nvcc_path(), "--version"]).splitlines()
    release = next((l for l in nvcc if "release" in l), "")
    print(f"toolchain: torch {torch.__version__} cuda {torch.version.cuda} "
          f"| nvcc: {nvcc[0] if nvcc else '?'} | {release} "
          f"| build {secs:.1f} s | {gpu}")
    for m in mods:
        for kernel, report in ptxas_reports(build_mod.build_logs.get(
                m.SOURCE, "")):
            print(f"  ptxas {m.SOURCE} {kernel}: {report}")


def ptxas_reports(log):
    """(kernel, 'N registers, spills') for each entry function ptxas
    compiled, the kernel named from its mangled name."""
    import re
    out, kernel = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            mangled = m.group(1)
            name = re.search(r"\d+((?:flash|sign)\w*?_kernel)", mangled)
            dims = re.search(r"Li(\d+)E", mangled)
            kernel = (name.group(1) if name else mangled) + (
                f"<{'bf16' if 'bfloat16' in mangled else 'f32'},"
                f"{dims.group(1)}>" if dims else "")
            spills = ""
        elif "spill" in line:
            spills = line.split(":", 1)[-1].strip()
        elif "registers" in line and kernel:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((kernel, f"{regs.group(1) if regs else '?'} "
                                f"registers; {spills}"))
            kernel = None
    return out


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
    out, yardsticks = {}, {}
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
        # Yardstick for the two backward kernels together: SDPA's backward
        # computes dQ, dK and dV in one call from its own saved forward.
        q4g, k4g, v4g = (t.detach().clone().requires_grad_()
                         for t in (q4, k4, v4))
        o4g = F.scaled_dot_product_attention(q4g, k4g, v4g, is_causal=True)
        do4 = do.view(B, H, S, D)
        yardsticks["sdpa_backward_ms"] = time_ms(
            lambda: torch.autograd.grad(o4g, (q4g, k4g, v4g), do4,
                                        retain_graph=True))
        yardsticks["flash_bwd_dq_plus_dkv_ms"] = (
            out["flash_bwd_dq"]["ms"] + out["flash_bwd_dkv"]["ms"])
        print(f"  SDPA backward (dQ+dK+dV, one call) "
              f"{yardsticks['sdpa_backward_ms']:.4f} ms vs flash_bwd_dq + "
              f"flash_bwd_dkv {yardsticks['flash_bwd_dq_plus_dkv_ms']:.4f} ms")

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
    return out, yardsticks


def signs_input(torch, n, seed):
    """Normal floats with +-0.0, +-inf and NaNs of both signs mixed in."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n, generator=gen, device="cuda")
    specials = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                             float("nan"), -float("nan")], device="cuda")
    at = torch.randint(0, n, (min(n, 4096),), generator=gen, device="cuda")
    x[at] = specials[torch.arange(at.numel(), device="cuda") % 6]
    return x


def bitpack_bound_ms(bp, n):
    """Least time for one pack or unpack of n elements: 4n float bytes and
    4 * words_len(n) word bytes over HBM bandwidth (no arithmetic to
    speak of)."""
    return (4 * n + 4 * bp.words_len(n)) / HBM_BYTES_PER_S * 1e3


def phase_bitpack(bp, torch, check):
    """The sign kernels against their plain versions, bit for bit."""
    out = {}
    for n in (BUCKET, RAGGED_BUCKET, 4096 * 33, 5000, 100, 1):
        x = signs_input(torch, n, n)
        w_k, w_p = bp.pack_signs(x), bp.pack_signs_plain(x)
        s_k, s_p = bp.unpack_signs(w_k, n), bp.unpack_signs_plain(w_k, n)
        rows = torch.stack([w_k, w_p.flip(0)])
        r_k, r_p = bp.unpack_signs(rows, n), bp.unpack_signs_plain(rows, n)
        torch.cuda.synchronize()
        ok = (w_k.shape == (bp.words_len(n),) and torch.equal(w_k, w_p)
              and torch.equal(s_k, s_p) and torch.equal(r_k, r_p)
              and torch.equal(s_k, torch.where(x < 0, -1.0, 1.0)))
        check(ok, f"sign_pack/sign_unpack n={n}: words, signs and 2-row "
                  f"unpack bit-identical to the plain versions (+-0, +-inf, "
                  f"NaN of both signs in the input)")
        if n != BUCKET:
            continue
        b_ms = bitpack_bound_ms(bp, n)
        for name, kern, plain, err in (
                ("sign_pack", lambda: bp.pack_signs(x),
                 lambda: bp.pack_signs_plain(x),
                 float((w_k.long() - w_p.long()).abs().max())),
                ("sign_unpack", lambda: bp.unpack_signs(w_k, n),
                 lambda: bp.unpack_signs_plain(w_k, n), max_err(s_k, s_p))):
            # Device times from CUDA-graph replay, for kernel and plain
            # version alike; the eager call time beside them is the host's.
            out[name] = {"max_abs_err": err, "ms": time_graph_ms(kern),
                         "plain_ms": time_graph_ms(plain, reps=10),
                         "bound_ms": b_ms, "bound_by": "bytes",
                         "library_ms": None}   # no PyTorch call packs bits
            eager = time_ms(kern, reps=100)
            print(f"  {name} n={n}: kernel {out[name]['ms']:.5f} ms, plain "
                  f"{out[name]['plain_ms']:.5f} ms (device, graph replay), "
                  f"bound {b_ms:.5f} ms (bytes), library none; eager call "
                  f"{eager:.5f} ms")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(v, device) for v in tree)
    return tree.to(device) if hasattr(tree, "to") else tree


def _compare(torch, got, want, what, check):
    """Payload or state dicts: int32 leaves bit-identical, floats within
    1e-6 relative (a mean over the bucket sums in another order)."""
    for key in sorted(want):
        g, w = got[key], want[key]
        if isinstance(w, dict):
            _compare(torch, g, w, f"{what}.{key}", check)
            continue
        g = g.cpu()
        if w.dtype == torch.int32:
            check(torch.equal(g, w), f"{what}.{key}: {tuple(w.shape)} int32 "
                                     f"bit-identical")
        else:
            r = rel_err(g, w)
            check(r <= 1e-6, f"{what}.{key}: rel err {r:.3g} (tol 1e-6)")


def phase_compressors(C, torch, check):
    """Onebit and dithering on one flagship-size bucket: CUDA (kernels)
    against a CPU copy (plain versions), from the same state."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    xs = [torch.randn(BUCKET, generator=gen, device="cuda") * (r + 1)
          for r in range(2)]
    for kw in ({"compressor": "dithering", "k": 127},
               {"compressor": "dithering", "k": 15},
               {"compressor": "onebit"}):
        comp = C.create(kw)
        st_c = comp.init_state(BUCKET, device=torch.device("cuda"))
        st_h = _to(st_c, "cpu")
        for r, x in enumerate(xs):
            p_c, st_c = comp.compress(x, st_c)
            p_h, st_h = comp.compress(x.cpu(), st_h)
            tag = f"{kw} round {r}"
            _compare(torch, p_c, p_h, f"{tag} payload", check)
            if st_h:
                _compare(torch, st_c, st_h, f"{tag} state", check)
            d_c, d_h = comp.decompress(p_c, BUCKET), comp.decompress(p_h,
                                                                    BUCKET)
            r_err = rel_err(d_c.cpu(), d_h)
            check(r_err <= 1e-6, f"{tag} decompress rel err {r_err:.3g} "
                                 f"(tol 1e-6)")


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


def flagship(tfm, bps, torch, inter_compressor=None):
    """The flagship's config, params, batch, optimizer and step (the
    compressed variant with ``inter_compressor``)."""
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
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(tree_leaves(params), lr=1e-4, weight_decay=1e-4),
        inter_compressor=inter_compressor)
    step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt)
    return cfg, params, batch, opt, step


def train(step, params, batch, counters, torch, check, gpu, want):
    """STEPS steps with every launch counter set to 0 just before and read
    just after; checks losses and that each step launched ``want``."""
    B, S = FLAGSHIP["batch"], FLAGSHIP["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for c in counters:
        c.reset_launches()

    def snapshot():
        return {n: v for c in counters for n, v in c.launches.items()}
    for _ in range(STEPS):
        before = snapshot()
        t0 = time.perf_counter()
        loss = float(step(params, batch))     # waits for the step
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        after = snapshot()
        per_step.append({n: after[n] - before[n] for n in want})
    launches = snapshot()
    steady = statistics.median(step_ms[1:])
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  losses {losses}")
    print(f"  step ms {[round(t, 3) for t in step_ms]}; steady median "
          f"{steady:.3f} ms = {B * S / steady * 1e3:.1f} tokens/s; peak "
          f"memory {peak:.2f} GiB ({gpu})")
    check(all(math.isfinite(l) for l in losses), "every loss is finite")
    check(losses[-1] < losses[0],
          f"loss falls: {losses[0]:.5f} -> {losses[-1]:.5f}")
    check(all(p == want for p in per_step),
          f"launches per step {per_step[-1]} == {want} in every step")
    check(all(launches[n] > 0 for n in want), f"main-path launches {launches}")
    return launches, steady, peak


def phase_flagship(bps, tfm, fa, torch, check, gpu):
    cfg, params, batch, opt, step = flagship(tfm, bps, torch)
    print(f"  flagship: {tfm.num_params(params)} params, batch "
          f"{FLAGSHIP['batch']} x seq {FLAGSHIP['seq']}, remat={cfg.remat}/"
          f"{cfg.remat_policy}, ce_chunk_rows={cfg.ce_chunk_rows}, attn="
          f"{cfg.attn_impl}/{cfg.attn_block}")
    want = {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24}
    launches, steady, _ = train(step, params, batch, [fa], torch, check, gpu,
                                want)
    phase_profile(step, params, batch, torch, steady)
    return launches, steady


def check_compressed_reduce(C, comp, opt, grads, torch, check):
    """The compressed reduction of the first step's gradients on the card
    against the same reduction on a CPU copy, from the optimizer's initial
    state: every sign word the two runs pack equal, reduced values within
    1e-6 relative (each bucket's onebit scale is a mean, summed in another
    order on the two devices)."""
    from byteps_tpu_torch.ops import collectives
    from byteps_tpu_torch.ops.compressor import onebit
    real = onebit.pack_signs

    def reduce(tree, state):
        words = []

        def record(x):
            w = real(x)
            words.append(w.cpu())
            return w
        onebit.pack_signs = record
        try:
            with collectives.local_mode():
                out, _ = C.compressed_tree_all_reduce(tree, comp, state)
        finally:
            onebit.pack_signs = real
        return [o.cpu() for o in out], words

    t0 = time.perf_counter()
    out_c, words_c = reduce(grads, opt.compression_state)
    torch.cuda.synchronize()
    out_h, words_h = reduce([g.cpu() for g in grads],
                            _to(opt.compression_state, "cpu"))
    same = len(words_c) == len(words_h) == 2 * FLAGSHIP_BUCKETS and all(
        torch.equal(a, b) for a, b in zip(words_c, words_h))
    check(same, f"compressed reduce, first step's gradients: all "
                f"{len(words_c)} packed word arrays (worker and server leg "
                f"of {FLAGSHIP_BUCKETS} buckets) equal on CUDA and CPU")
    worst = max(rel_err(a, b) for a, b in zip(out_c, out_h))
    check(worst <= 1e-6, f"compressed reduce: reduced leaves CUDA vs CPU max "
                         f"rel err {worst:.3g} (tol 1e-6) "
                         f"({time.perf_counter() - t0:.1f} s)")


def phase_flagship_compressed(bps, tfm, fa, bp, torch, check, gpu,
                              plain_steady):
    from byteps_tpu_torch.common.tree import tree_leaves
    C = bps.compressor
    comp = C.create(COMPRESSOR)
    cfg, params, batch, opt, step = flagship(tfm, bps, torch, comp)
    leaves = tree_leaves(params)
    sizes = C.reduce._bucket_sizes(leaves, None)
    compressed = [n for n in sizes if comp.payload_bytes(n) < 4 * n]
    state_bytes = sum(t.numel() * t.element_size()
                      for t in _leaves(opt.compression_state))
    print(f"  compressor {COMPRESSOR}: {len(sizes)} buckets, "
          f"{len(compressed)} compressed, sizes {sorted(set(sizes))}; "
          f"state {state_bytes / 2**30:.2f} GiB")
    check(len(compressed) == len(sizes) == FLAGSHIP_BUCKETS
          and RAGGED_BUCKET in sizes,
          f"{FLAGSHIP_BUCKETS} buckets, all compressed, the ragged one "
          f"({RAGGED_BUCKET}) among them")
    loss = tfm.loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    check_compressed_reduce(C, comp, opt, list(grads), torch, check)
    del loss, grads
    torch.cuda.empty_cache()

    want = {"flash_fwd": 48, "flash_bwd_dq": 24, "flash_bwd_dkv": 24,
            "sign_pack": 2 * len(compressed),
            "sign_unpack": 4 * len(compressed)}
    check(want["sign_pack"] == 642 and want["sign_unpack"] == 1284,
          f"expected bitpack launches per step {want}")
    launches, steady, peak = train(step, params, batch, [fa, bp], torch,
                                   check, gpu, want)
    print(f"  compressed step {steady:.3f} ms vs uncompressed "
          f"{plain_steady:.3f} ms (+{steady - plain_steady:.3f} ms)")
    bound = 6 * sum(bitpack_bound_ms(bp, n) for n in compressed)
    print(f"  bitpack bound per step: {bound:.4f} ms ({want['sign_pack']} "
          f"packs + {want['sign_unpack']} unpacks at their byte bounds)")
    phase_profile(step, params, batch, torch, steady, bitpack_bound=bound)
    return launches, steady, peak


def _leaves(state):
    if isinstance(state, dict):
        return [l for v in state.values() for l in _leaves(v)]
    if isinstance(state, (tuple, list)):
        return [l for v in state for l in _leaves(v)]
    return [] if state is None else [state]


def phase_profile(step, params, batch, torch, steady_ms, bitpack_bound=None):
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
    groups = {"flash kernels": 0.0, "bitpack kernels": 0.0, "matmul": 0.0,
              "other": 0.0}
    for name, ms in kernels:
        low = name.lower()
        if "flash_" in low and "kernel" in low:
            groups["flash kernels"] += ms
        elif "sign_pack" in low or "sign_unpack" in low:
            groups["bitpack kernels"] += ms
        elif any(s in low for s in ("gemm", "cutlass", "xmma", "nvjet")):
            groups["matmul"] += ms
        else:
            groups["other"] += ms
    print(f"  profiled step: wall {wall_ms:.3f} ms with the profiler on; "
          f"device busy {busy:.3f} ms; idle share of the unprofiled "
          f"{steady_ms:.3f} ms step {1 - busy / steady_ms:.4f}")
    print("  by group: " + ", ".join(f"{g} {ms:.3f} ms ({ms / busy:.4f})"
                                     for g, ms in groups.items()))
    if bitpack_bound is not None:
        print(f"  bitpack kernels {groups['bitpack kernels']:.3f} ms of "
              f"device time vs their {bitpack_bound:.4f} ms byte bound")
        host = sorted((e for e in prof.key_averages()
                       if e.self_cpu_time_total > 0),
                      key=lambda e: -e.self_cpu_time_total)[:10]
        print("  host time by op (self CPU ms, calls): " + ", ".join(
            f"{e.key} {e.self_cpu_time_total / 1e3:.2f} ({e.count})"
            for e in host))
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
    from byteps_tpu_torch.ops.compressor import bitpack as bp

    torch.backends.cuda.matmul.allow_tf32 = False   # full float32 matmuls
    torch.backends.cudnn.allow_tf32 = False
    gpu = sh(["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]).splitlines()[0]
    check = Checks()
    t_start = time.perf_counter()

    print("== phase 1: build")
    phase_build([fa, bp], _build, torch, gpu)
    print("== phase 2: flash kernels vs plain versions")
    numbers, yardsticks = phase_kernels(fa, torch, check)
    print("== phase 2b: sign-bit kernels vs plain versions")
    numbers.update(phase_bitpack(bp, torch, check))
    print("== phase 2c: compressors, CUDA vs CPU copy")
    phase_compressors(bps.compressor, torch, check)
    print("== phase 3: tiny transformer, flash vs dense")
    phase_small_model(tfm, torch, check)
    print("== phase 4: flagship training (main path)")
    launches, steady = phase_flagship(bps, tfm, fa, torch, check, gpu)
    torch.cuda.empty_cache()
    print("== phase 4b: compressed flagship training (main path)")
    c_launches, c_steady, c_peak = phase_flagship_compressed(
        bps, tfm, fa, bp, torch, check, gpu, steady)
    launches.update({n: c_launches[n] for n in bp.launches})
    print(f"total {time.perf_counter() - t_start:.1f} s")

    if check.failures:
        print(f"chip_smoke: {len(check.failures)} check(s) failed:",
              file=sys.stderr)
        for f in check.failures:
            print(f"  {f}", file=sys.stderr)
        return 1
    kernels = [{"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                **numbers[name]}
               for name, (source, replaces) in KERNELS.items()]
    tokens = FLAGSHIP["batch"] * FLAGSHIP["seq"]
    print(json.dumps({"flagship_step_ms": steady,
                      "flagship_tokens_per_s": tokens / steady * 1e3,
                      "compressed_step_ms": c_steady,
                      "compressed_tokens_per_s": tokens / c_steady * 1e3,
                      "compressed_peak_gib": c_peak, **yardsticks}))
    print(json.dumps({"kernels": kernels}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
