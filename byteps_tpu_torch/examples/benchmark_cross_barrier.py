"""Cross-barrier benchmark for the port's Horovod face.

The native counterpart of ``example/torch/benchmark_cross_barrier_byteps.py``:
train the same synthetic model with the plain DistributedOptimizer (every
push_pull waited for before step()) and with CrossBarrier (per-parameter
updates applied as each gradient's push_pull completes; the next forward
waits per layer), and report steps/s for both.  Both runs start from the
same weights and take the same steps, so their parameters must agree: the
line after the reference's prints the largest relative difference.  On
``--device`` (default CUDA); the clock stops after the device has drained.

    python -m byteps_tpu_torch.examples.benchmark_cross_barrier --steps 30
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F

import byteps_tpu_torch.torch as bps
from byteps_tpu_torch.examples._common import add_device_arg, device


def make_model(width: int, depth: int) -> torch.nn.Module:
    layers = [l for _ in range(depth)
              for l in (torch.nn.Linear(width, width), torch.nn.ReLU())]
    return torch.nn.Sequential(*layers, torch.nn.Linear(width, 10))


def _drain(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(steps: int, width: int, depth: int, cross_barrier: bool,
        dev: torch.device):
    """Steps/s of ``steps`` timed steps after one warm-up step, and the
    model."""
    torch.manual_seed(0)
    model = make_model(width, depth).to(dev)
    inner = torch.optim.SGD(model.parameters(), lr=0.01)
    if cross_barrier:
        opt = bps.CrossBarrier(model, inner,
                               named_parameters=model.named_parameters())
    else:
        opt = bps.DistributedOptimizer(
            inner, named_parameters=model.named_parameters())
    x = torch.randn(64, width).to(dev)
    y = torch.randint(0, 10, (64,)).to(dev)
    # warm-up (the first dispatch declares the keys)
    F.cross_entropy(model(x), y).backward()
    opt.step()
    _drain(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        if not cross_barrier:
            opt.zero_grad()
        F.cross_entropy(model(x), y).backward()
        opt.step()
    if cross_barrier:
        opt.synchronize()   # every update applied before the clock stops
        opt.close()
    _drain(dev)
    dt = time.perf_counter() - t0
    return steps / dt, model


def main(argv=None) -> dict:
    """Returns both rates and the largest relative difference of the two
    runs' parameters (L2 per tensor)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depth", type=int, default=6)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    base, m_base = run(args.steps, args.width, args.depth, False, dev)
    xb, m_xb = run(args.steps, args.width, args.depth, True, dev)
    print(f"rank {bps.rank()}/{bps.size()}: "
          f"baseline {base:.1f} steps/s, cross-barrier {xb:.1f} steps/s "
          f"({xb / base:.2f}x)")
    rel = max(float((a.detach() - b.detach()).norm() / b.detach().norm())
              for a, b in zip(m_xb.parameters(), m_base.parameters()))
    print(f"params after {args.steps + 1} steps: cross-barrier vs "
          f"baseline, largest relative difference {rel:.3g}")
    bps.shutdown()
    return {"baseline_steps_per_s": base, "cross_barrier_steps_per_s": xb,
            "params_rel_diff": rel}


if __name__ == "__main__":
    main()
