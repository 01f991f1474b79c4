#!/usr/bin/env python3
"""Two float32 accuracy facts behind choices in byteps_tpu_torch, measured
on the CPU against float64.

    JAX_PLATFORMS=cpu PYTHONPATH=. python3 scripts/cpu_precision_checks.py

1. delta = rowsum(dO * O) of causal attention at [128, 512, D]: how far a
   float32 sum lies from the float64 value, on the flash kernels' delta
   gate (|err| <= 1e-5 |delta| + 1e-6; readings above 1 miss it).  The
   reason the kernels and the plain versions sum delta in float64.
2. VGG16 at 64 x 64, batch 2: the relative L2 distance of the first
   convolution's kernel gradient from its float64 value, for flax in
   float32 and for byteps_tpu_torch.models.cnn in float32 on the same
   variables.  The reason tests/test_torch_port_cnn.py holds VGG16 to
   flax computed in float64.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "tests"))


def delta_readings():
    torch.manual_seed(0)
    bh, s = 128, 512
    keep = torch.ones(s, s, dtype=torch.bool).tril()
    for d in (256, 384, 512, 1024):
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(bh, s, d).to(dt) for _ in range(4))
            logits = (d ** -0.5) * (q.double() @ k.double().transpose(-1, -2))
            p = torch.softmax(logits.masked_fill(~keep, float("-inf")), -1)
            o = (p @ v.double()).to(dt)
            truth = (do.double() * o.double()).sum(-1)
            f32 = (do.float() * o.float()).sum(-1).double()
            worst = ((f32 - truth).abs() / (truth.abs() * 1e-5 + 1e-6)).max()
            print(f"delta D={d} {str(dt)[6:]}: float32 sum vs float64, "
                  f"worst/gate {float(worst):.3f}")


def vgg_readings():
    import jax
    import test_torch_port_cnn as T

    _, _, _, g32 = T._flax("vgg16", 64, 0, x64=False)
    variables, batch, _, g64 = T._flax("vgg16", 64, 0, x64=True)
    model, _ = T._port("vgg16", 64, variables, batch)
    want = np.asarray(g64["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
    flax32 = np.asarray(g32["Conv_0"]["kernel"]).transpose(3, 2, 0, 1)
    port32 = model.Conv_0.kernel.grad.numpy().astype(np.float64)

    def rel(a):
        return np.linalg.norm(a - want) / np.linalg.norm(want)
    print(f"VGG16 Conv_0 kernel gradient vs flax float64: flax float32 "
          f"{rel(flax32):.3g}, byteps_tpu_torch float32 {rel(port32):.3g} "
          f"(jax {jax.__version__}, torch {torch.__version__})")


if __name__ == "__main__":
    torch.set_num_threads(4)
    delta_readings()
    vgg_readings()
