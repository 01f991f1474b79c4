"""Hybrid-parallel training: dp x tp x sp x pp x ep in one step.

The native counterpart of ``example/jax/train_hybrid_parallel.py``: the
same arguments, the same printed lines.  ``models.hybrid`` runs this
rank's part of the step over ``make_mesh(dp, tp, sp, pp, ep)``'s process
groups: Megatron TP, GPipe over ``--microbatches``, Switch-MoE with
``--experts``, ring attention over sp.  Tokens are synthetic, from a seed;
the model lives on ``--device`` (default CUDA).  Run one process a rank
(``DMLC_NUM_WORKER`` of them, through the launcher); a world of one runs
every axis at 1.

    python -m byteps_tpu_torch.examples.train_hybrid_parallel \\
        --pp 2 --dp 2 --tp 2
    python -m byteps_tpu_torch.examples.train_hybrid_parallel \\
        --ep 4 --dp 2 --experts 8
"""

from __future__ import annotations

import argparse

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.examples._common import (add_device_arg, device,
                                               join_world)
from byteps_tpu_torch.models import hybrid


def adamw(leaves):
    """optax.adamw(1e-3): its weight decay is 1e-4."""
    return torch.optim.AdamW(leaves, lr=1e-3, weight_decay=1e-4)


def main(argv=None) -> dict:
    """Returns the losses of every step."""
    ap = argparse.ArgumentParser()
    for ax in ("dp", "tp", "sp", "pp", "ep"):
        ap.add_argument(f"--{ax}", type=int, default=1)
    ap.add_argument("--experts", type=int, default=0)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=2)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    join_world(dev)
    mesh = bps.make_mesh(dp=args.dp, tp=args.tp, sp=args.sp, pp=args.pp,
                         ep=args.ep, device_type=dev.type)
    cfg = hybrid.HybridConfig(
        vocab_size=1024, num_layers=args.layers, d_model=args.d_model,
        num_heads=8, d_ff=4 * args.d_model, max_seq_len=128,
        num_experts=args.experts)
    step, init_fn = hybrid.build_hybrid_train_step(
        cfg, adamw, mesh, num_microbatches=args.microbatches)
    params = init_fn(torch.Generator().manual_seed(0))

    B = 4 * max(args.dp * args.ep, 1) * args.microbatches
    S = 32 * args.sp
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    tgts = torch.roll(toks, -1, dims=1)
    losses = []
    for i in range(args.steps):
        losses.append(float(step(params, (toks, tgts))))
        print(f"step {i}: loss={losses[-1]:.4f}")
    bps.shutdown()
    return {"losses": losses}


if __name__ == "__main__":
    main()
