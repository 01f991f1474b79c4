"""Long-context training with ring attention over the sequence axis, or
with the flash kernels on the whole sequence.

The native counterpart of ``example/jax/train_long_context.py``: the same
arguments, the same printed lines.  ``--attn ring`` runs the hybrid model
over an ``--sp`` mesh (one process a rank): each rank holds [B, S/sp, D]
of the activations, numbers its positions from its block's start, and
K/V blocks travel around the sp ring (``ops/ring_attention.py``).
``--attn flash`` trains the ``tiny`` config under DistributedOptimizer on
the flash kernels with S whole (sp ignored): the S x S logits never exist.
Tokens are synthetic, from a seed; the model lives on ``--device``
(default CUDA).

    python -m byteps_tpu_torch.examples.train_long_context --sp 8 \\
        --seq-len 2048
    python -m byteps_tpu_torch.examples.train_long_context --attn flash
"""

from __future__ import annotations

import argparse

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.examples._common import (add_device_arg, device,
                                               join_world, shard)
from byteps_tpu_torch.models import hybrid


def adam(leaves):
    """optax.adam(1e-3)."""
    return torch.optim.Adam(leaves, lr=1e-3)


def main(argv=None) -> dict:
    """Returns the losses of every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--sp", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--attn", choices=["ring", "flash"], default="ring",
                    help="ring: sp-sharded ring attention; flash: the flash "
                         "kernels on the unsharded sequence (sp ignored)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    losses = []
    if args.attn == "flash":
        from byteps_tpu_torch.models import transformer as tfm
        cfg = tfm.get_config("tiny", causal=True, attn_impl="flash",
                             max_seq_len=args.seq_len, vocab_size=1024)
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=dev)
        opt = bps.DistributedOptimizer(adam(tree_leaves(params)))
        step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg),
                                    opt, device=dev)
        # One sequence a rank, as the JAX example's one a device.
        batch = tfm.synthetic_batch(torch.Generator().manual_seed(1),
                                    bps.size(), args.seq_len, cfg,
                                    device=dev)
        batch = tuple(shard(t, bps.rank(), bps.size()) for t in batch)
        for i in range(args.steps):
            losses.append(float(step(params, batch)))
            print(f"step {i}: loss={losses[-1]:.4f} "
                  f"(flash, seq_len={args.seq_len})")
        bps.shutdown()
        return {"losses": losses}
    join_world(dev)
    mesh = bps.make_mesh(sp=args.sp, device_type=dev.type)
    cfg = hybrid.HybridConfig(vocab_size=1024, num_layers=2, d_model=64,
                              num_heads=4, d_ff=128,
                              max_seq_len=args.seq_len)
    step, init_fn = hybrid.build_hybrid_train_step(cfg, adam, mesh)
    params = init_fn(torch.Generator().manual_seed(0))

    toks = torch.randint(0, cfg.vocab_size, (4, args.seq_len),
                         generator=torch.Generator().manual_seed(1))
    tgts = torch.roll(toks, -1, dims=1)
    for i in range(args.steps):
        losses.append(float(step(params, (toks, tgts))))
        print(f"step {i}: loss={losses[-1]:.4f} (seq_len={args.seq_len})")
    bps.shutdown()
    return {"losses": losses}


if __name__ == "__main__":
    main()
