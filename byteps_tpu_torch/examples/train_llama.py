"""Train a llama-class decoder (RMSNorm + SwiGLU + RoPE + GQA) under the
port's DP path, or sharded over a mesh.

The native counterpart of ``example/jax/train_llama_byteps.py``: the same
arguments, the same printed lines.  DP is DistributedOptimizer(AdamW) +
build_train_step; ``--tp``, ``--zero1`` and ``--fsdp`` take the sharded
step (DTensor placements from the Megatron column/row specs of
``models.transformer.param_specs``; ZeRO-1 shards Adam's moments over dp,
FSDP the parameters too).  ``--attn flash`` runs the flash kernels.  The
batch is synthetic, from a seed; the model lives on ``--device`` (default
CUDA).

    python -m byteps_tpu_torch.examples.train_llama --steps 20
    python -m byteps_tpu_torch.examples.train_llama --tp 2 --model llama_tiny
    python -m byteps_tpu_torch.examples.train_llama --tp 2 --zero1
    python -m byteps_tpu_torch.examples.train_llama --fsdp
"""

from __future__ import annotations

import argparse

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.examples._common import (add_device_arg, device,
                                               join_world, shard)
from byteps_tpu_torch.models import transformer as tfm


def adamw(leaves):
    """optax.adamw(3e-3): its weight decay is 1e-4."""
    return torch.optim.AdamW(leaves, lr=3e-3, weight_decay=1e-4)


def main(argv=None) -> dict:
    """Returns the losses of every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="llama_tiny",
                    help="any llama_* config name (see transformer.CONFIGS)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree (DTensor-sharded params)")
    ap.add_argument("--attn", choices=["dense", "flash"], default="dense")
    ap.add_argument("--zero1", action="store_true",
                    help="shard optimizer state over dp (sharded step; "
                         "Adam moments drop to 1/dp per rank)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the params themselves over dp too "
                         "(ZeRO-3-style; params+grads+moments all 1/dp)")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    cfg = tfm.get_config(args.model, attn_impl=args.attn)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device=dev)
    toks, tgts = tfm.synthetic_batch(torch.Generator().manual_seed(1),
                                     args.batch_size, args.seq_len, cfg,
                                     device=dev)

    def loss_f(p, b):
        return tfm.loss_fn(p, b, cfg)

    if args.tp > 1 or args.zero1 or args.fsdp:
        # The sharded step: params stay column/row-split over 'tp' end to
        # end; --zero1 also splits the Adam moments over 'dp'; --fsdp
        # splits the params themselves over 'dp', the optimizer state
        # following them.  Every rank passes the global batch.
        join_world(dev)
        mesh = bps.make_mesh(tp=args.tp, device_type=dev.type)
        specs = tfm.param_specs(cfg)
        if args.fsdp:
            specs = bps.fsdp_param_specs(params, mesh, base_specs=specs)
        params = bps.shard_params(params, mesh, specs)
        z_specs = (bps.zero1_opt_specs(adamw, params, mesh, specs)
                   if args.zero1 else None)
        if args.zero1:
            opt = bps.zero1_init(adamw, params, mesh, specs,
                                 opt_specs=z_specs)
        elif args.fsdp:
            opt = bps.fsdp_init(adamw, params, mesh, specs)
        else:
            opt = adamw(tree_leaves(params))
        step = bps.build_sharded_train_step(
            loss_f, opt, mesh, specs, zero1=args.zero1, zero1_specs=z_specs)
        batch = (toks, tgts)
    else:
        opt = bps.DistributedOptimizer(adamw(tree_leaves(params)))
        step = bps.build_train_step(loss_f, opt, device=dev)
        batch = tuple(shard(t, bps.rank(), bps.size()) for t in (toks, tgts))

    losses = []
    for i in range(args.steps):
        losses.append(float(step(params, batch)))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i} loss {losses[-1]:.4f}", flush=True)
    first, last = losses[0], losses[-1]
    print(f"final: first={first:.4f} last={last:.4f} "
          f"improved={last < first}")
    bps.shutdown()
    return {"losses": losses}


if __name__ == "__main__":
    main()
