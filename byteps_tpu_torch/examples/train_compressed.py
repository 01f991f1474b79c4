"""Gradient-compression training.

The native counterpart of ``example/jax/train_compressed_byteps.py``: the
same arguments, the same printed lines.  An MLP trains under
DistributedOptimizer(SGD, inter_compressor=...) with the compressor built
from string kwargs (onebit, topk, randomk, dithering; error feedback and
Nesterov momentum on request); onebit and dithering pack their signs with
the ``sign_pack`` / ``sign_unpack`` kernels.  The data is synthetic, from
a seed; the model lives on ``--device`` (default CUDA).

    python -m byteps_tpu_torch.examples.train_compressed --compressor onebit \\
        --ef vanilla --momentum nesterov
    python -m byteps_tpu_torch.examples.train_compressed --compressor randomk \\
        --k 64
"""

from __future__ import annotations

import argparse

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.examples._common import add_device_arg, device, shard
from byteps_tpu_torch.models import mlp
from byteps_tpu_torch.ops import compressor as C


def main(argv=None) -> dict:
    """Returns the compression ratio and the losses of every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--compressor", default="onebit",
                    choices=C.known_compressors())
    ap.add_argument("--ef", default="", help="'vanilla' to enable")
    ap.add_argument("--momentum", default="", help="'nesterov' to enable")
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    kwargs = {"compressor": args.compressor, "k": args.k}
    if args.ef:
        kwargs["ef"] = args.ef
    if args.momentum:
        kwargs["momentum"] = args.momentum
    comp = C.create(kwargs)

    params = mlp.init_params(torch.Generator().manual_seed(0), (64, 128, 10),
                             device=dev)
    tree = {"w": torch.zeros(64 * 128 + 128 * 10)}
    ratio = C.compression_ratio(tree, comp)
    print(f"compressor={kwargs} ratio~{ratio:.1f}x")

    opt = bps.DistributedOptimizer(
        torch.optim.SGD(tree_leaves(params), lr=0.1), inter_compressor=comp)
    step = bps.build_train_step(mlp.loss_fn, opt, device=dev)

    x = torch.randn(512, 64, generator=torch.Generator().manual_seed(1))
    y = (x.sum(-1) > 0).long()
    batch = tuple(shard(t, bps.rank(), bps.size()).to(dev) for t in (x, y))
    losses = []
    for i in range(args.steps):
        losses.append(float(step(params, batch)))
        if i % 5 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}")
    bps.shutdown()
    return {"ratio": ratio, "losses": losses}


if __name__ == "__main__":
    main()
