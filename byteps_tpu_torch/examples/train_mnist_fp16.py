"""Half-precision training with fp32 master weights on the port.

The native counterpart of ``example/torch/train_mnist_fp16_byteps.py`` (the
reference's imagenet18 recipe): the model in float16, gradients on the wire
cast by ``Compression.fp16``, an fp32 master copy taking the updates, the
masters cast back after each step, a dynamic or static loss scale.  The
same arguments, data and printed lines; the model and the batch live on
``--device`` (default CUDA).

    python -m byteps_tpu_torch.examples.train_mnist_fp16 --steps 30
"""

from __future__ import annotations

import argparse

import torch

import byteps_tpu_torch.torch as bps
from byteps_tpu_torch.examples._common import add_device_arg, device


def main(argv=None) -> dict:
    """Returns the first and last losses, the last accuracy and the loss
    scale."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--loss-scale", default="dynamic",
                    help='"dynamic" or a float like 1024')
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    torch.manual_seed(bps.rank())

    model = torch.nn.Sequential(
        torch.nn.Flatten(),
        torch.nn.Linear(28 * 28, 128), torch.nn.ReLU(),
        torch.nn.Linear(128, 10),
    ).to(torch.float16).to(dev)

    scale = args.loss_scale if args.loss_scale == "dynamic" \
        else float(args.loss_scale)
    opt = bps.HalfPrecisionDistributedOptimizer(
        model, lambda ps: torch.optim.SGD(ps, lr=args.lr),
        loss_scale=scale)
    bps.broadcast_fp16_parameters(opt, root_rank=0)

    gen = torch.Generator().manual_seed(0)  # same data on every worker
    # Learnable synthetic task: labels from a fixed random linear probe,
    # fixed batch (a convergence smoke).
    probe = torch.randn(28 * 28, 10, generator=gen)
    x = torch.randn(args.batch_size, 28, 28, generator=gen).half()
    y = (x.float().flatten(1) @ probe).argmax(-1)
    x, y = x.to(dev), y.to(dev)
    first_loss = last_loss = None
    acc = None
    for step in range(args.steps):
        opt.zero_grad()
        logits = model(x).float()
        loss = torch.nn.functional.cross_entropy(logits, y)
        opt.scale_loss(loss).backward()
        opt.step()
        last_loss = float(loss.detach())
        if first_loss is None:
            first_loss = last_loss
        if step % 10 == 0 or step == args.steps - 1:
            acc = float((logits.argmax(-1) == y).float().mean())
            print(f"step {step}: loss={last_loss:.4f} "
                  f"acc={acc:.3f} scale={opt.loss_scale:.0f} "
                  f"skipped={opt.steps_skipped}")
    if args.steps >= 20:
        assert last_loss < first_loss, (first_loss, last_loss)
    print("fp16 training done")
    bps.shutdown()
    return {"first_loss": first_loss, "last_loss": last_loss, "acc": acc,
            "loss_scale": opt.loss_scale,
            "steps_skipped": opt.steps_skipped}


if __name__ == "__main__":
    main()
