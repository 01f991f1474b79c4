"""ResNet-50 ImageNet-style training.

The native counterpart of ``example/jax/train_imagenet_resnet_byteps.py``:
the same arguments, the same printed lines.  The model's initial variables
are broadcast from rank 0; SGD with Nesterov momentum runs on a
linear-scaled learning rate with warm-up, then cosine decay, under
DistributedOptimizer with fp16 wire compression; ``mark_step`` ticks the
trace window.  Synthetic images (ones) keep it hermetic; the model lives
on ``--device`` (default CUDA).

    python -m byteps_tpu_torch.examples.train_imagenet_resnet --model resnet50
"""

from __future__ import annotations

import argparse
import math

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.examples._common import add_device_arg, device
from byteps_tpu_torch.models import cnn


def cosine_decay(init_value: float, decay_steps: int):
    """optax.cosine_decay_schedule(init_value, decay_steps)."""
    return lambda step: init_value * 0.5 * (
        1 + math.cos(math.pi * min(step, decay_steps) / decay_steps))


def main(argv=None) -> dict:
    """Returns the losses of every step."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--base-lr", type=float, default=0.0125)
    ap.add_argument("--warmup-steps", type=int, default=100)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    model = cnn.create_cnn(args.model, num_classes=1000, device=dev, seed=0)
    x = torch.ones(args.batch_size, args.image_size, args.image_size, 3,
                   device=dev)
    # Every worker starts from rank 0's variables (the model holds them).
    variables = cnn.cnn_variables(model)
    with torch.no_grad():
        for mine, root in zip(tree_leaves(variables), tree_leaves(
                bps.broadcast_parameters(variables))):
            if root is not mine:
                mine.copy_(root)
    params = variables["params"]

    # linear-scaled LR with warmup (reference scales lr by world size and
    # warms up 5 epochs)
    schedule = bps.callbacks.warmup_schedule(
        bps.callbacks.scaled_lr(args.base_lr), args.warmup_steps,
        cosine_decay(bps.callbacks.scaled_lr(args.base_lr), 10_000))
    sgd = torch.optim.SGD(tree_leaves(params), lr=schedule(0), momentum=0.9,
                          nesterov=True)
    opt = bps.DistributedOptimizer(sgd, compression=bps.Compression.fp16)
    step = bps.build_train_step(cnn.cnn_loss_fn(model), opt, device=dev)

    labels = torch.zeros(args.batch_size, dtype=torch.long, device=dev)
    losses = []
    for i in range(args.steps):
        for group in sgd.param_groups:
            group["lr"] = schedule(i)
        losses.append(float(step(params, (x, labels))))
        bps.mark_step()
        if i % 2 == 0:
            print(f"step {i}: loss={losses[-1]:.4f}")
    bps.shutdown()
    return {"losses": losses}


if __name__ == "__main__":
    main()
