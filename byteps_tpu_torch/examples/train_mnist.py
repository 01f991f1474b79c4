"""Train an MNIST-style MLP with the port's Horovod face.

The native counterpart of ``example/torch/train_mnist_torch_byteps.py``:
broadcast the initial state, wrap the optimizer in DistributedOptimizer
(each gradient's push_pull launched from its post-accumulate hook), train,
report.  The same arguments, the same synthetic data from the seed
(nothing is downloaded) and the same printed lines; the model and the
data live on ``--device`` (default CUDA).

    python -m byteps_tpu_torch.examples.train_mnist --epochs 2
    python -m byteps_tpu_torch.examples.train_mnist --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

import byteps_tpu_torch.torch as bps
from byteps_tpu_torch.examples._common import add_device_arg, device


class Net(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = torch.nn.Linear(784, 128)
        self.fc2 = torch.nn.Linear(128, 10)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x.flatten(1))))


def synthetic_mnist(n=4096, seed=0):
    """Class-conditioned Gaussian blobs in pixel space: learnable, fast.

    The class prototypes come from a fixed seed so every worker sees the
    same task; only the per-worker sample draw varies with ``seed``.
    """
    protos = np.random.RandomState(0).randn(10, 784).astype(np.float32)
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, size=n)
    x = protos[y] + 0.5 * rng.randn(n, 784).astype(np.float32)
    return (torch.from_numpy(x.reshape(n, 1, 28, 28)),
            torch.from_numpy(y.astype(np.int64)))


def main(argv=None) -> dict:
    """Returns the last epoch's loss and accuracy."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=0.05)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    torch.manual_seed(42 + bps.rank())

    model = Net().to(dev)           # drawn on the CPU: the same weights
    opt = torch.optim.SGD(model.parameters(), lr=args.lr)
    opt = bps.DistributedOptimizer(
        opt, named_parameters=model.named_parameters())

    # Every worker starts from rank 0's weights.
    bps.broadcast_parameters(model.state_dict(), root_rank=0)

    x, y = synthetic_mnist(seed=bps.rank())  # each worker gets its shard
    x, y = x.to(dev), y.to(dev)
    n = x.shape[0]
    result = {}
    for epoch in range(args.epochs):
        perm = torch.randperm(n).to(dev)
        total, correct, loss_sum = 0, 0, 0.0
        for i in range(0, n, args.batch_size):
            idx = perm[i:i + args.batch_size]
            xb, yb = x[idx], y[idx]
            opt.zero_grad()
            logits = model(xb)
            loss = F.cross_entropy(logits, yb)
            loss.backward()
            opt.step()
            loss_sum += float(loss.detach()) * len(idx)
            correct += int((logits.argmax(1) == yb).sum())
            total += len(idx)
        result = {"loss": loss_sum / total, "acc": correct / total}
        print(f"rank {bps.rank()}/{bps.size()} epoch {epoch}: "
              f"loss={result['loss']:.4f} acc={result['acc']:.3f}")
    bps.shutdown()
    return result


if __name__ == "__main__":
    main()
