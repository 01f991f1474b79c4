"""Elastic suspend and resume.

The native counterpart of ``example/jax/elastic_benchmark_byteps.py``: the
same printed lines.  An MLP trains 5 steps, the job suspends (the process
group torn down, the declared-name registry kept), resumes with a new
cluster size, and trains 5 more, its declared tensors keeping their keys
in their original order.  The data is synthetic, from a seed; the model
lives on ``--device`` (default CUDA).  The keys are a fresh process's:
0 and 1 for the first two names declared.

    python -m byteps_tpu_torch.examples.elastic_benchmark
"""

from __future__ import annotations

import argparse

import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.examples._common import add_device_arg, device, shard
from byteps_tpu_torch.models import mlp


def train_steps(params, step, n, batch):
    for _ in range(n):
        loss = step(params, batch)
    return float(loss)


def main(argv=None) -> dict:
    """Returns both phases' last losses and the two keys after resume."""
    ap = argparse.ArgumentParser()
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    params = mlp.init_params(torch.Generator().manual_seed(0), (32, 64, 4),
                             device=dev)
    opt = bps.DistributedOptimizer(
        torch.optim.SGD(tree_leaves(params), lr=0.1))
    step = bps.build_train_step(mlp.loss_fn, opt, device=dev)
    x = torch.randn(256, 32, generator=torch.Generator().manual_seed(1))
    y = (x.sum(-1) > 0).long()
    batch = tuple(shard(t, bps.rank(), bps.size()).to(dev) for t in (x, y))

    # declare some tensors so the registry has state worth preserving
    bps.declare("Gradient.w0")
    bps.declare("Gradient.b0")

    loss1 = train_steps(params, step, 5, batch)
    print(f"phase 1 done: loss={loss1:.4f}, "
          f"declared={bps.declared_key('Gradient.b0')}")

    # --- elastic suspend: tear down comm, keep registry -------------------
    bps.suspend()
    # (a real deployment would wait for the new cluster size here)
    bps.resume(num_workers=1, num_servers=0)

    # keys survive resume in original order (reference: operations.cc:107-119)
    keys = {n: bps.declared_key(n) for n in ("Gradient.w0", "Gradient.b0")}
    assert keys == {"Gradient.w0": 0, "Gradient.b0": 1}, keys

    loss2 = train_steps(params, step, 5, batch)
    print(f"phase 2 done after resume: loss={loss2:.4f}")
    bps.shutdown()
    return {"phase1_loss": loss1, "phase2_loss": loss2, "keys": keys}


if __name__ == "__main__":
    main()
