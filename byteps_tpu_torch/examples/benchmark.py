"""Synthetic-data throughput benchmark.

The native counterpart of ``example/jax/benchmark_byteps.py``: the same
arguments, the same printed lines (images/s or tokens/s, mean +- standard
deviation over the timed iterations, then the eager push_pull speed).  A
CNN name (``resnet50``, ...) trains on ones; a transformer config name
(``bert_large``, ...) trains causal on synthetic tokens; both under
DistributedOptimizer(SGD) + build_train_step on ``--device`` (default
CUDA).  ``--profiler`` records the timed iterations with
``torch.profiler`` into a Chrome trace in ``--trace-dir``.

    python -m byteps_tpu_torch.examples.benchmark --model resnet50 \\
        --num-iters 10
    python -m byteps_tpu_torch.examples.benchmark --model bert_large \\
        --profiler
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

import byteps_tpu_torch as bps
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.examples._common import add_device_arg, device
from byteps_tpu_torch.models import cnn
from byteps_tpu_torch.models import transformer as tfm


def build(args, dev):
    if args.model in tfm.CONFIGS:
        cfg = tfm.get_config(args.model, causal=True)
        params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=dev)
        batch = tfm.synthetic_batch(torch.Generator().manual_seed(1),
                                    args.batch_size, args.seq_len, cfg,
                                    device=dev)
        loss = lambda p, b: tfm.loss_fn(p, b, cfg)  # noqa: E731
        unit = "tokens"
        per_batch = args.batch_size * args.seq_len
    else:
        model = cnn.create_cnn(args.model, num_classes=1000, device=dev,
                               seed=0)
        x = torch.ones(args.batch_size, args.image_size, args.image_size, 3,
                       device=dev)
        params = cnn.cnn_variables(model)["params"]
        labels = torch.zeros(args.batch_size, dtype=torch.long, device=dev)
        loss = cnn.cnn_loss_fn(model)
        batch = (x, labels)
        unit = "imgs"
        per_batch = args.batch_size
    opt = bps.DistributedOptimizer(
        torch.optim.SGD(tree_leaves(params), lr=0.01))
    step = bps.build_train_step(loss, opt, accum_steps=args.accum_steps,
                                device=dev)
    return step, params, batch, unit, per_batch


def main(argv=None) -> dict:
    """Returns the per-iteration rates, their unit and the push_pull
    speed."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet50")
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-warmup", type=int, default=2)
    ap.add_argument("--num-iters", type=int, default=10)
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="microbatches per step (gradient accumulation, "
                         "one all-reduce per step)")
    ap.add_argument("--profiler", action="store_true",
                    help="record the timed iters with torch.profiler")
    ap.add_argument("--trace-dir", default=os.path.join(
        tempfile.gettempdir(), "byteps_tpu_profile"))
    add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = device(ap, args)

    bps.init()
    step, params, batch, unit, per_batch = build(args, dev)

    for _ in range(args.num_warmup):
        float(step(params, batch))

    prof = None
    if args.profiler:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    rates = []
    for _ in range(args.num_iters):
        t0 = time.perf_counter()
        float(step(params, batch))          # waits for the step
        rates.append(per_batch / (time.perf_counter() - t0))
    if prof is not None:
        prof.stop()
        os.makedirs(args.trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.trace_dir, f"trace_rank{bps.rank()}.json"))
        print(f"profile written to {args.trace_dir}")

    rates = np.asarray(rates)
    print(f"{args.model}: {rates.mean():.1f} +- {rates.std():.1f} "
          f"{unit}/sec per worker "
          f"(total {rates.mean() * bps.size():.1f})")
    ts, speed = bps.get_pushpull_speed()
    print(f"push_pull speed: {speed:.2f} MB/s")
    bps.shutdown()
    return {"rates": rates.tolist(), "unit": unit,
            "pushpull_mb_per_s": speed}


if __name__ == "__main__":
    main()
