"""One rank of a byteps_tpu_torch data-parallel world on gloo (CPU).

    python tests/torch_port_dist_worker.py RANK WORLD PORT OUT.npz

Joins the world through ``byteps_tpu_torch.init()`` (DMLC_* env), checks
the thin collectives, trains the tiny transformer (float32, flash) for two
steps on this rank's shard of a fixed global batch and, on rank 0, writes
the losses and final parameters to OUT.npz.  With WORLD=1 it trains on the
whole batch: the single-process run the distributed one must equal.
"""

import os
import sys

import numpy as np
import torch

GLOBAL_BATCH = 4
SEQ = 64
STEPS = 2


def main(rank: int, world: int, port: int, out: str) -> None:
    os.environ.update(DMLC_NUM_WORKER=str(world), DMLC_WORKER_ID=str(rank),
                      DMLC_PS_ROOT_URI="127.0.0.1",
                      DMLC_PS_ROOT_PORT=str(port))
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.models import transformer as tfm

    torch.set_num_threads(1)
    bps.init()
    assert (bps.rank(), bps.size()) == (rank, world)
    if world > 1:
        coll = bps.collectives
        mine = torch.full((2,), float(rank + 1))
        gathered = coll.all_gather(mine)
        assert gathered.tolist() == [float(r + 1) for r in range(world)
                                     for _ in range(2)]
        shard = coll.reduce_scatter(torch.arange(2.0 * world))
        assert shard.tolist() == [world * (2.0 * rank), world * (2.0 * rank
                                                                 + 1)]
        assert coll.all_reduce(torch.ones(3)).tolist() == [float(world)] * 3

    cfg = tfm.get_config("tiny", dtype=torch.float32, attn_impl="flash")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    toks, tgts = tfm.synthetic_batch(torch.Generator().manual_seed(1),
                                     GLOBAL_BATCH, SEQ, cfg, device="cpu")
    per = GLOBAL_BATCH // world
    batch = (toks[rank * per:(rank + 1) * per],
             tgts[rank * per:(rank + 1) * per])
    # SGD keeps the update linear in the reduced gradient.  (Adam would
    # turn the rounding noise of the exactly-zero K-bias gradient into
    # +-lr steps of either sign.)
    opt = bps.DistributedOptimizer(
        torch.optim.SGD(tree_leaves(params), lr=0.5),
        partition_bytes=16 * 1024)           # several buckets at this size
    step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt,
                                device="cpu")
    losses = [float(step(params, batch)) for _ in range(STEPS)]
    if rank == 0:
        np.savez(out, losses=np.array(losses),
                 **{f"p{i}": p.detach().numpy()
                    for i, p in enumerate(tree_leaves(params))})
    bps.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
