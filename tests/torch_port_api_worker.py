"""One rank of a byteps_tpu_torch world on gloo (CPU), for the eager API
and the Horovod face.

    python tests/torch_port_api_worker.py RANK WORLD PORT OUT_PREFIX

Each rank draws its own inputs from numpy with seed RANK, runs the eager
API (push_pull average and sum, async + poll + synchronize, push_pull_tree
at a fusion threshold that makes several buckets, broadcast of parameters
and of a torch optimizer's state), then trains a small model through
``byteps_tpu_torch.torch`` (DistributedOptimizer with broadcasts, and the
DistributedDataParallel wrapper) on its shard of a fixed global batch, and
writes everything to OUT_PREFIX.RANK.npz.  With WORLD=1 the training runs
on the whole batch: the single-process run the distributed one must equal.
"""

import os
import sys

import numpy as np
import torch

GLOBAL_BATCH = 8
STEPS = 3


def inputs(rank):
    rng = np.random.RandomState(rank)
    return {"x": rng.randn(5).astype(np.float32),
            "a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(7).astype(np.float32),
            "c": rng.randn(40).astype(np.float32),
            "i": rng.randint(0, 100, size=(3,)).astype(np.int64)}


def model_and_data():
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(6, 8), torch.nn.Tanh(),
                                torch.nn.Linear(8, 2))
    rng = np.random.RandomState(100)
    x = torch.from_numpy(rng.randn(GLOBAL_BATCH, 6).astype(np.float32))
    y = torch.from_numpy(rng.randn(GLOBAL_BATCH, 2).astype(np.float32))
    return model, x, y


def main(rank: int, world: int, port: int, prefix: str) -> None:
    os.environ.update(DMLC_NUM_WORKER=str(world), DMLC_WORKER_ID=str(rank),
                      DMLC_PS_ROOT_URI="127.0.0.1",
                      DMLC_PS_ROOT_PORT=str(port))
    import byteps_tpu_torch as bps
    import byteps_tpu_torch.torch as hvd

    torch.set_num_threads(1)
    bps.init()
    assert (bps.rank(), bps.size()) == (rank, world)
    out = {}
    mine = inputs(rank)
    t = torch.from_numpy(mine["x"])
    out["avg"] = bps.push_pull(t, name="x").numpy()
    out["sum"] = bps.push_pull(t, name="x.sum", average=False).numpy()
    assert torch.equal(t, torch.from_numpy(mine["x"]))   # caller's untouched
    h = bps.push_pull_async(t, name="x.async")
    while not bps.poll(h):
        pass
    out["async"] = bps.synchronize(h).numpy()
    for fn in (bps.synchronize, bps.poll):
        try:
            fn(h)
        except ValueError:
            pass
        else:
            raise AssertionError(f"{fn.__name__} took a used handle")
    tree = {"a": torch.from_numpy(mine["a"]),
            "b": [torch.from_numpy(mine["b"]), torch.from_numpy(mine["i"])],
            "c": torch.from_numpy(mine["c"])}
    before = bps.get_fusion_stats()["buckets_built"]
    red = bps.push_pull_tree(tree, name="tree", fusion_bytes=64)
    out["buckets"] = np.array(bps.get_fusion_stats()["buckets_built"]
                              - before)
    out["tree_a"], out["tree_b"] = red["a"].numpy(), red["b"][0].numpy()
    out["tree_i"], out["tree_c"] = red["b"][1].numpy(), red["c"].numpy()
    got = bps.broadcast_parameters({"w": torch.full((3,), float(rank)),
                                    "n": [rank + 1]}, root_rank=world - 1)
    out["bcast_w"], out["bcast_n"] = got["w"].numpy(), np.array(got["n"])

    # The Horovod face: broadcasts, then DistributedOptimizer on the shard.
    model, x, y = model_and_data()
    if rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)                     # differs until broadcast
    opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    hvd.broadcast_parameters(model.state_dict(), root_rank=0)
    opt = hvd.DistributedOptimizer(opt,
                                   named_parameters=model.named_parameters())
    hvd.broadcast_optimizer_state(opt, root_rank=0)
    per = GLOBAL_BATCH // world
    xs, ys = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    losses = []
    for _ in range(STEPS):
        opt.zero_grad()
        loss = torch.nn.functional.mse_loss(model(xs), ys)
        loss.backward()
        opt.step()
        assert opt.step_handles == 4
        losses.append(float(loss))
    out["opt_losses"] = np.array(losses)
    for i, p in enumerate(model.parameters()):
        out[f"opt_p{i}"] = p.detach().numpy()

    # DistributedDataParallel: auto-sync at the end of each backward.
    model, x, y = model_and_data()
    ddp = hvd.DistributedDataParallel(model)
    sgd = torch.optim.SGD(ddp.parameters(), lr=0.1)
    xs, ys = x[rank * per:(rank + 1) * per], y[rank * per:(rank + 1) * per]
    for _ in range(STEPS):
        sgd.zero_grad()
        torch.nn.functional.mse_loss(ddp(xs), ys).backward()
        sgd.step()
    assert ddp.autosync_count == STEPS
    for i, p in enumerate(model.parameters()):
        out[f"ddp_p{i}"] = p.detach().numpy()

    # The optimizer state broadcast: scalar state and tensors from root.
    m = torch.nn.Linear(2, 1)
    adam = torch.optim.Adam(m.parameters(), lr=1e-3)
    m(torch.full((1, 2), float(rank + 1))).sum().backward()
    adam.step()
    hvd.broadcast_optimizer_state(adam, root_rank=0)
    st = adam.state_dict()["state"]
    out["adam_exp_avg"] = st[0]["exp_avg"].numpy()
    out["adam_step"] = np.array(float(st[0]["step"]))
    np.savez(f"{prefix}.{rank}.npz", **out)
    bps.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
