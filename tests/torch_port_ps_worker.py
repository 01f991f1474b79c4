"""One worker of a byteps_tpu_torch job in PS mode (or, for the control,
on gloo), on the CPU.

    python tests/torch_port_ps_worker.py api OUT_PREFIX
    python tests/torch_port_ps_worker.py train OUT_PREFIX

The job comes from the environment (``BYTEPS_TPU_PS_MODE``,
``DMLC_NUM_WORKER``, ``DMLC_WORKER_ID``, ``DMLC_PS_ROOT_PORT``, ...).

``api`` runs the eager API once on fixed inputs (push_pull, push_pull_async
with poll and synchronize, push_pull_tree with one leaf under a registered
onebit wire compressor and fused leaves beside it), then three rounds
across ``mark_step()`` (the trace window's steps), and writes the results,
the stats getters' keys and ``rank()``/``size()`` to OUT_PREFIX.RANK.npz
and .json.

``train`` broadcasts a small tree from rank 1, then takes three AdamW
steps of the ``tiny`` transformer through the Horovod face's
``DistributedOptimizer``: the parameters from seed 0, the batch from seed
100 + rank.  It writes the broadcast, the losses and the parameters after
each step.
"""

import json
import sys

import numpy as np
import torch

STEPS = 3


def api(prefix: str) -> None:
    import byteps_tpu_torch as bps
    bps.init()
    out = {}
    x = torch.arange(100000, dtype=torch.float32)
    out["pp"] = bps.push_pull(x, name="g", average=False).numpy()
    h = bps.push_pull_async(2 * x, name="g2", average=False)
    assert bps.poll(h) in (True, False)
    out["async"] = bps.synchronize(h).numpy()
    out["avg_bf16"] = bps.push_pull(
        torch.linspace(-3, 3, 64, dtype=torch.bfloat16),
        name="g.bf16").float().numpy()
    bps.register_compressor("comp.g", {"compressor": "onebit"})
    g = torch.from_numpy(np.linspace(-2.0, 3.0, 4096, dtype=np.float32))
    tree = {"comp.g": g, "plain.h": torch.full((64,), 7.0),
            "plain.i": torch.arange(5, dtype=torch.int64),
            "plain.k": torch.linspace(0, 1, 33)}
    red = bps.push_pull_tree(tree, average=False, leaf_names=sorted(tree))
    for k, v in red.items():
        out["tree." + k] = v.numpy()
    rounds = []
    for step in range(3):
        rounds.append(bps.push_pull(torch.full((16,), float(step + 1)),
                                    name="traced", average=False).numpy())
        bps.mark_step()
    out["rounds"] = np.stack(rounds)
    meta = {"rank": bps.rank(), "size": bps.size(),
            "session": bps.get_ps_session() is not None,
            "server_stats": sorted(bps.get_server_stats()),
            "transport_stats": sorted(bps.get_transport_stats()),
            "codec_stats": sorted(bps.get_codec_stats()),
            "rounds_done": bps.get_server_stats()["keys"] and 1,
            "staging": bps.get_staging_stats()}
    import torch.distributed as dist
    meta["process_group"] = dist.is_initialized()
    bps.shutdown()
    np.savez(f"{prefix}.{meta['rank']}.npz", **out)
    with open(f"{prefix}.{meta['rank']}.json", "w") as f:
        json.dump(meta, f)


def train(prefix: str) -> None:
    import byteps_tpu_torch as bps
    import byteps_tpu_torch.torch as hvd
    from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
    from byteps_tpu_torch.models import transformer as tfm
    bps.init()
    rank, size = bps.rank(), bps.size()
    out = {}
    got = bps.broadcast_parameters(
        {"w": torch.full((5,), float(rank + 1)),
         "i": torch.arange(3) * (rank + 1), "n": 3.5 + rank}, root_rank=1)
    out["bcast_w"], out["bcast_i"] = got["w"].numpy(), got["i"].numpy()
    out["bcast_n"] = np.array(got["n"])
    cfg = tfm.get_config("tiny", dtype=torch.float32)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    named = list(zip(tree_paths(params), tree_leaves(params)))
    opt = hvd.DistributedOptimizer(
        torch.optim.AdamW([p for _, p in named], lr=1e-3),
        named_parameters=named)
    batch = tfm.synthetic_batch(torch.Generator().manual_seed(100 + rank),
                                4, 32, cfg, device="cpu")
    losses = []
    for step in range(STEPS):
        opt.zero_grad()
        loss = tfm.loss_fn(params, batch, cfg)
        loss.backward()
        opt.step()
        losses.append(float(loss))
        for n, p in named:
            out[f"step{step}{n}"] = p.detach().numpy().copy()
    out["losses"] = np.array(losses)
    out["rank_size"] = np.array([rank, size])
    out["ps"] = np.array(bps.get_ps_session() is not None)
    bps.shutdown()
    np.savez(f"{prefix}.{rank}.npz", **out)


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"api": api, "train": train}[sys.argv[1]](sys.argv[2])
