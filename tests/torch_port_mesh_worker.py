"""One rank of a byteps_tpu_torch world on gloo (CPU), on a two-level mesh.

    python tests/torch_port_mesh_worker.py RANK WORLD PORT IN.npz OUT_DIR

Joins the world through ``byteps_tpu_torch.init()`` (DMLC_* env), builds
``make_hierarchical_mesh(WORLD // 2)`` on the CPU, a (2, WORLD // 2)
('dcn_dp', 'ici_dp') mesh, and writes OUT_DIR/rank<RANK>.npz with:

  - ``flat_shape``, ``flat_dp``, ``two_level_dp``, ``slice_shape``,
    ``slice_none``: ``make_mesh(tp=2)``'s shape and dp size, the two-level
    mesh's dp size, ``make_slice_mesh(WORLD // 2)``'s shape, and whether
    ``make_slice_mesh(WORLD + 1)`` is None;
  - ``har``: ``hierarchical_all_reduce`` of this rank's row of ``x``, and
    ``har_avg`` the same with ``average=True``;
  - ``tree/<key>``: ``hierarchical_tree_all_reduce`` (average,
    128-byte buckets) of this rank's leaves ``tree<RANK>/<key>``;
  - ``losses`` and ``p<i>``: three AdamW steps of the tiny transformer
    (float32, flash) from the params ``param/<path>`` through
    ``build_train_step`` and ``DistributedOptimizer(hierarchical=True)``,
    each rank on its row of the global batch ``toks``/``tgts``.
"""

import os
import sys

import numpy as np
import torch

STEPS = 3


def _nest(flat):
    """{'a/b': arr} -> {'a': {'b': arr}}."""
    out = {}
    for path, arr in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr
    return out


def main(rank: int, world: int, port: int, inp: str, out_dir: str) -> None:
    os.environ.update(DMLC_NUM_WORKER=str(world), DMLC_WORKER_ID=str(rank),
                      DMLC_PS_ROOT_URI="127.0.0.1",
                      DMLC_PS_ROOT_PORT=str(port))
    torch.set_num_threads(1)
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.models import transformer as tfm
    from byteps_tpu_torch.ops import collectives
    from byteps_tpu_torch.parallel import mesh as pmesh

    data = np.load(inp)
    bps.init()
    mesh = bps.make_hierarchical_mesh(world // 2, device_type="cpu")
    assert mesh.mesh_dim_names == ("dcn_dp", "ici_dp"), mesh
    assert tuple(mesh.shape) == (2, world // 2), mesh
    flat = bps.make_mesh(tp=2, device_type="cpu")
    half = bps.make_slice_mesh(world // 2, device_type="cpu")
    res = {"flat_shape": np.array(flat.shape),
           "flat_dp": pmesh.dp_axis_size(flat),
           "two_level_dp": pmesh.dp_axis_size(mesh),
           "slice_shape": np.array(half.shape),
           "slice_none": bps.make_slice_mesh(world + 1,
                                             device_type="cpu") is None}

    x = torch.from_numpy(data["x"][rank])
    res["har"] = collectives.hierarchical_all_reduce(x.clone(), mesh).numpy()
    res["har_avg"] = collectives.hierarchical_all_reduce(
        x.clone(), mesh, average=True).numpy()

    prefix = f"tree{rank}/"
    tree = {k[len(prefix):]: torch.from_numpy(data[k])
            for k in data.files if k.startswith(prefix)}
    out = collectives.hierarchical_tree_all_reduce(
        tree, mesh, average=True, partition_bytes=128)
    res.update({f"tree/{k}": v.numpy() for k, v in out.items()})

    cfg = tfm.get_config("tiny", dtype=torch.float32, attn_impl="flash")
    params = tfm.params_from_numpy(
        _nest({k[len("param/"):]: data[k] for k in data.files
               if k.startswith("param/")}), cfg, device="cpu")
    toks = torch.from_numpy(data["toks"]).long()
    tgts = torch.from_numpy(data["tgts"]).long()
    per = toks.shape[0] // world
    batch = (toks[rank * per:(rank + 1) * per],
             tgts[rank * per:(rank + 1) * per])
    # optax.adamw's defaults, as tests/test_torch_port_train.py states them.
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(tree_leaves(params), lr=1e-3, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        hierarchical=True, mesh=mesh, partition_bytes=16 * 1024)
    step = bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, cfg), opt,
                                device="cpu")
    res["losses"] = np.array([float(step(params, batch))
                              for _ in range(STEPS)])
    res.update({f"p{i}": p.detach().numpy()
                for i, p in enumerate(tree_leaves(params))})
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    bps.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
