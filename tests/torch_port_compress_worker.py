"""One rank of a byteps_tpu_torch compressed reduction on gloo (CPU).

    python tests/torch_port_compress_worker.py RANK WORLD PORT IN.npz \
        OUT.npz KWARGS_JSON PARTITION_BYTES NUM_LEAVES ROUNDS

Joins a gloo world at tcp://127.0.0.1:PORT, builds the compressor from
KWARGS_JSON, and runs ROUNDS rounds of ``compressed_tree_all_reduce`` on
this rank's gradients (``g<round>_<rank>_<leaf>`` in IN.npz, a list tree),
carrying its own state.  Writes each round's reduced leaves (``o<round>_
<leaf>``) and state leaves in tree order (``s<round>_<i>``, int32 lanes as
uint32) to OUT.npz.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist


def flat(node):
    if isinstance(node, dict):
        return [a for k in sorted(node) for a in flat(node[k])]
    if isinstance(node, (tuple, list)):
        return [a for v in node for a in flat(v)]
    a = node.numpy()
    return [a.view(np.uint32) if a.dtype == np.int32 else a]


def main(rank, world, port, inp, out, kwargs, pb, leaves, rounds):
    from byteps_tpu_torch.ops import compressor as C

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    data = np.load(inp)
    grads = [[torch.from_numpy(data[f"g{r}_{rank}_{i}"])
              for i in range(leaves)] for r in range(rounds)]
    comp = C.create(json.loads(kwargs))
    state = C.init_compression_state(grads[0], comp, pb)
    res = {}
    for r in range(rounds):
        reduced, state = C.compressed_tree_all_reduce(
            grads[r], comp, state, partition_bytes=pb)
        res.update({f"o{r}_{i}": t.numpy() for i, t in enumerate(reduced)})
        res.update({f"s{r}_{i}": a for i, a in enumerate(flat(state))})
    np.savez(out, **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), int(a[2]), a[3], a[4], a[5], int(a[6]),
         int(a[7]), int(a[8]))
