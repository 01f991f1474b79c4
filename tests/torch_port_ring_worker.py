"""One rank of byteps_tpu_torch's sequence-parallel attention on gloo (CPU).

    python tests/torch_port_ring_worker.py RANK WORLD PORT IN.npz OUT.npz

Joins a gloo world at tcp://127.0.0.1:PORT and takes its block of the
sequence (dim 2) of each [B, H, S, D] input in IN.npz.  Runs ring and
Ulysses attention (dense and flash inner), causal and not, forward and
the gradients of sum(out ** 2), and the two calls that must raise.  Writes
its outputs (``<case>``) and gradients (``<case>_dq`` ...) and the error
messages (``err_<case>``) to OUT.npz.
"""

import sys

import numpy as np
import torch
import torch.distributed as dist


def main(rank, world, port, inp, out):
    from byteps_tpu_torch.ops import ring_attention as ra

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    data = np.load(inp)

    def shard(name):
        x = torch.from_numpy(data[name])
        return x.chunk(world, 2)[rank].contiguous().requires_grad_()

    res = {}
    fns = {"ring": ra.make_ring_attn_fn(),
           "ulysses": ra.make_ulysses_attn_fn(),
           "ulysses_flash": ra.make_ulysses_attn_fn(attn="flash")}
    for name, fn in fns.items():
        prefix = "flash" if name == "ulysses_flash" else "dense"
        for causal in (False, True):
            q, k, v = (shard(f"{prefix}_{t}") for t in "qkv")
            o = fn(q, k, v, causal)
            dq, dk, dv = torch.autograd.grad((o ** 2).sum(), (q, k, v))
            case = f"{name}_{int(causal)}"
            res[case] = o.detach().numpy()
            res.update({f"{case}_dq": dq.numpy(), f"{case}_dk": dk.numpy(),
                        f"{case}_dv": dv.numpy()})
    for case, fn, x in (("bad_heads", fns["ulysses"], shard("bad_heads")),
                        ("strict", fns["ulysses_flash"], shard("strict"))):
        try:
            fn(x, x, x, False)
            res[f"err_{case}"] = np.array("no error")
        except ValueError as e:
            res[f"err_{case}"] = np.array(str(e))
    np.savez(out, **res)
    dist.destroy_process_group()


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), int(a[2]), a[3], a[4])
