"""One worker process of the PS-mode tests of ``byteps_tpu_torch`` (and,
for the comparisons, of ``byteps_tpu``), on the CPU.

    python tests/torch_port_ps_modes_worker.py MODE SIDE OUT

SIDE is ``port`` (``byteps_tpu_torch``) or ``ref`` (the JAX package, on its
Python core and numpy wire codec: its own native build would write into its
package directory).  The job comes from the environment
(``BYTEPS_TPU_PS_MODE``, ``DMLC_*``, ``BYTEPS_TRACE_*``, ...).  MODE:

  - ``face_async``: a 4 -> 1 linear model (seed 0) through the Horovod
    face's ``DistributedOptimizer(SGD, enable_async=True)`` for 20 steps;
    writes the weights to OUT.npz.
  - ``face_sync``: the ``tiny`` transformer (seed 0, batch seed 100 +
    rank) through the face's ``DistributedOptimizer(SGD)``, 2 steps;
    writes the parameters after each step.
  - ``avg``: the eager API: a float32 tensor under ``Compression.fp16``
    and a bfloat16 tensor under ``Compression.none``, averaged (port only);
    writes both results.
  - ``trace_exit``: init with tracing on, one push_pull inside the trace
    window, then exit without ``shutdown()`` (port only).
"""

import sys

import numpy as np
import torch

STEPS_ASYNC = 20
STEPS_SYNC = 2
AVG_N = 4096


def _face(side):
    if side == "ref":
        from byteps_tpu.core import native as rnative
        from byteps_tpu.server import client as rclient
        from byteps_tpu.server import wire as rwire
        rnative._core = rnative._PyCore()
        rwire._CWIRE = None
        rclient._AUDIT_C = None
        import byteps_tpu.torch as face
    else:
        import byteps_tpu_torch.torch as face
    return face


def face_async(side, out):
    bps = _face(side)
    bps.init()
    torch.manual_seed(0)
    m = torch.nn.Linear(4, 1, bias=False)
    opt = bps.DistributedOptimizer(torch.optim.SGD(m.parameters(), lr=0.1),
                                   named_parameters=m.named_parameters(),
                                   enable_async=True)
    x = torch.eye(4)
    y = torch.tensor([[3.0], [-2.0], [0.5], [1.5]])
    for _ in range(STEPS_ASYNC):
        opt.zero_grad()
        torch.nn.functional.mse_loss(m(x), y).backward()
        opt.step()
    np.savez(out, w=m.weight.detach().numpy())
    bps.shutdown()


def face_sync(side, out):
    from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
    from byteps_tpu_torch.models import transformer as tfm
    bps = _face(side)
    bps.init()
    cfg = tfm.get_config("tiny", dtype=torch.float32)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    named = list(zip(tree_paths(params), tree_leaves(params)))
    opt = bps.DistributedOptimizer(
        torch.optim.SGD([p for _, p in named], lr=0.1),
        named_parameters=named)
    batch = tfm.synthetic_batch(
        torch.Generator().manual_seed(100 + bps.rank()), 4, 32, cfg,
        device="cpu")
    res = {}
    for step in range(STEPS_SYNC):
        opt.zero_grad()
        tfm.loss_fn(params, batch, cfg).backward()
        opt.step()
        for n, p in named:
            res[f"step{step}{n}"] = p.detach().numpy().copy()
    np.savez(out, **res)
    bps.shutdown()


def avg_inputs(rank):
    """Integers below 256 (exact in bfloat16); their sums over three
    workers are exact in float32 whatever the arrival order."""
    rng = np.random.RandomState(7 + rank)
    return rng.randint(-200, 201, size=AVG_N).astype(np.float32)


def avg(side, out):
    import byteps_tpu_torch as bps
    bps.init()
    x = torch.from_numpy(avg_inputs(bps.rank()))
    a = bps.push_pull(x, name="avg.fp16", compression=bps.Compression.fp16)
    b = bps.push_pull(x.to(torch.bfloat16), name="avg.bf16")
    np.savez(out, fp16=a.numpy(), bf16=b.float().numpy(),
             bf16_dtype=np.array(str(b.dtype)))
    bps.shutdown()


def trace_exit(side, out):
    import byteps_tpu_torch as bps
    bps.init()
    bps.push_pull(torch.ones(64), name="traced.before.exit")
    # No shutdown(): the interpreter's exit must flush the trace.


if __name__ == "__main__":
    torch.set_num_threads(1)
    mode, side, out = sys.argv[1:4]
    {"face_async": face_async, "face_sync": face_sync, "avg": avg,
     "trace_exit": trace_exit}[mode](side, out)
