"""One rank of a 4-rank gloo world (CPU) for the port's parallelism tests.

    python tests/torch_port_parallel_worker.py MODE RANK WORLD PORT IN.npz OUT

MODE is ``sharded`` (tests/test_torch_port_sharded.py), ``parallel``
(tests/test_torch_port_parallel.py), ``hybrid``
(tests/test_torch_port_hybrid.py) or ``sp`` (tests/test_torch_port_sp_model.py,
a world of 2); each runs every case of its test file in this one world and
writes OUT/rank<RANK>.npz (numpy arrays; specs, error texts and printed
lines as JSON strings).  The inputs, JAX's parameters among them,
come from IN.npz, made from a seed by the test.  ``spawn`` starts the world
and returns every rank's results.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

STEPS = 3


def spawn(mode, inputs, out_dir, world=4):
    """Start the world on ``inputs`` (a dict of arrays) in ``out_dir``;
    ``collect`` waits for it."""
    np.savez(os.path.join(out_dir, "in.npz"), **inputs)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(r), str(world),
         str(port), os.path.join(out_dir, "in.npz"), str(out_dir)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    return procs


def collect(procs, out_dir, timeout=120):
    """Every rank's results, once all have exited 0."""
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-6000:]
    return [dict(np.load(os.path.join(out_dir, f"rank{r}.npz")))
            for r in range(len(procs))]


def nest(flat, prefix):
    """{'prefix/a/b': arr} -> {'a': {'b': arr}}."""
    out = {}
    for path, arr in flat.items():
        if not path.startswith(prefix):
            continue
        node = out
        *heads, last = path[len(prefix):].split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = arr
    return out


def _specs_json(tree):
    from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
    return json.dumps({p: [list(e) if isinstance(e, tuple) else e
                           for e in s]
                       for p, s in zip(tree_paths(tree), tree_leaves(tree))})


def _error(fn):
    try:
        fn()
    except (TypeError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def run_sharded(rank, world, data, res):
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.models import transformer as tfm
    from byteps_tpu_torch.parallel import sharded
    P = sharded.P
    dp4 = bps.make_mesh(dp=4, device_type="cpu")
    tp2 = bps.make_mesh(dp=2, tp=2, device_type="cpu")
    hier = bps.make_hierarchical_mesh(2, device_type="cpu")

    # Spec functions: pure shape code, on the world's meshes.
    tiny = tfm.get_config("tiny", dtype=torch.float32)
    llama = tfm.get_config("llama_tiny", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    tp_ = tfm.init_params(gen, tiny, device="cpu")
    lp_ = tfm.init_params(gen, llama, device="cpu")
    rep = {k: (P() if not isinstance(v, dict) else {kk: P() for kk in v})
           for k, v in tp_.items()}
    embed_dp = dict(rep, embed=P("dp"))
    specs = {
        "zero1_dp4": sharded.zero1_opt_specs(None, tp_, dp4, rep),
        "zero1_embed_dp": sharded.zero1_opt_specs(None, tp_, dp4, embed_dp),
        "zero1_ici": sharded.zero1_opt_specs(None, tp_, hier, rep,
                                             dp_axis="ici_dp"),
        "fsdp_dp4": sharded.fsdp_param_specs(tp_, dp4, min_shard_elems=64),
        "fsdp_tp": sharded.fsdp_param_specs(
            lp_, tp2, base_specs=tfm.param_specs(llama), min_shard_elems=64),
    }
    res.update({f"spec/{k}": _specs_json(v) for k, v in specs.items()})
    errors = {
        "zero1_hier": lambda: sharded.zero1_opt_specs(None, tp_, hier, rep),
        "fsdp_hier": lambda: sharded.fsdp_param_specs(tp_, hier),
        "zero1_no_params": lambda: bps.build_sharded_train_step(
            lambda p, b: None, None, dp4, rep, zero1=True),
    }
    res.update({f"error/{k}": json.dumps(_error(fn))
                for k, fn in errors.items()})

    # The step, from JAX's params, on the global batch.
    def make(leaves):
        return torch.optim.AdamW(leaves, lr=1e-3, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)

    # The kernels' wrapper refuses a DTensor; the adapter runs it per rank.
    from byteps_tpu_torch.ops import flash_attention as fa
    from torch.distributed.tensor import Shard, distribute_tensor
    q = distribute_tensor(torch.zeros(8, 64, 16), sharded.dtensor_mesh(dp4),
                          [Shard(0)])
    res["error/flash_dtensor"] = json.dumps(
        _error(lambda: fa.flash_attention(q, q, q)))
    # flash_attention_fn on DTensors [B, H, S, Dh] (batch over dp, heads
    # over tp) against the same call on the whole tensors.
    gen = torch.Generator().manual_seed(1)
    qkv = [torch.randn(4, 4, 64, 16, generator=gen) for _ in range(3)]
    dq = [distribute_tensor(t, sharded.dtensor_mesh(tp2), [Shard(0),
                                                          Shard(1)])
          .requires_grad_() for t in qkv]
    out = tfm.flash_attention_fn(*dq, True)
    (out ** 2).sum().backward()
    ref = [t.clone().requires_grad_() for t in qkv]
    want = tfm.flash_attention_fn(*ref, True)
    (want ** 2).sum().backward()
    res["flash_fn/out"] = np.stack([out.full_tensor().detach().numpy(),
                                    want.detach().numpy()])
    res["flash_fn/grads"] = np.stack([
        np.stack([a.grad.full_tensor().numpy(), b.grad.numpy()])
        for a, b in zip(dq, ref)])
    res["flash_fn/placements"] = json.dumps(
        [str(p) for p in out.placements])
    calls = {"flash_fwd_plain": 0, "flash_bwd_dq_plain": 0,
             "flash_bwd_dkv_plain": 0}
    for n in calls:
        real = getattr(fa, n)

        def counted(*a, _f=real, _n=n):
            calls[_n] += 1
            return _f(*a)
        setattr(fa, n, counted)

    cases = {"plain": (dp4, "dense", "rep"), "zero1": (dp4, "dense", "rep"),
             "fsdp": (dp4, "dense", "fsdp"),
             "fsdp_tp": (tp2, "dense", "fsdp_tp"),
             "flash_tp": (tp2, "flash", "tp")}
    for name, (mesh, attn, kind) in cases.items():
        cfg = tfm.get_config("tiny", causal=True, remat=False,
                             dtype=torch.float32, attn_impl=attn)
        params = tfm.params_from_numpy(nest(data, "param/"), cfg,
                                       device="cpu")
        pre = "f" if attn == "flash" else ""
        batch = (torch.from_numpy(data[pre + "toks"]).long(),
                 torch.from_numpy(data[pre + "tgts"]).long())
        specs = {"rep": rep, "tp": tfm.param_specs(cfg),
                 "fsdp": sharded.fsdp_param_specs(params, mesh,
                                                  min_shard_elems=64),
                 "fsdp_tp": sharded.fsdp_param_specs(
                     params, mesh, base_specs=tfm.param_specs(cfg),
                     min_shard_elems=64)}[kind]
        if name == "plain":
            params = sharded.init_sharded(lambda: params, mesh, specs)
        else:
            params = sharded.shard_params(params, mesh, specs)
        if name == "zero1":
            opt = sharded.zero1_init(make, params, mesh, specs)
        elif kind.startswith("fsdp"):
            opt = sharded.fsdp_init(make, params, mesh, specs)
        else:
            opt = make(tree_leaves(params))
        step = sharded.build_sharded_train_step(
            lambda p, b: tfm.loss_fn(p, b, cfg), opt, mesh, specs,
            zero1=name == "zero1", params=params)
        res[f"{name}/losses"] = np.array([float(step(params, batch))
                                          for _ in range(STEPS)])
        for i, p in enumerate(tree_leaves(params)):
            res[f"{name}/p{i}"] = p.full_tensor().detach().numpy()
            res[f"{name}/local{i}"] = np.array([p.to_local().numel(),
                                                p.numel()])
        if name == "flash_tp":
            res["flash_tp/calls"] = np.array([calls[n] for n in calls])
        if name == "zero1":
            held = [q for g in opt.param_groups for q in g["params"]]
            for i, q in enumerate(held):
                m = opt.state[q]["exp_avg"]
                res[f"{name}/moment{i}"] = np.array([m.to_local().numel(),
                                                     m.numel()])


def run_parallel(rank, world, data, res):
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.parallel import expert, pipeline
    from byteps_tpu_torch.parallel import tensor_parallel as tp

    def t(key, grad=False):
        return torch.from_numpy(data[key]).requires_grad_(grad)

    tpg = bps.make_mesh(tp=world, device_type="cpu").get_group("tp")
    x, w1, w2, b2 = t("x", True), t("w1", True), t("w2", True), t("b2", True)
    cols = w1.shape[1] // world
    w1l = w1[:, rank * cols:(rank + 1) * cols]
    w2l = w2[rank * cols:(rank + 1) * cols]
    h = torch.relu(tp.col_parallel_dense(tp.copy_to(tpg)(x), w1l))
    out = tp.row_parallel_dense(h, w2l, b2, tpg)
    (out ** 2).sum().backward()
    res.update({"colrow": out.detach().numpy(), "colrow/dx": x.grad.numpy(),
                "colrow/dw1": w1.grad.numpy(), "colrow/dw2": w2.grad.numpy(),
                "colrow/db2": b2.grad.numpy()})
    a = t("arange")
    res["roundtrip"] = tp.tp_all_gather(tp.tp_split(a, 1, tpg), 1,
                                        tpg).numpy()

    ppg = bps.make_mesh(pp=world, device_type="cpu").get_group("pp")

    def layer(w, h):
        return torch.tanh(h @ w)

    def stage_fn(ws, h):
        for w in torch.unbind(ws, 0):
            h = layer(w, h)
        return h

    for m in (2, 4):
        staged = pipeline.shard_stage_params(t("pp_ws"), world)
        res[f"gpipe{m}"] = pipeline.gpipe_spmd(
            stage_fn, staged[rank], t("pp_x"), m, ppg).numpy()
        ws = pipeline.shard_stage_params(t("pg_ws"), world)[rank]
        ws = ws.detach().requires_grad_()
        y = pipeline.gpipe_spmd(stage_fn, ws, t("pg_x"), m, ppg)
        # Every rank holds the same y and computes the same loss: the
        # replicated loss is their mean (the cotangent JAX gives each
        # device of a replicated shard_map output).
        ((y ** 2).sum() / world).backward()
        res[f"gpipe_grad{m}"] = ws.grad.numpy()

    mesh = bps.make_mesh(ep=world, device_type="cpu")
    moe = expert.moe_params_from_numpy(nest(data, "moe/"), device="cpu")
    for cf in (16.0, 2.0, 0.25):
        y, aux = expert.moe_layer(moe, t("moe_x"), mesh, cf)
        res[f"moe{cf}"] = y.detach().numpy()
        res[f"moe{cf}/aux"] = aux.detach().numpy()
    moe = expert.moe_params_from_numpy(nest(data, "moeg/"), device="cpu")
    xg = t("moeg_x", True)
    y, aux = expert.moe_layer(moe, xg, mesh, 8.0)
    ((y ** 2).sum() + 0.01 * aux).backward()
    res.update({f"moeg/{k}": v.grad.numpy() for k, v in moe.items()})
    res["moeg/x"] = xg.grad.numpy()


def run_hybrid(rank, world, data, res):
    import dataclasses
    import torch
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.common.tree import tree_leaves
    from byteps_tpu_torch.models import hybrid
    cfgs = {"d": hybrid.HybridConfig(vocab_size=64, num_layers=4,
                                     d_model=16, num_heads=4, d_ff=32,
                                     max_seq_len=32),
            "m": hybrid.HybridConfig(vocab_size=64, num_layers=2,
                                     d_model=16, num_heads=4, d_ff=32,
                                     max_seq_len=32, num_experts=4,
                                     capacity_factor=8.0)}
    batch = (torch.from_numpy(data["toks"]).long(),
             torch.from_numpy(data["tgts"]).long())

    def sgd(leaves):
        return torch.optim.SGD(leaves, lr=0.1)

    def adam(leaves):
        return torch.optim.Adam(leaves, lr=1e-2)

    def run(name, key, axes, mb=1, opt=sgd, zero1=False, devices=None,
            **over):
        mesh = bps.make_mesh(**axes, devices=devices, device_type="cpu")
        if mesh.get_coordinate() is None:
            return
        cfg = dataclasses.replace(cfgs[key], **over)
        step, init_fn = hybrid.build_hybrid_train_step(
            cfg, opt, mesh, num_microbatches=mb, zero1=zero1)
        params = init_fn(hybrid.params_from_numpy(
            nest(data, f"{key}/"), cfg, device="cpu"))
        res[f"{name}/losses"] = np.array([float(step(params, batch))
                                          for _ in range(STEPS)])
        if name == "single":
            res.update({f"{name}/p{i}": p.detach().numpy()
                        for i, p in enumerate(tree_leaves(params))})
        if zero1:
            held = [q for g in step.optimizer.param_groups
                    for q in g["params"]]
            res[f"{name}/moments"] = np.array(
                [[step.optimizer.state[q]["exp_avg"].numel(), p.numel()]
                 for q, p in zip(held, tree_leaves(params))])
        if "aux_loss_weight" in over:
            gate = params["layers"]["gate_w"]
            res[f"{name}/gate_grad"] = np.array(
                float(gate.grad.abs().sum()))

    run("single", "d", dict(dp=1), devices=[0])
    run("dp4", "d", dict(dp=4))
    run("dp2_tp2", "d", dict(dp=2, tp=2))
    run("tp2_sp2", "d", dict(tp=2, sp=2))
    run("pp2_dp2_mb2", "d", dict(pp=2, dp=2), mb=2)
    run("pp2_dp2_mb4", "d", dict(pp=2, dp=2), mb=4)
    run("pp2_tp2_mb2", "d", dict(pp=2, tp=2), mb=2)
    run("pp2_tp2_mb2_ce16", "d", dict(pp=2, tp=2), mb=2, ce_chunk_rows=16)
    run("moe_ep2_dp2", "m", dict(ep=2, dp=2))
    run("moe_ep2_tp2", "m", dict(ep=2, tp=2))
    run("moe_aux_pp2_ep2", "m", dict(pp=2, ep=2), mb=2,
        aux_loss_weight=0.01)
    run("zero1_dp2_tp2", "d", dict(dp=2, tp=2), opt=adam, zero1=True)
    run("zero1_dp4", "d", dict(dp=4), opt=adam, zero1=True)


def run_sp(rank, world, data, res):
    """The transformer on this rank's block of the sequence through the
    ring and Ulysses adaptors (forward, and the ring's gradients of the
    mean loss averaged over the ranks), then train_long_context's ring
    branch over sp = world, which ends the process group."""
    import contextlib
    import io
    import torch
    from byteps_tpu_torch.common.tree import tree_leaves, tree_paths
    from byteps_tpu_torch.examples import train_long_context
    from byteps_tpu_torch.models import transformer as tfm
    from byteps_tpu_torch.ops import collectives
    from byteps_tpu_torch.ops import ring_attention as ra
    toks = torch.from_numpy(data["toks"]).long()
    tgts = torch.from_numpy(data["tgts"]).long()
    S = toks.shape[1] // world
    blk = slice(rank * S, (rank + 1) * S)
    fns = {"ring": ra.make_ring_attn_fn(), "ulysses": ra.make_ulysses_attn_fn()}
    res["sp_index"] = np.array([fn.sp_index for fn in fns.values()])
    for name in ("tiny", "llama_tiny"):
        cfg = tfm.get_config(name, dtype=torch.float32, remat=False)
        params = tfm.params_from_numpy(nest(data, f"{name}/"), cfg,
                                       device="cpu")
        for key, fn in fns.items():
            with torch.no_grad():
                res[f"fwd/{name}/{key}"] = tfm.forward(
                    params, toks[:, blk], cfg, attn_fn=fn).numpy()
        tfm.loss_fn(params, (toks[:, blk], tgts[:, blk]), cfg,
                    attn_fn=fns["ring"]).backward()
        for path, p in zip(tree_paths(params), tree_leaves(params)):
            res[f"grad/{name}/{path}"] = (collectives.all_reduce(
                p.grad, None) / world).numpy()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = train_long_context.main(
            ["--attn", "ring", "--sp", str(world), "--seq-len", "64",
             "--steps", "3", "--device", "cpu"])
    res["example/lines"] = json.dumps(out.getvalue().splitlines())
    res["example/losses"] = np.array(got["losses"])


def main(mode, rank, world, port, inp, out_dir):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    data = dict(np.load(inp))
    res = {}
    {"sharded": run_sharded, "parallel": run_parallel,
     "hybrid": run_hybrid, "sp": run_sp}[mode](rank, world, data, res)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5], sys.argv[6])
