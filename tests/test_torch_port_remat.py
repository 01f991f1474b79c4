"""The transformer's remat policies in byteps_tpu_torch against each other
and against the JAX package's.

"none", "proj", "dots" and "dots_no_batch" (tiny config, float32, dense and
flash attention; flash runs its plain versions on the CPU): the loss and
every gradient equal under all four, and equal JAX's under the same
policy (loss to 1e-5 relative, gradients to 1e-4 of their max, as the
model parity tests).  Which tensors each policy keeps is read with
``saved_tensors_hooks``; the selective-checkpoint policy's op log shows
that the recompute runs the forward's ops in the forward's order, flash
included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import transformer as jtfm
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import transformer as tfm
from byteps_tpu_torch.ops import flash_attention as fa
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

POLICIES = ("none", "proj", "dots", "dots_no_batch")
B, S = 2, 64


def _setup(attn):
    jcfg = jtfm.get_config("tiny", dtype=jnp.float32, attn_impl=attn)
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(0), jcfg))
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (B, S + 1))
    return params, (toks[:, :-1], toks[:, 1:])


def _port(params, batch, policy, attn):
    cfg = tfm.get_config("tiny", dtype=torch.float32, attn_impl=attn,
                         remat_policy=policy)
    tp = tfm.params_from_numpy(params, cfg, device="cpu")
    loss = tfm.loss_fn(tp, tuple(torch.from_numpy(x).long() for x in batch),
                       cfg)
    grads = torch.autograd.grad(loss, tree_leaves(tp))
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_policies_agree_with_each_other_and_with_jax(attn):
    params, batch = _setup(attn)
    runs = {p: _port(params, batch, p, attn) for p in POLICIES}
    base_loss, base_grads = runs["none"]
    for p in POLICIES[1:]:
        loss, grads = runs[p]
        assert loss == base_loss, p
        for g, b in zip(grads, base_grads):
            np.testing.assert_array_equal(g, b)
    jb = tuple(jnp.asarray(x, jnp.int32) for x in batch)
    for p in POLICIES:
        jcfg = jtfm.get_config("tiny", dtype=jnp.float32, attn_impl=attn,
                               remat_policy=p)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda q: jtfm.loss_fn(q, jb, jcfg)))(params)
        loss, grads = runs[p]
        assert abs(loss - float(jl)) <= 1e-5 * abs(float(jl)), p
        for g, w in zip(grads, jax.tree.leaves(jg)):
            w = np.asarray(w, np.float32)
            scale = float(np.abs(w).max()) + 1e-12
            np.testing.assert_allclose(g / scale, w / scale, atol=1e-4)


def _saved_activations(policy):
    """The distinct [B, S, *] tensors the forward leaves for the backward,
    per layer, under ``policy``."""
    params, batch = _setup("dense")
    cfg = tfm.get_config("tiny", dtype=torch.float32, remat_policy=policy)
    tp = tfm.params_from_numpy(params, cfg, device="cpu")
    saved = {}

    def pack(t):
        if t.dim() == 3 and tuple(t.shape[:2]) == (B, S):
            saved[(t.data_ptr(), tuple(t.shape))] = t
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tfm.forward_hidden(tp, torch.from_numpy(batch[0]).long(), cfg)
    return saved, cfg


def test_proj_keeps_the_named_projections():
    """Under "proj" each layer keeps, beyond what "none" keeps (each
    layer's input, and the final norm's own), exactly the three named
    tensors the backward needs: qkv [B, S, 3D], attn_ctx [B, S, D] and
    attn_proj [B, S, D].  ffn_out, named too, is needed by no backward
    (the residual add), as under the JAX policy, which keeps a named
    tensor only where the backward needs it."""
    from collections import Counter
    proj, cfg = _saved_activations("proj")
    none, _ = _saved_activations("none")
    L, D = cfg.num_layers, cfg.d_model
    extra = (Counter(k[1][2] for k in proj)
             - Counter(k[1][2] for k in none))
    assert len(proj) - len(none) == 3 * L
    assert extra == Counter({3 * D: L, D: 2 * L})
    kinds = Counter(t.grad_fn.name() for t in proj.values()) - Counter(
        t.grad_fn.name() for t in none.values())
    # qkv and attn_proj end in a bias add, attn_ctx in the heads' reshape
    assert kinds == Counter({"AddBackward0": 2 * L,
                             "UnsafeViewBackward0": L})


class _OpLog(torch.utils._python_dispatch.TorchDispatchMode):
    """Every aten op that reaches the dispatcher below checkpoint's own
    modes, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


def _is_subsequence(small, big):
    it = iter(big)
    return all(any(op == b for b in it) for op in small)


@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_selective_policy_recompute_runs_the_forward_ops(policy):
    """One layer under a selective policy with flash attention: the policy
    keeps the outputs of its products (mm, plus bmm under "dots") and is
    asked about no other; the recompute reruns the flash autograd op (two
    flash forwards for the layer), and the forward's other ops come back
    in the backward's op stream in the forward's order."""
    params, batch = _setup("flash")
    cfg = tfm.get_config("tiny", dtype=torch.float32, attn_impl="flash",
                         remat_policy=policy)
    tp = tfm.params_from_numpy(params, cfg, device="cpu")
    log = []
    block = tfm._remat_block(policy, log)
    calls = []
    real = fa.flash_fwd
    x = (tp["embed"][torch.from_numpy(batch[0]).long()]
         + tp["pos_embed"][:S]).detach().requires_grad_()
    lp = {n: tp["layers"][n][0] for n in sorted(tp["layers"])}
    fwd_log, bwd_log = _OpLog(), _OpLog()
    try:
        fa.flash_fwd = lambda *a: calls.append(1) or real(*a)
        with fwd_log:
            out = block(x, lp, cfg, tfm.flash_attention_fn)
        # the whole recompute, not the part the backward needs first
        with bwd_log, torch.utils.checkpoint.set_checkpoint_early_stop(
                False):
            out.sum().backward()
    finally:
        fa.flash_fwd = real
    assert len(calls) == 2
    saved = set(tfm._DOT_OPS[policy])
    asked = [op for _, op in log]
    assert torch.ops.aten.mm.default in asked
    assert [op for op in asked if op in saved] == [
        op for op in fwd_log.ops if op in saved]
    # (detach is the checkpoint's own bookkeeping of what it keeps)
    skip = saved | {torch.ops.aten.detach.default}
    redo = [op for op in fwd_log.ops if op not in skip]
    assert redo and _is_subsequence(redo, [
        op for op in bwd_log.ops if op != torch.ops.aten.detach.default])
