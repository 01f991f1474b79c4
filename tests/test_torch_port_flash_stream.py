"""byteps_tpu_torch's streaming flash family vs the JAX package's.

The JAX streaming kernels (``flash_attention(..., streaming=True)``, 3-D
grid, scratch carried across the contraction axis) run in the Pallas
interpreter; on CPU tensors the port runs its streaming kernels' plain
versions, which do the kernels' split/merge arithmetic split by split.
Inputs are made with numpy from a seed.  Tolerances are the JAX tests':
float32 forward atol 2e-5 / rtol 1e-4, gradients 1e-4 of their max, bf16
inputs 2e-2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import transformer as jtfm
from byteps_tpu.ops import flash_attention as jfa
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import transformer as tfm
from byteps_tpu_torch.ops import flash_attention as fa
import torch_port_jax_flash as jax_ref
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}
_WRAPPERS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_fwd_str",
             "flash_bwd_dq_str", "flash_bwd_dkv_str")


def _spy(monkeypatch):
    """Record the name of every flash wrapper the autograd op calls."""
    calls = []
    for name in _WRAPPERS:
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, _r=real, _n=name:
                            calls.append(_n) or _r(*a))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,bq,bk,split", [
    (256, 64, 128, 64),      # 4 splits
    (256, 128, 64, 128),     # 2 splits
    (320, 64, 64, 128),      # 3 splits, the last one ragged
])
def test_streaming_matches_jax(monkeypatch, s, bq, bk, split, causal, d,
                               dtype):
    """O, LSE and dQ/dK/dV (one vjp with the same dO) through the autograd
    op with streaming=True, against JAX's streaming kernels."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.RandomState(s + d)
    q, k, v, do = (rng.randn(2, s, d).astype(np.float32) for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (q, k, v, do))

    want, want_grads, want_lse = jax_ref.vjp(jq, jk, jv, jdo, causal, bq,
                                             bk, True)

    monkeypatch.setattr(fa, "_split_len", lambda s: split)
    calls = _spy(monkeypatch)
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal, None, bq, bk,
                             streaming=True)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(do).to(tdt))
    assert calls == ["flash_fwd_str", "flash_bwd_dq_str",
                     "flash_bwd_dkv_str"]
    _, lse = fa.flash_fwd_str(tq.detach(), tk.detach(), tv.detach(), causal,
                              1.0 / math.sqrt(d))
    assert out.dtype == tdt and lse.shape == (2, s)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse),
                               atol=2e-5, rtol=1e-5)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    fwd_tol = (dict(atol=2e-2) if dtype == "bfloat16"
               else dict(atol=2e-5, rtol=1e-4))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(want, np.float32), **fwd_tol)
    for got, ref in zip(grads, want_grads):
        ref = np.asarray(ref, np.float32)
        scale = float(np.abs(ref).max())
        np.testing.assert_allclose(got.float().numpy() / scale, ref / scale,
                                   atol=tol)


@pytest.mark.parametrize("shape,dtype,override", [
    ((1, 256, 64), "bfloat16", None),     # 32 KB: resident
    ((1, 32768, 64), "bfloat16", None),   # 8 MB: streaming
    ((1, 24576, 64), "bfloat16", None),   # 6 MB exactly: resident
    ((1, 24640, 64), "bfloat16", None),   # one tile more: streaming
    ((1, 12288, 64), "float32", None),
    ((1, 12352, 64), "float32", None),
    ((1, 256, 64), "bfloat16", True),     # explicit overrides
    ((1, 32768, 64), "bfloat16", False),
])
def test_use_streaming_matches_jax(shape, dtype, override):
    jdt, tdt = _DTYPES[dtype]
    want = jfa._use_streaming(jax.ShapeDtypeStruct(shape, jdt), override)
    assert fa._use_streaming(torch.empty(shape, dtype=tdt), override) == want


def test_auto_selection_routes_the_autograd_op(monkeypatch):
    """streaming=None takes the family the rule picks, forward and
    backward; the budget is read at call time, as in the JAX package."""
    calls = _spy(monkeypatch)
    q = torch.zeros(1, 128, 16, requires_grad=True)
    fa.flash_attention(q, q, q, True, None, 64, 64).sum().backward()
    monkeypatch.setattr(fa, "RESIDENT_VMEM_BUDGET", 0)
    fa.flash_attention(q, q, q, True, None, 64, 64).sum().backward()
    assert calls == ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "flash_fwd_str", "flash_bwd_dq_str", "flash_bwd_dkv_str"]


@pytest.mark.parametrize("s,split,splits", [
    (256, 4096, 1),
    (32768, 4096, 8),          # llama_300m's long path
    (32832, 4160, 8),          # one tile past 8 * 4,096: splits grow
    (131072, 16384, 8),
    (1 << 20, 131072, 8),
])
def test_split_rule_bounds_the_number_of_splits(s, split, splits):
    """Whole tiles, at least SPLIT_MIN_KEYS each, at most MAX_SPLITS: the
    float32 workspaces stay a bounded multiple of the output at any S."""
    got = fa._split_len(s)
    assert got % fa.TILE == 0 and got >= fa.SPLIT_MIN_KEYS
    assert (got, -(-s // got)) == (split, splits)
    assert splits <= fa.MAX_SPLITS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama_tiny_on_the_streaming_family_matches_jax(monkeypatch, dtype):
    """The slice end to end: llama_tiny's loss and gradients with the
    resident budget set to 0 in both packages, so both take their
    streaming kernels (the port in 2 splits), against each other.
    Tolerances as in test_torch_port_model.py: float32 loss 1e-5 relative
    and leaves 1e-4 of their max; bf16 loss 1e-2 and leaves 2e-2 in
    relative L2."""
    monkeypatch.setattr(jfa, "RESIDENT_VMEM_BUDGET", 0)
    monkeypatch.setattr(fa, "RESIDENT_VMEM_BUDGET", 0)
    monkeypatch.setattr(fa, "_split_len", lambda s: 64)
    calls = _spy(monkeypatch)
    jdt, tdt = _DTYPES[dtype]
    jcfg = jtfm.get_config("llama_tiny", dtype=jdt, attn_impl="flash")
    tcfg = tfm.get_config("llama_tiny", dtype=tdt, attn_impl="flash")
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(0), jcfg))
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 129))
    batch = toks[:, :-1], toks[:, 1:]

    jb = tuple(jnp.asarray(x, jnp.int32) for x in batch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jb, jcfg)))(params)
    jg = [np.asarray(g, np.float32) for g in jax.tree.leaves(jg)]

    tp = tfm.params_from_numpy(params, tcfg, device="cpu")
    tb = tuple(torch.from_numpy(x).long() for x in batch)
    tl = tfm.loss_fn(tp, tb, tcfg)
    tg = [g.float().numpy()
          for g in torch.autograd.grad(tl, tree_leaves(tp))]
    # 2 layers: forward and its remat recompute, then each backward kernel.
    assert sorted(calls) == sorted(["flash_fwd_str"] * 4
                                   + ["flash_bwd_dq_str"] * 2
                                   + ["flash_bwd_dkv_str"] * 2)
    tl, jl = float(tl.detach()), float(jl)
    if dtype == "float32":
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
        for a, b in zip(tg, jg):
            scale = float(np.abs(b).max()) + 1e-12
            np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)
        return
    assert abs(tl - jl) <= 1e-2, (tl, jl)
    for a, b in zip(tg, jg):
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        assert rel <= 2e-2, rel
