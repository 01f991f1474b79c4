"""byteps_tpu_torch's transformer vs the JAX package's, from the same params.

The JAX parameters are carried across with ``params_from_numpy``; tokens
are drawn with numpy.  JAX's flash kernels run in the Pallas interpreter.
Tolerances: in float32 the loss agrees to 1e-5 relative and each gradient
leaf to 1e-4 of its max; in bf16 the two frameworks round at different
points (the loss to 1e-2; gradients against the float32 truth, see
test_loss_and_grads_match_jax).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import transformer as jtfm
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import transformer as tfm
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(name, dtype="float32", **kw):
    jdt, tdt = _DTYPES[dtype]
    return (jtfm.get_config(name, dtype=jdt, **kw),
            tfm.get_config(name, dtype=tdt, **kw))


def _jax_params(jcfg, seed=0):
    return jax.tree.map(np.asarray, jtfm.init_params(jax.random.key(seed),
                                                     jcfg))


def _batch(cfg, b=2, s=64, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab_size, size=(b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def _jax_loss_grads(jcfg, params, batch):
    jb = tuple(jnp.asarray(x, jnp.int32) for x in batch)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jb, jcfg)))(params)
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _port_loss_grads(tcfg, params_np, batch):
    params = tfm.params_from_numpy(params_np, tcfg, device="cpu")
    tb = tuple(torch.from_numpy(x).long() for x in batch)
    loss = tfm.loss_fn(params, tb, tcfg)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return float(loss.detach()), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("name", ["tiny", "llama_tiny"])
def test_params_from_numpy_round_trip(name):
    jcfg, tcfg = _pair(name)
    jp = _jax_params(jcfg)
    tp = tfm.params_from_numpy(jp, tcfg, device="cpu")
    jleaves = jax.tree.leaves(jp)
    tleaves = tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert b.dtype == torch.float32 and b.requires_grad
        np.testing.assert_array_equal(b.detach().numpy(), a)
    # The port's own init builds the same tree (keys, shapes, order).
    own = tfm.init_params(torch.Generator().manual_seed(0), tcfg,
                          device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [a.shape for a in jleaves]
    assert tfm.num_params(own) == jtfm.num_params(jp)
    assert tfm.flops_per_token(tcfg) == jtfm.flops_per_token(jcfg)
    bad = dict(jp, embed=jp["embed"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        tfm.params_from_numpy(bad, tcfg, device="cpu")


@pytest.mark.parametrize("name", ["tiny", "llama_tiny"])
@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_jax(name, attn, dtype):
    jcfg, tcfg = _pair(name, dtype, attn_impl=attn)
    params = _jax_params(jcfg)
    batch = _batch(tcfg)
    jl, jg = _jax_loss_grads(jcfg, params, batch)
    tl, tg = _port_loss_grads(tcfg, params, batch)
    if dtype == "float32":
        assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
        for a, b in zip(tg, jg):
            scale = float(np.abs(b).max()) + 1e-12
            np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)
        return
    assert abs(tl - jl) <= 1e-2, (tl, jl)
    # bf16: JAX's own bf16 gradients sit up to 3.4e-2 of each leaf's max
    # from its float32 gradients on these inputs, and the worst single
    # element of two bf16 runs differs by up to 2.15e-2 of the max from
    # rounding alone.  So the leaves are compared in relative L2 norm,
    # which averages that noise (measured <= 1.8e-2 port vs JAX), and the
    # port must be no farther from the float32 truth than 1.5x JAX's bf16
    # (measured <= 1.16x).
    _, fg = _jax_loss_grads(_pair(name, "float32", attn_impl=attn)[0],
                            params, batch)

    def rel(x, ref):
        return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))

    for a, b, f in zip(tg, jg, fg):
        assert rel(a, b) <= 2e-2, rel(a, b)
        assert rel(a, f) <= 1.5 * rel(b, f), (rel(a, f), rel(b, f))


def test_streamed_lm_head_matches_jax():
    """ce_chunk_rows that does not divide B*S (JAX pads the last chunk)."""
    jcfg, tcfg = _pair("tiny", ce_chunk_rows=48, attn_impl="flash")
    params = _jax_params(jcfg, seed=1)
    batch = _batch(tcfg, seed=1)
    jl, jg = _jax_loss_grads(jcfg, params, batch)
    tl, tg = _port_loss_grads(tcfg, params, batch)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    for a, b in zip(tg, jg):
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)


def test_fused_nll_sum_equals_full_logits():
    """The streamed cross-entropy equals the full-logits path's sum."""
    jcfg, tcfg = _pair("tiny")
    params = tfm.params_from_numpy(_jax_params(jcfg), tcfg, device="cpu")
    toks, tgts = (torch.from_numpy(x).long() for x in _batch(tcfg, seed=2))
    with torch.no_grad():
        x = tfm.forward_hidden(params, toks, tcfg)
        logits = tfm.forward(params, toks, tcfg)
        full = -torch.log_softmax(logits, -1).gather(
            -1, tgts[..., None]).sum()
        for chunk in (16, 48, 128, 4096):
            got = tfm.fused_nll_sum(x, params["embed"], tgts, chunk)
            torch.testing.assert_close(got, full, rtol=1e-6, atol=1e-4)
        want = jtfm.fused_nll_sum(jnp.asarray(x.numpy()),
                                  jnp.asarray(params["embed"].numpy()),
                                  jnp.asarray(tgts.numpy(), jnp.int32), 48)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_jax_at_long_positions(dtype):
    """RoPE over S = 32,768 positions (the long-context path's length).
    XLA and torch round theta ** (-i / half) one float32 ulp apart for a
    few frequencies, so at position 32,767 the angles differ by up to
    7.6e-6 rad and the outputs by up to ~1.1e-5 * |x|: the port must stay
    within 1.5e-5 * max|x| of JAX (bf16: plus one bf16 rounding, 2^-7
    relative).  Both sit ~4.8e-3 from the float64 rotation, the float32
    angle's own rounding; the port must be no farther from it than JAX."""
    jdt, tdt = _DTYPES[dtype]
    x = np.random.RandomState(0).randn(1, 2, 32768, 64).astype(np.float32)
    want = np.asarray(jtfm._rope(jnp.asarray(x).astype(jdt), 10000.0),
                      np.float32)
    got = tfm._rope(torch.from_numpy(x).to(tdt), 10000.0)
    assert got.dtype == tdt
    got = got.float().numpy()
    tail = slice(-1024, None)
    atol = 1.5e-5 * float(np.abs(x).max())
    rtol = 2.0 ** -7 if dtype == "bfloat16" else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    np.testing.assert_allclose(got[..., tail, :], want[..., tail, :],
                               rtol=rtol, atol=atol)
    if dtype == "float32":
        half = 32
        ang = np.arange(32768.0)[:, None] * 10000.0 ** (
            -np.arange(half) / half)[None, :]
        x1, x2 = x[..., :half].astype(np.float64), x[..., half:]
        truth = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                                x2 * np.cos(ang) + x1 * np.sin(ang)], -1)
        assert (np.abs(got - truth).max()
                <= np.abs(want - truth).max() + atol)


def test_config_validation_and_remat_policies():
    with pytest.raises(ValueError, match="norm"):
        tfm.get_config("tiny", norm="batchnorm")
    with pytest.raises(ValueError, match="num_kv_heads"):
        tfm.get_config("tiny", num_kv_heads=3)
    with pytest.raises(ValueError, match="scan_unroll"):
        tfm.get_config("tiny", scan_unroll=3)
    assert set(tfm.CONFIGS) == set(jtfm.CONFIGS)
    for name, jc in jtfm.CONFIGS.items():
        tc = tfm.CONFIGS[name]
        for f in ("vocab_size", "num_layers", "d_model", "num_heads", "d_ff",
                  "max_seq_len", "causal", "norm", "act", "pos",
                  "num_kv_heads", "use_bias", "remat", "remat_policy"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
    cfg = tfm.get_config("tiny", dtype=torch.float32)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    toks = torch.zeros(1, 64, dtype=torch.long)
    # Every JAX policy runs, and none changes the forward's value.
    want = tfm.forward_hidden(params, toks, cfg)
    for policy in ("dots", "dots_no_batch", "proj"):
        got = tfm.forward_hidden(params, toks, tfm.get_config(
            "tiny", dtype=torch.float32, remat_policy=policy))
        assert torch.equal(got, want), policy
    with pytest.raises(ValueError, match="remat_policy"):
        tfm.forward_hidden(params, toks,
                           tfm.get_config("tiny", remat_policy="all"))
    with pytest.raises(ValueError, match="attn_impl"):
        tfm.forward_hidden(params, toks,
                           tfm.get_config("tiny", attn_impl="ring"))
