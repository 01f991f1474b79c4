"""The numeric recipe of the bf16 flash kernels on the tensor cores.

The CUDA kernels (``fwd_mma_tiles`` / ``dq_mma_tiles`` / ``dkv_mma_tiles``
in ``byteps_tpu_torch/csrc/flash_attention.cu``) cannot run on the CPU.
This file keeps a torch emulation of their arithmetic, here and nowhere
else:

  - bf16 operands multiplied exactly, products summed in float32;
  - the contraction walked in 64-row tiles, as the kernels walk it (the
    forward with its online softmax: running max, rescaled sum and
    accumulator, all float32);
  - P and dS entering the second products (P V, dS K, P^T dO, dS^T Q) as
    a hi/lo bf16 pair, hi = bf16(x), lo = bf16(x - hi), two products into
    one float32 sum;
  - outputs rounded to the input dtype (LSE stays float32).

It is held to ``chip_smoke.py``'s elementwise gates, |got - plain| <=
2^-7 |plain| + 1e-5 (one bf16 step) for bf16 outputs and 1e-5 |plain| +
1e-6 for LSE, against the port's plain versions at contraction lengths of
2,048 and 4,096, and to the JAX package's forward and backward (Pallas
interpreter).  Recorded cases show that rounding P (and dS) to bf16 once,
the usual recipe, fails the same gate by a factor above 10: the pair is
what the gate needs.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from byteps_tpu.ops.flash_attention import flash_attention as jax_flash
from byteps_tpu_torch.ops import flash_attention as fa
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

TILE = 64
BF16_GATE = (2 ** -7, 1e-5)       # chip_smoke.py's gate for bf16 outputs
ROWS_GATE = (1e-5, 1e-6)          # ... and for LSE and delta (float32)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _parts(x, pair):
    """x as it enters a tensor-core product: the hi/lo pair, or one bf16."""
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if pair else (hi,)


def emulate_fwd(q, k, v, causal, scale, pair=True):
    """O and LSE as fwd_mma_tiles computes them, one 64-key tile at a time:
    S = Q K^T times scale, the running max m, alpha = exp(m - m_new), the
    sum l and the accumulator rescaled by alpha, P V added with P as its
    hi/lo pair (or rounded once), O = acc / l, LSE = m + log l."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = q.shape[1]
    m = torch.full(q.shape[:2], -math.inf)
    l = torch.zeros(q.shape[:2])
    acc = torch.zeros_like(qf)
    queries = torch.arange(s)[:, None]
    for k0 in range(0, s, TILE):
        x = scale * (qf @ kf[:, k0:k0 + TILE].transpose(-1, -2))
        if causal:
            x = x.masked_fill(torch.arange(k0, k0 + TILE) > queries,
                              -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for part in _parts(p, pair):
            acc = acc + part @ vf[:, k0:k0 + TILE]
        m = m_new
    return (acc / l[..., None]).to(q.dtype), m + torch.log(l)


def emulate_dq(q, k, v, do, lse, delta, causal, scale, pair=True):
    """dQ as dq_mma_tiles computes it, one 64-key tile at a time."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = q.shape[1]
    acc = torch.zeros_like(qf)
    queries = torch.arange(s)[:, None]
    for k0 in range(0, s, TILE):
        kt, vt = kf[:, k0:k0 + TILE], vf[:, k0:k0 + TILE]
        p = torch.exp(scale * (qf @ kt.transpose(-1, -2)) - lse[..., None])
        if causal:
            p = p.masked_fill(torch.arange(k0, k0 + TILE) > queries, 0.0)
        ds = p * (dof @ vt.transpose(-1, -2) - delta[..., None])
        for part in _parts(ds, pair):
            acc = acc + part @ kt
    return (scale * acc).to(q.dtype)


def emulate_dkv(q, k, v, do, lse, delta, causal, scale, pair=True):
    """dK, dV as dkv_mma_tiles computes them: S^T = K Q^T with the keys as
    rows, one 64-query tile at a time."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = q.shape[1]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    keys = torch.arange(s)[:, None]
    for q0 in range(0, s, TILE):
        qt, dot = qf[:, q0:q0 + TILE], dof[:, q0:q0 + TILE]
        pt = torch.exp(scale * (kf @ qt.transpose(-1, -2))
                       - lse[:, None, q0:q0 + TILE])
        if causal:
            pt = pt.masked_fill(keys > torch.arange(q0, q0 + TILE), 0.0)
        dst = pt * (vf @ dot.transpose(-1, -2) - delta[:, None, q0:q0 + TILE])
        for part in _parts(pt, pair):
            dv = dv + part @ dot
        for part in _parts(dst, pair):
            dk = dk + part @ qt
    return (scale * dk).to(k.dtype), dv.to(v.dtype)


def _worst(got, want, tol=BF16_GATE):
    """The worst element's |got - want| over its limit (<= 1 passes)."""
    rtol, atol = tol
    g, w = got.float(), want.float()
    return float(((g - w).abs() / (w.abs() * rtol + atol)).max())


@functools.lru_cache(maxsize=None)
def _case(s, causal):
    """bf16 [2, s, 64] inputs from a seed, the plain forward's LSE, and the
    plain backward (dQ, delta, dK, dV)."""
    rng = np.random.RandomState(s + causal)
    q, k, v, do = (torch.from_numpy(rng.randn(2, s, 64).astype(np.float32))
                   .to(torch.bfloat16) for _ in range(4))
    scale = 64 ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    dq, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal, scale)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    return (q, k, v, do, lse, delta, scale), (dq, dk, dv)


def _emulate(args, causal, pair):
    q, k, v, do, lse, delta, scale = args
    dq = emulate_dq(q, k, v, do, lse, delta, causal, scale, pair)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, causal, scale, pair)
    return dq, dk, dv


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [2048, 4096])
def test_pair_passes_the_bf16_gate(s, causal):
    """The hi/lo recipe holds every element of dQ, dK and dV within one
    bf16 step of the plain versions (measured worst ratios 0.94-0.98)."""
    args, plain = _case(s, causal)
    got = _emulate(args, causal, pair=True)
    worst = {n: _worst(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                 plain)}
    assert all(w <= 1.0 for w in worst.values()), worst


def test_single_rounding_fails_the_bf16_gate():
    """Recorded so nobody "simplifies" the kernels: P and dS rounded to
    bf16 once fail the gate at S = 4096 causal, each of dQ, dK and dV by
    more than 10x (measured 57, 73 and 103)."""
    args, plain = _case(4096, True)
    got = _emulate(args, True, pair=False)
    worst = {n: _worst(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                 plain)}
    assert all(w > 10.0 for w in worst.values()), worst


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_pair_matches_jax_backward(causal, streaming):
    """At [2, 256, 64] bf16 the recipe, fed the JAX forward's O and LSE,
    agrees with jax.vjp of the JAX package's flash attention (Pallas
    interpreter, the resident or the streaming kernels) within one bf16
    step of every element."""
    rng = np.random.RandomState(7 + causal)
    q, k, v, do = (rng.randn(2, 256, 64).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, None, 64,
                                               64, True, streaming),
                     jq, jk, jv)
    want = [torch.from_numpy(np.array(g.astype(jnp.float32)))
            for g in vjp(jdo)]
    o, (_, _, _, _, lse) = jax_flash_fwd(jq, jk, jv, causal, None, 64, 64,
                                         True, streaming)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    to = torch.from_numpy(np.array(o.astype(jnp.float32)))
    tlse = torch.from_numpy(np.array(lse))[:, 0, :]
    delta = (tdo.float() * to).sum(-1)
    got = _emulate((tq, tk, tv, tdo, tlse, delta, 64 ** -0.5), causal,
                   pair=True)
    worst = {n: _worst(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                 want)}
    assert all(w <= 1.0 for w in worst.values()), worst


@functools.lru_cache(maxsize=None)
def _fwd_case(s, causal):
    """bf16 [2, s, 64] q, k, v (as _case draws them) and the plain
    forward's O and LSE."""
    (q, k, v, _, lse, _, scale), _ = _case(s, causal)
    o, _ = fa.flash_fwd_plain(q, k, v, causal, scale)
    return (q, k, v, scale), (o, lse)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [2048, 4096])
def test_fwd_pair_passes_the_gates(s, causal):
    """The forward's hi/lo recipe holds every element of O within one bf16
    step of the plain forward (measured worst ratios 0.95-0.98; rounding O
    alone reaches 0.89-0.95) and every LSE within 1e-5 (0.015 at most)."""
    (q, k, v, scale), (o_p, lse_p) = _fwd_case(s, causal)
    o, lse = emulate_fwd(q, k, v, causal, scale)
    worst = {"o": _worst(o, o_p), "lse": _worst(lse, lse_p, ROWS_GATE)}
    assert all(w <= 1.0 for w in worst.values()), worst


def test_fwd_single_rounding_fails_the_bf16_gate():
    """Recorded so nobody "simplifies" the forward: P rounded to bf16 once
    before P V, the usual recipe, fails the O gate at S = 4096 causal by
    more than 10x (measured 68)."""
    (q, k, v, scale), (o_p, _) = _fwd_case(4096, True)
    o, _ = emulate_fwd(q, k, v, True, scale, pair=False)
    assert _worst(o, o_p) > 10.0


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_pair_matches_jax_forward(causal, streaming):
    """At [2, 256, 64] bf16 the forward recipe agrees with the JAX
    package's forward (Pallas interpreter, the resident or the streaming
    kernel): O within one bf16 step of every element, LSE within 1e-5."""
    rng = np.random.RandomState(11 + causal)
    q, k, v = (rng.randn(2, 256, 64).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    o, (_, _, _, _, lse) = jax_flash_fwd(jq, jk, jv, causal, None, 64, 64,
                                         True, streaming)
    want_o = torch.from_numpy(np.array(o.astype(jnp.float32)))
    want_lse = torch.from_numpy(np.array(lse))[:, 0, :]
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got_o, got_lse = emulate_fwd(tq, tk, tv, causal, 64 ** -0.5)
    worst = {"o": _worst(got_o, want_o),
             "lse": _worst(got_lse, want_lse, ROWS_GATE)}
    assert all(w <= 1.0 for w in worst.values()), worst
