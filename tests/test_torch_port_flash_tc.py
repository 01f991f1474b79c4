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
  - in the backward (``refine=True``), a third term lo2 = bf16(x - hi -
    lo) for every block of 16 rows of P^T, dS or dS^T by the tile's 64
    contraction columns (what one warp's vote covers) that holds an
    element of magnitude 2^-5 or more (P^T) or 1 or more (dS, dS^T);
  - outputs rounded to the input dtype (LSE stays float32);
  - above D = 256 (the forward's split-D clusters), S = Q K^T as the sum,
    in rank order from zero, of float32 partials over 128-column chunks of
    D, each CTA's share; float16 takes its own hi/lo pair.

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
WIDE = 128                        # the wide forward's chunk of D
BF16_GATE = (2 ** -7, 1e-5)       # chip_smoke.py's gate for bf16 outputs
FP16_GATE = (2 ** -10, 1e-5)      # ... for float16 outputs, its own step
ROWS_GATE = (1e-5, 1e-6)          # ... and for LSE and delta (float32)


def _bf16(x):
    return x.to(torch.bfloat16).float()


REFINE_P = 0.03125                # the kernels' kRefineP
REFINE_DS = 1.0                   # ... and kRefineDs


def _parts(x, pair, refine=None, dtype=torch.bfloat16):
    """x as it enters a tensor-core product: the hi/lo pair, or one bf16;
    with ``refine`` (a magnitude), the pair plus the third term of every
    block of 16 rows (by all of the tile's contraction columns) holding an
    element that large.  ``dtype``: the 16-bit type of the parts (bf16;
    float16 in its forward)."""
    hi = x.to(dtype).float()
    if not pair:
        return (hi,)
    lo = (x - hi).to(dtype).float()
    if refine is None:
        return hi, lo
    *lead, rows, cols = x.shape
    blocks = x.abs().reshape(*lead, rows // 16, 16, cols)
    big = (blocks.amax((-2, -1)) >= refine)[..., :, None, None]
    return hi, lo, _bf16(x - hi - lo) * big.expand(blocks.shape).reshape(
        x.shape)


def _scores(qf, kf, chunk):
    """Q K^T in float32: one product, or with ``chunk`` the sum, in order
    from zero, of the products over each ``chunk`` columns of D."""
    if chunk is None:
        return qf @ kf.transpose(-1, -2)
    s = torch.zeros(*qf.shape[:-1], kf.shape[-2])
    for c0 in range(0, qf.shape[-1], chunk):
        s = s + qf[..., c0:c0 + chunk] @ kf[..., c0:c0 + chunk].transpose(
            -1, -2)
    return s


def _online(qf, kf, vf, causal, scale, pair, chunk, r0, k0, k1, dtype):
    """(m, l, acc) of the queries from row r0 over the keys [k0, k1), one
    64-key tile at a time, as the forward kernels' tile loop takes them."""
    m = torch.full(qf.shape[:2], -math.inf)
    l = torch.zeros(qf.shape[:2])
    acc = torch.zeros_like(qf)
    queries = torch.arange(r0, r0 + qf.shape[1])[:, None]
    for t0 in range(k0, k1, TILE):
        x = scale * _scores(qf, kf[:, t0:t0 + TILE], chunk)
        if causal:
            x = x.masked_fill(torch.arange(t0, t0 + TILE) > queries,
                              -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None]
        for part in _parts(p, pair, dtype=dtype):
            acc = acc + part @ vf[:, t0:t0 + TILE]
        m = m_new
    return m, l, acc


def emulate_fwd(q, k, v, causal, scale, pair=True, chunk=None, split=None):
    """O and LSE as fwd_mma_tiles computes them, one 64-key tile at a time:
    S = Q K^T times scale, the running max m, alpha = exp(m - m_new), the
    sum l and the accumulator rescaled by alpha, P V added with P as its
    hi/lo pair in the inputs' 16-bit type (or rounded once), O = acc / l,
    LSE = m + log l.  With ``chunk`` (the wide forward's 128), S is the sum
    in rank order, from zero, of the float32 partials over each ``chunk``
    columns of D, as a cluster's owner adds them.  With ``split`` (keys a
    split, streaming), each split's (m, l, acc) over its keys, for the
    rows that see them, merged as the merge pass merges them: M = max m_j,
    L = sum exp(m_j - M) l_j, O = sum exp(m_j - M) acc_j / L,
    LSE = M + log L, the splits in order."""
    qf, kf, vf = (t.float() for t in (q, k, v))
    s = q.shape[1]
    if split is None:
        m, l, acc = _online(qf, kf, vf, causal, scale, pair, chunk, 0, 0, s,
                            q.dtype)
        return (acc / l[..., None]).to(q.dtype), m + torch.log(l)
    parts = []
    for k0 in range(0, s, split):
        r0 = k0 if causal else 0  # earlier rows see none of these keys
        parts.append((r0, *_online(qf[:, r0:], kf, vf, causal, scale, pair,
                                   chunk, r0, k0, min(k0 + split, s),
                                   q.dtype)))
    big_m = torch.full(q.shape[:2], -math.inf)
    for r0, m, _, _ in parts:
        big_m[:, r0:] = torch.maximum(big_m[:, r0:], m)
    big_l = torch.zeros(q.shape[:2])
    out = torch.zeros_like(qf)
    for r0, m, l, acc in parts:
        w = torch.exp(m - big_m[:, r0:])
        big_l[:, r0:] += w * l
        out[:, r0:] += w[..., None] * acc
    return (out / big_l[..., None]).to(q.dtype), big_m + torch.log(big_l)


def emulate_dq(q, k, v, do, lse, delta, causal, scale, pair=True,
               refine=False):
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
        for part in _parts(ds, pair, REFINE_DS if refine else None):
            acc = acc + part @ kt
    return (scale * acc).to(q.dtype)


def emulate_dkv(q, k, v, do, lse, delta, causal, scale, pair=True,
                refine=False):
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
        for part in _parts(pt, pair, REFINE_P if refine else None):
            dv = dv + part @ dot
        for part in _parts(dst, pair, REFINE_DS if refine else None):
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


def _emulate(args, causal, pair, refine=False):
    q, k, v, do, lse, delta, scale = args
    dq = emulate_dq(q, k, v, do, lse, delta, causal, scale, pair, refine)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, causal, scale, pair,
                         refine)
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


@pytest.mark.parametrize("s", [64, 4096])
def test_third_term_holds_the_gate_where_ds_is_large(s):
    """The kernels' backward recipe (the pair, and the third term for
    blocks holding |P| >= 2^-5 or |dS| >= 1) within one bf16 step of the
    plain versions at the long contraction (S = 4096 causal) and at S = 64
    with dO 16x larger (|dS| up to ~100, attention on a few keys), where
    the pair alone leaves x - hi - lo, up to 2^-18 |x|, and misses the gate
    (measured: the pair 3.37 / 1.94 / 9.93 for dQ / dK / dV at
    [512, 64, 16], the recipe 0.99 / 0.98 / 0.91, readings near 1 being
    outputs one rounding step apart; on the card the pair missed by
    1.07-1.28 at B*H = 65,600 with dO unscaled)."""
    if s == 4096:
        args, plain = _case(4096, True)
    else:
        rng = np.random.RandomState(0)
        q, k, v, do = (torch.from_numpy(rng.randn(512, 64, 16).astype(
            np.float32)).to(torch.bfloat16) for _ in range(4))
        do = (do.float() * 16).to(torch.bfloat16)
        scale = 16 ** -0.5
        o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
        dq, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, True, scale)
        dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, scale)
        args, plain = (q, k, v, do, lse, delta, scale), (dq, dk, dv)
        pair = _emulate(args, True, pair=True)
        assert min(_worst(g, w) for g, w in zip(pair, plain)) > 1.5
    got = _emulate(args, True, pair=True, refine=True)
    worst = {n: _worst(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                 plain)}
    assert all(w <= 1.0 for w in worst.values()), worst


def _unrounded_margin(seed, refine_p=REFINE_P, sink=False,
                      pair_only=False):
    """Worst element of the recipe's dQ, dK, dV before the final rounding
    against the plain versions in float32, over the bf16 gate, with dO 16x
    larger: inputs drawn in bf16 and held in float32 tensors, so neither
    side rounds its output.  At [4096, 64, 16] causal, or with ``sink`` at
    [2, 4096, 64] causal with an attention sink (key 0 along a direction
    every query leans to, ~0.8 of each row's probability)."""
    rng = np.random.RandomState(seed)
    shape = (2, 4096, 64) if sink else (4096, 64, 16)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(np.float32))
                   for _ in range(4))
    if sink:
        u = torch.from_numpy(rng.randn(64).astype(np.float32))
        u = u / u.norm()
        q = q + 3 * u
        k[:, 0] = 25 * u
    q, k, v, do = (_bf16(t) for t in (q, k, v, do * 16))
    scale = shape[-1] ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, True, scale)
    dq, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, True, scale)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, True, scale)
    global REFINE_P
    kept, REFINE_P = REFINE_P, refine_p
    try:
        got = _emulate((q, k, v, do, lse, delta, scale), True, pair=True,
                       refine=not pair_only)
    finally:
        REFINE_P = kept
    return {n: _worst(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                               (dq, dk, dv))}


def test_third_term_holds_a_long_contraction_with_a_sink():
    """Sharp attention is not only a short-contraction case: at S = 4096
    with an attention sink and dO 16x larger the pair alone leaves dK at
    1.11 of the gate before rounding (it can miss after), and the recipe
    holds every gradient below half of it (measured 0.20 / 0.21 / 0.33),
    so the third term is kept at every S."""
    pair = _unrounded_margin(1, sink=True, pair_only=True)
    worst = _unrounded_margin(1, sink=True)
    assert pair["dk"] > 1.0, pair
    assert all(w <= 0.5 for w in worst.values()), worst


@pytest.mark.parametrize("seed", range(5))
def test_third_term_leaves_room_over_seeds(seed):
    """Below half the gate before rounding, two outputs rounded to bf16
    are at most one step apart, which the gate admits: the recipe stays
    there for every seed at S = 64 with dO 16x larger, over 4M elements a
    gradient (measured at most 0.18 / 0.18 / 0.28 for dQ / dK / dV over
    seeds 0-4; kRefineP = 2^-3 read 0.62-0.93 for dV)."""
    worst = _unrounded_margin(seed)
    assert all(w <= 0.5 for w in worst.values()), worst


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


_WIDE_DTYPES = {"bf16": (torch.bfloat16, BF16_GATE),
                "f16": (torch.float16, FP16_GATE)}


@functools.lru_cache(maxsize=None)
def _wide_case(dtype, d, causal):
    """[2, 1024, d] q, k, v in ``dtype`` from a seed, and the plain
    forward's O and LSE on them."""
    rng = np.random.RandomState(d + causal)
    q, k, v = (torch.from_numpy(rng.randn(2, 1024, d).astype(np.float32))
               .to(_WIDE_DTYPES[dtype][0]) for _ in range(3))
    scale = d ** -0.5
    return (q, k, v, scale), fa.flash_fwd_plain(q, k, v, causal, scale)


@pytest.mark.parametrize("split", [None, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_wide_fwd_recipe_passes_the_gates(dtype, d, causal, split):
    """The 16-bit wide forward's recipe (S the rank-order sum of the
    128-column chunks' float32 partials, the online step, P as its hi/lo
    pair in the inputs' type) holds O within the output's step of the
    plain forward, 2^-7 |plain| + 1e-5 in bf16 and 2^-10 |plain| + 1e-5 in
    float16, and LSE within 1e-5 |plain| + 1e-6, at [2, 1024, D], resident
    and in two splits of 512 keys merged (measured O 0.97-0.99 of the gate
    in bf16 and 0.91-0.96 in float16, readings near 1 being outputs one
    rounding step apart; LSE at most 0.10; P rounded once instead misses
    the O gate 23-93x in bf16 and 3.5-17x in float16)."""
    (q, k, v, scale), (o_p, lse_p) = _wide_case(dtype, d, causal)
    o, lse = emulate_fwd(q, k, v, causal, scale, chunk=WIDE, split=split)
    worst = {"o": _worst(o, o_p, _WIDE_DTYPES[dtype][1]),
             "lse": _worst(lse, lse_p, ROWS_GATE)}
    assert all(w <= 1.0 for w in worst.values()), worst


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_fwd_recipe_matches_jax_forward(causal, streaming):
    """At [2, 128, 384] bf16 the wide forward's recipe (resident, or in
    two splits of 64 keys) agrees with the JAX package's forward (Pallas
    interpreter, the resident or the streaming kernel): O within one bf16
    step of every element, LSE within 1e-5."""
    rng = np.random.RandomState(13 + causal)
    q, k, v = (rng.randn(2, 128, 384).astype(np.float32) for _ in range(3))
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    o, (_, _, _, _, lse) = jax_flash_fwd(jq, jk, jv, causal, None, 64, 64,
                                         True, streaming)
    want_o = torch.from_numpy(np.array(o.astype(jnp.float32)))
    want_lse = torch.from_numpy(np.array(lse))[:, 0, :]
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got_o, got_lse = emulate_fwd(tq, tk, tv, causal, 384 ** -0.5,
                                 chunk=WIDE, split=64 if streaming else None)
    worst = {"o": _worst(got_o, want_o),
             "lse": _worst(got_lse, want_lse, ROWS_GATE)}
    assert all(w <= 1.0 for w in worst.values()), worst

if __name__ == "__main__":
    # The margin of the third term's threshold, for PERF.md: the worst
    # unrounded ratio of dQ, dK, dV per seed at kRefineP = 2^-3, 2^-4, 2^-5,
    # at S = 64 and at S = 4096 with a sink, and the pair alone there.
    for p in (2 ** -3, 2 ** -4, 2 ** -5):
        for seed in range(5):
            print(f"kRefineP 2^{int(math.log2(p))} seed {seed}:",
                  {n: round(w, 3)
                   for n, w in _unrounded_margin(seed, p).items()})
        for seed in range(2):
            print(f"kRefineP 2^{int(math.log2(p))} sink, seed {seed}:",
                  {n: round(w, 3) for n, w in
                   _unrounded_margin(seed, p, sink=True).items()})
    for seed in range(2):
        print(f"pair only, sink, seed {seed}:",
              {n: round(w, 3) for n, w in
               _unrounded_margin(seed, sink=True, pair_only=True).items()})
