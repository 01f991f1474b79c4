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
  - above D = 256 (the split-D clusters), S = Q K^T (and dP = dO V^T) as
    the sum, in rank order from zero, of float32 partials over 128-column
    chunks of D, each CTA's share; float16 takes its own hi/lo pair, in the
    backward with each row scaled by a power of two (scale_rows, on a
    tile's 64 columns); the backward's third-term vote takes blocks of
    16 x 16.

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

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu_torch.ops import flash_attention as fa
import torch_port_jax_flash as jax_ref
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


def _parts(x, pair, refine=None, dtype=torch.bfloat16, block=None):
    """x as it enters a tensor-core product: the hi/lo pair, or one bf16;
    with ``refine`` (a magnitude), the pair plus the third term of every
    block of 16 rows by ``block`` contraction columns (all of x's by
    default) holding an element that large.  ``dtype``: the 16-bit type of
    the parts (bf16; float16 in its forward and wide backward)."""
    hi = x.to(dtype).float()
    if not pair:
        return (hi,)
    lo = (x - hi).to(dtype).float()
    if refine is None:
        return hi, lo
    *lead, rows, cols = x.shape
    block = block or cols
    blocks = x.abs().reshape(*lead, rows // 16, 16, cols // block, block)
    big = (blocks.amax((-3, -1), keepdim=True) >= refine).expand(
        blocks.shape).reshape(x.shape)
    return hi, lo, _bf16(x - hi - lo) * big


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


def _row_scales(cs, x, block):
    """float16's scale_rows over the blocks of ``block`` columns of x in
    order: each row's power of two c = 2^min(15 - ex, 24), mx < 2^ex its
    largest magnitude in the block, taken when it is below the row's
    running cs.  Returns the last cs and each column's cs (its block's)."""
    per = []
    for c0 in range(0, x.shape[-1], block):
        mx = x[..., c0:c0 + block].abs().amax(-1)
        c = torch.exp2(torch.clamp(15 - torch.frexp(mx).exponent,
                                   max=24).float())
        cs = torch.where((mx > 0) & (c < cs), c, cs)
        per.append(cs)
    return cs, torch.stack(per, -1).repeat_interleave(block, -1)


def _apply(acc, cs, x, b, pair, refine, dtype, block):
    """acc += X B as the backward's second products take it: X (P^T, dS or
    dS^T, the contraction along its last axis: a tile's 64 columns)
    entering as _parts in ``dtype``, the third term's vote on blocks of 16
    rows by ``block`` columns (all of them by default); with ``cs``
    (float16's running row scales) the rows scaled by powers of two over
    all of X's columns before the split and the scale divided out of the
    products (exact: the kernels' accumulator carries it and divides it out
    at the end).  Returns acc and cs."""
    block = block or x.shape[-1]
    sc = None
    if cs is not None:
        cs, sc = _row_scales(cs, x, x.shape[-1])
        x = x * sc
    for part in _parts(x, pair, refine, dtype, block):
        acc = acc + (part if sc is None else part / sc) @ b
    return acc, cs


def _bwd_recipe(x, refine, pair):
    """The 16-bit type of the second products' parts, the third term's
    threshold (bf16 only) and whether rows are scaled (float16)."""
    f16 = x.dtype == torch.float16
    return (torch.float16 if f16 else torch.bfloat16,
            None if f16 or not refine else refine, f16 and pair)


def emulate_dq(q, k, v, do, lse, delta, causal, scale, pair=True,
               refine=False, chunk=None, split=None, block=None):
    """dQ as dq_mma_tiles computes it, one 64-key tile at a time.  With
    ``chunk`` (the wide kernels' 128), S and dP are the sums in rank order,
    from zero, of the float32 partials over each ``chunk`` columns of D, as
    a cluster's owner adds them; ``block`` (16 there) is the columns of the
    third term's vote and of float16's row scale (the tile's 64 by
    default).  float16 inputs take float16's pair, rows scaled by powers of
    two over each tile's columns (scale_rows), and no third term.  With
    ``split`` (keys a split, streaming), each split's dQ from zero (its own
    row scales), the splits summed in order from zero, as the sum pass adds
    the workspaces."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = q.shape[1]
    dtype, third, scaled = _bwd_recipe(q, REFINE_DS if refine else None, pair)
    queries = torch.arange(s)[:, None]
    s_all, dp_all = _scores(qf, kf, chunk), _scores(dof, vf, chunk)
    total = torch.zeros_like(qf)
    step = split or s
    for j0 in range(0, s, step):
        acc = torch.zeros_like(qf)
        cs = torch.full(qf.shape[:2], 2.0 ** 24) if scaled else None
        for k0 in range(j0, min(j0 + step, s), TILE):
            kt = kf[:, k0:k0 + TILE]
            p = torch.exp(scale * s_all[..., k0:k0 + TILE] - lse[..., None])
            if causal:
                p = p.masked_fill(torch.arange(k0, k0 + TILE) > queries, 0.0)
            ds = p * (dp_all[..., k0:k0 + TILE] - delta[..., None])
            acc, cs = _apply(acc, cs, ds, kt, pair, third, dtype, block)
        total = total + acc
    return (scale * total).to(q.dtype)


def emulate_dkv(q, k, v, do, lse, delta, causal, scale, pair=True,
                refine=False, chunk=None, split=None, block=None):
    """dK, dV as dkv_mma_tiles computes them: S^T = K Q^T with the keys as
    rows, one 64-query tile at a time; ``chunk``, ``block``, float16 and
    ``split`` (queries a split) as in emulate_dq, the row scales by key."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    s = q.shape[1]
    dtype, third_p, scaled = _bwd_recipe(q, REFINE_P if refine else None,
                                         pair)
    third_ds = _bwd_recipe(q, REFINE_DS if refine else None, pair)[1]
    keys = torch.arange(s)[:, None]
    st_all, dpt_all = _scores(kf, qf, chunk), _scores(vf, dof, chunk)
    dk_t, dv_t = torch.zeros_like(kf), torch.zeros_like(vf)
    step = split or s
    for j0 in range(0, s, step):
        dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
        csk = torch.full(kf.shape[:2], 2.0 ** 24) if scaled else None
        csv = torch.full(kf.shape[:2], 2.0 ** 24) if scaled else None
        for q0 in range(j0, min(j0 + step, s), TILE):
            qt, dot = qf[:, q0:q0 + TILE], dof[:, q0:q0 + TILE]
            pt = torch.exp(scale * st_all[..., q0:q0 + TILE]
                           - lse[:, None, q0:q0 + TILE])
            if causal:
                pt = pt.masked_fill(keys > torch.arange(q0, q0 + TILE), 0.0)
            dst = pt * (dpt_all[..., q0:q0 + TILE]
                        - delta[:, None, q0:q0 + TILE])
            dv, csv = _apply(dv, csv, pt, dot, pair, third_p, dtype, block)
            dk, csk = _apply(dk, csk, dst, qt, pair, third_ds, dtype, block)
        dk_t, dv_t = dk_t + dk, dv_t + dv
    return (scale * dk_t).to(k.dtype), dv_t.to(v.dtype)


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


@functools.lru_cache(maxsize=None)
def _margin_case(seed, sink):
    """The inputs of _unrounded_margin and the plain versions' outputs."""
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
    return (q, k, v, do, lse, delta, scale), (dq, dk, dv)


def _unrounded_margin(seed, refine_p=REFINE_P, sink=False,
                      pair_only=False):
    """Worst element of the recipe's dQ, dK, dV before the final rounding
    against the plain versions in float32, over the bf16 gate, with dO 16x
    larger: inputs drawn in bf16 and held in float32 tensors, so neither
    side rounds its output.  At [4096, 64, 16] causal, or with ``sink`` at
    [2, 4096, 64] causal with an attention sink (key 0 along a direction
    every query leans to, ~0.8 of each row's probability)."""
    args, plain = _margin_case(seed, sink)
    global REFINE_P
    kept, REFINE_P = REFINE_P, refine_p
    try:
        got = _emulate(args, True, pair=True, refine=not pair_only)
    finally:
        REFINE_P = kept
    return {n: _worst(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                               plain)}


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
    o, grads, lse = jax_ref.vjp(jq, jk, jv, jdo, causal, 64, 64, streaming)
    want = [torch.from_numpy(np.array(g.astype(jnp.float32)))
            for g in grads]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    to = torch.from_numpy(np.array(o.astype(jnp.float32)))
    tlse = torch.from_numpy(np.array(lse))
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
    o, lse = jax_ref.forward(jq, jk, jv, causal, 64, 64, streaming)
    want_o = torch.from_numpy(np.array(o.astype(jnp.float32)))
    want_lse = torch.from_numpy(np.array(lse))
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
    o, lse = jax_ref.forward(jq, jk, jv, causal, 64, 64, streaming)
    want_o = torch.from_numpy(np.array(o.astype(jnp.float32)))
    want_lse = torch.from_numpy(np.array(lse))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got_o, got_lse = emulate_fwd(tq, tk, tv, causal, 384 ** -0.5,
                                 chunk=WIDE, split=64 if streaming else None)
    worst = {"o": _worst(got_o, want_o),
             "lse": _worst(got_lse, want_lse, ROWS_GATE)}
    assert all(w <= 1.0 for w in worst.values()), worst

@functools.lru_cache(maxsize=None)
def _wide_bwd_case(dtype, d, causal):
    """[2, 1024, d] q, k, v (as _wide_case draws them) and dO in ``dtype``,
    the plain forward's LSE, and the plain backward (dQ, delta, dK, dV)."""
    (q, k, v, scale), (o, lse) = _wide_case(dtype, d, causal)
    rng = np.random.RandomState(d + causal + 1)
    do = torch.from_numpy(rng.randn(2, 1024, d).astype(np.float32)).to(
        _WIDE_DTYPES[dtype][0])
    dq, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal, scale)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    return (q, k, v, do, lse, delta, scale), (dq, dk, dv)


def _emulate_wide(args, causal, split):
    """dQ, dK, dV by the 16-bit wide backward's recipe."""
    q, k, v, do, lse, delta, scale = args
    kw = dict(refine=True, chunk=WIDE, split=split, block=16)
    dq = emulate_dq(q, k, v, do, lse, delta, causal, scale, **kw)
    return (dq, *emulate_dkv(q, k, v, do, lse, delta, causal, scale, **kw))


@pytest.mark.parametrize("split", [None, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("dtype", ["bf16", "f16"])
def test_wide_bwd_recipe_passes_the_gates(dtype, d, causal, split):
    """The 16-bit wide backward's recipe (S and dP the rank-order sums of
    the 128-column chunks' float32 partials; P and dS as hi/lo pairs in
    the inputs' type; bf16's third term on 16 x 16 blocks and float16's
    row scale on 16 x 64) holds dQ, dK and dV within the output's step of
    the plain backward, 2^-7 |plain| + 1e-5 in bf16 and 2^-10 |plain| + 1e-5 in
    float16, at [2, 1024, D], resident and in two splits of 512 (measured
    0.961-0.987 of the gate in bf16 and 0.850-0.979 in float16, readings
    near 1 being outputs one rounding step apart)."""
    args, plain = _wide_bwd_case(dtype, d, causal)
    got = _emulate_wide(args, causal, split)
    tol = _WIDE_DTYPES[dtype][1]
    worst = {n: _worst(g, w, tol) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                      plain)}
    assert all(w <= 1.0 for w in worst.values()), worst


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_bwd_recipe_matches_jax_backward(causal, streaming):
    """At [2, 128, 384] bf16 the wide backward's recipe (resident, or in
    two splits of 64), fed the JAX forward's O and LSE, agrees with jax.vjp
    of the JAX package's flash attention (Pallas interpreter, the resident
    or the streaming kernels) within one bf16 step of every element
    (measured 0.83-0.97 of the gate)."""
    rng = np.random.RandomState(17 + causal)
    q, k, v, do = (rng.randn(2, 128, 384).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v, do))
    o, grads, lse = jax_ref.vjp(jq, jk, jv, jdo, causal, 64, 64, streaming)
    want = [torch.from_numpy(np.array(g.astype(jnp.float32)))
            for g in grads]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    to = torch.from_numpy(np.array(o.astype(jnp.float32)))
    tlse = torch.from_numpy(np.array(lse))
    delta = (tdo.double() * to.double()).sum(-1).float()
    got = _emulate_wide((tq, tk, tv, tdo, tlse, delta, 384 ** -0.5), causal,
                        64 if streaming else None)
    worst = {n: _worst(g, w) for n, g, w in zip(("dq", "dk", "dv"), got,
                                                 want)}
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
