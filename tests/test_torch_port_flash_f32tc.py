"""The numeric recipe of the float32 flash kernels on the tensor cores.

The CUDA kernels (``dq_tiles_f32``, ``dkv_tiles_f32`` and
``fwd_tiles_f32``, the float32 backward and forward at every head dim, in
``byteps_tpu_torch/csrc/flash_attention.cu``) cannot run on the CPU.
This file keeps a torch emulation of their arithmetic:

  - every product on the tensor cores in 3xTF32: each operand x split as
    hi = tf32(x), lo = tf32(x - hi), with tf32 a round to nearest (ties
    away from zero, as cvt.rna) to a 10-bit mantissa, and a product taken
    as lo hi + hi lo + hi hi (lo lo dropped);
  - the tensor cores' sums: one MMA adds the exact sum of 8 products (one
    k step) to its float32 accumulator and truncates the result toward
    zero; every 16 elements of a contraction (two k steps, six MMAs) go
    into a zeroed accumulator that is added to the sum in float32 (round
    to nearest);
  - the contraction walked in 64-row tile pairs;
  - per tile pair, S = Q K^T and dP = dO V^T as the sum of the D / W
    slices' partials (each slice's CTA contracts over its own W columns,
    W = min(D, 128): one slice, one CTA, at D <= 128), added in rank
    order 0..n-1; P = exp(scale S - LSE), dS = P (dP -
    delta); the second products (dS K, P^T dO, dS^T Q) of each tile pair
    added to the output's accumulator 16 rows at a time;
  - in the streaming family, one partial a split, summed in split order;
  - the forward (``emulate_fwd``): per tile pair S from the slices'
    partials in rank order (one slice, one CTA, at D <= 128; a cluster of
    two at D = 256), the online-softmax step m' = max(m, scale S),
    alpha = exp(m - m'), P = exp(scale S - m'), l' = alpha l + rowsum(P),
    and acc' = alpha acc + P V, P V in the same 3xTF32 recipe; each split's
    (m, l, acc) merged in split order, O = acc / l, LSE = m + log l.

It is held to ``chip_smoke.py``'s float32 gates, |got - plain| <= 1e-4
|plain| + 1e-5 for dQ, dK and dV (1e-4 |plain| + 2e-5 for O) and
1e-5 |plain| + 1e-6 for LSE and delta, against the port's plain versions
(the backward and the forward at D = 16 to 512, the backward also to the
card tests' 1e-5 of the largest element at D = 16 to 256) and the JAX
package's forward and backward (Pallas interpreter; both at D = 64, 256,
384 and 512).  Four controls: one TF32 rounding of each operand, the usual
recipe, misses the same gates in the backward, and in the forward whether
it is taken for S or for P V; one truncating accumulator for a whole
128-column chunk (and a whole tile pair) reads several times higher than
the 16-element partials; and partials summed in another order for each
slice give P that differs between slices, which is why the owner of a row
sums them once, in rank order.
"""

import functools

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
SLICE = 128                       # the kernels' kWide: a CTA's columns
F32_GATE = (1e-4, 1e-5)           # chip_smoke.py's gate for float32 outputs
O_GATE = (1e-4, 2e-5)             # ... for the forward's O
ROWS_GATE = (1e-5, 1e-6)          # ... and for LSE and delta


def tf32(x):
    """x rounded to TF32 (a 10-bit mantissa), to nearest, ties away from
    zero, as cvt.rna.tf32.f32: add half a step to the magnitude's bits and
    clear the 13 bits below the mantissa."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def rz32(x):
    """float64 x rounded to float32 toward zero."""
    r = x.float()
    over = r.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)


def slice_width(d):
    """W, the columns of a tile a CTA holds at head dim d: all of D up to
    SLICE (one CTA, no cluster), SLICE above."""
    return min(d, SLICE)


def _chunk_order(w):
    """The order of a W-column chunk's columns in the first products' k
    steps: a lane's 16-byte load holds columns 4t..4t+3 of 16; one k step
    takes 4t and 4t + 1, the next 4t + 2 and 4t + 3."""
    return [16 * j + 4 * t + e for j in range(w // 16)
            for pair in ((0, 1), (2, 3)) for t in range(4) for e in pair]


class Recipe:
    """The products of the kernels: ``terms`` 3 (3xTF32) or 1 (one TF32
    rounding), and a zeroed accumulator every ``group`` k steps of 8."""

    def __init__(self, terms=3, group=2):
        self.terms, self.group = terms, group

    def __call__(self, a, b, chunk=False, acc=None):
        """acc + a [..., M, K] @ b [K, N] (b may carry a's leading dims);
        ``chunk``: K is a W-column chunk in the first products' order."""
        if chunk:
            order = _chunk_order(a.shape[-1])
            a, b = a[..., order], b[..., order, :]
        ah, bh = tf32(a), tf32(b)
        parts = [(ah, bh)]
        if self.terms == 3:
            al, bl = tf32(a - ah), tf32(b - bh)
            parts = [(al, bh), (ah, bl), (ah, bh)]
        k, step = a.shape[-1], 8 * self.group
        for k0 in range(0, k, step):  # one zeroed accumulator each
            part = torch.zeros(*a.shape[:-1], b.shape[-1],
                               dtype=torch.float64)
            for s0 in range(k0, k0 + step, 8):
                for x, y in parts:
                    part = rz32(part + x[..., s0:s0 + 8].double()
                                @ y[..., s0:s0 + 8, :].double()).double()
            acc = part.float() if acc is None else acc + part.float()
        return acc


mm3 = Recipe()                     # the kernels
mm1 = Recipe(terms=1)              # control: one TF32 rounding
mm3_chunk = Recipe(group=16)       # control: one accumulator a chunk


def _tile_pair(qt, kt, dot, vt, q0, k0, lse, delta, causal, scale, mm,
               order=None):
    """P and dS of one tile pair from the slices' partials of S = Q K^T and
    dP = dO V^T, added in rank order (or in ``order``)."""
    w = slice_width(qt.shape[-1])
    n = qt.shape[-1] // w
    cols = [slice(j * w, (j + 1) * w) for j in range(n)]
    order = range(n) if order is None else order
    s = dp = None
    for j in order:
        ps = mm(qt[..., cols[j]], kt[..., cols[j]].transpose(-1, -2), True)
        pd = mm(dot[..., cols[j]], vt[..., cols[j]].transpose(-1, -2), True)
        s = ps if s is None else s + ps
        dp = pd if dp is None else dp + pd
    p = torch.exp(scale * s - lse[:, q0:q0 + TILE, None])
    if causal:
        keys = torch.arange(k0, k0 + TILE)
        p = p.masked_fill(keys > torch.arange(q0, q0 + TILE)[:, None], 0.0)
    return p, p * (dp - delta[:, q0:q0 + TILE, None])


def _visible(q0, k0, causal):
    return not causal or k0 <= q0 + TILE - 1


def emulate_dq(q, k, v, do, lse, delta, causal, scale, mm=mm3, split=None):
    """dQ as dq_tiles_f32 computes it: for each q tile, the k tiles in
    splits of ``split`` tiles (all of them in the resident family), one
    float32 partial a split, the partials summed in split order."""
    s_len = q.shape[1]
    split = split or s_len // TILE
    dq = torch.zeros_like(q)
    for q0 in range(0, s_len, TILE):
        qt, dot = q[:, q0:q0 + TILE], do[:, q0:q0 + TILE]
        total = None
        for sp0 in range(0, s_len, split * TILE):
            acc = None
            for k0 in range(sp0, min(sp0 + split * TILE, s_len), TILE):
                if not _visible(q0, k0, causal):
                    continue
                kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
                _, ds = _tile_pair(qt, kt, dot, vt, q0, k0, lse, delta,
                                   causal, scale, mm)
                acc = mm(ds, kt, acc=acc)
            if acc is not None:
                total = acc if total is None else total + acc
        dq[:, q0:q0 + TILE] = scale * total
    return dq


def emulate_dkv(q, k, v, do, lse, delta, causal, scale, mm=mm3, split=None):
    """dK, dV as dkv_tiles_f32 computes them: the k tile fixed, the q
    tiles in splits, P^T dO and dS^T Q of each pair added to dV and dK."""
    s_len = q.shape[1]
    split = split or s_len // TILE
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for k0 in range(0, s_len, TILE):
        kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
        tot_k = tot_v = None
        for sp0 in range(0, s_len, split * TILE):
            acc_k = acc_v = None
            for q0 in range(sp0, min(sp0 + split * TILE, s_len), TILE):
                if not _visible(q0, k0, causal):
                    continue
                qt, dot = q[:, q0:q0 + TILE], do[:, q0:q0 + TILE]
                p, ds = _tile_pair(qt, kt, dot, vt, q0, k0, lse, delta,
                                   causal, scale, mm)
                acc_v = mm(p.transpose(-1, -2), dot, acc=acc_v)
                acc_k = mm(ds.transpose(-1, -2), qt, acc=acc_k)
            if acc_k is not None:
                tot_k = acc_k if tot_k is None else tot_k + acc_k
                tot_v = acc_v if tot_v is None else tot_v + acc_v
        dk[:, k0:k0 + TILE] = scale * tot_k
        dv[:, k0:k0 + TILE] = tot_v
    return dk, dv


def emulate_fwd(q, k, v, causal, scale, mm_s=mm3, mm_pv=mm3, split=None):
    """O and LSE as fwd_tiles_f32 computes them: for each q tile, the
    k tiles in splits of ``split`` tiles (all of them in the resident
    family).  Per tile pair, S is the sum of the slices' partials in rank
    order (``mm_s``), then the online-softmax step and acc = alpha acc +
    P V (``mm_pv``).  Each split's (m, l, acc) is merged in split order as
    the merge pass does: weights exp(m_j - M), O = acc / l, LSE = M + log l
    (one split: weight exp(0), the resident kernel's arithmetic)."""
    bh, s_len, d = q.shape
    split = split or s_len // TILE
    width = slice_width(d)
    n = d // width
    o = torch.zeros_like(q)
    lse = torch.zeros(bh, s_len)
    for q0 in range(0, s_len, TILE):
        # [n, BH, TILE, W]: slice j's columns in row j
        qs = q[:, q0:q0 + TILE].reshape(bh, TILE, n, width).permute(2, 0, 1,
                                                                   3)
        parts = []
        for sp0 in range(0, s_len, split * TILE):
            m = torch.full((bh, TILE), float("-inf"))
            l = torch.zeros(bh, TILE)
            acc = None
            for k0 in range(sp0, min(sp0 + split * TILE, s_len), TILE):
                if not _visible(q0, k0, causal):
                    continue
                kt, vt = k[:, k0:k0 + TILE], v[:, k0:k0 + TILE]
                ks = kt.reshape(bh, TILE, n, width).permute(2, 0, 3, 1)
                partial = mm_s(qs, ks, True)
                s = partial[0]
                for j in range(1, n):  # rank order
                    s = s + partial[j]
                x = scale * s
                if causal:
                    keys = torch.arange(k0, k0 + TILE)
                    x = x.masked_fill(
                        keys > torch.arange(q0, q0 + TILE)[:, None],
                        float("-inf"))
                m_new = torch.maximum(m, x.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(x - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = mm_pv(p, vt, acc=None if acc is None
                            else acc * alpha[..., None])
                m = m_new
            if acc is not None:
                parts.append((m, l, acc))
        mx = parts[0][0]
        for m, _, _ in parts[1:]:
            mx = torch.maximum(mx, m)
        tot_l, tot_acc = 0.0, 0.0
        for m, l, acc in parts:
            w = torch.exp(m - mx)
            tot_l = tot_l + w * l
            tot_acc = tot_acc + w[..., None] * acc
        o[:, q0:q0 + TILE] = tot_acc / tot_l[..., None]
        lse[:, q0:q0 + TILE] = mx + torch.log(tot_l)
    return o, lse


def _worst(got, want, tol):
    """The worst element's |got - want| over its limit (<= 1 passes)."""
    rtol, atol = tol
    g, w = got.double(), want.double()
    return float(((g - w).abs() / (w.abs() * rtol + atol)).max())


@functools.lru_cache(maxsize=None)
def _case(d, causal, s=256, bh=2):
    """float32 [bh, s, d] inputs from a seed, the plain forward's O and
    LSE, delta and the plain backward (dQ, dK, dV)."""
    rng = np.random.RandomState(d + causal)
    q, k, v, do = (torch.from_numpy(rng.randn(bh, s, d).astype(np.float32))
                   for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    dq, delta = fa.flash_bwd_dq_plain(q, k, v, o, lse, do, causal, scale)
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)
    return (q, k, v, do, o, lse, delta, scale), (dq, dk, dv)


def _gates(got, want):
    return {n: _worst(g, w, F32_GATE)
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 64, 128, 256, 384, 512])
def test_recipe_passes_the_f32_gates(d, causal, streaming):
    """3xTF32 in tile pairs (one CTA at D <= 128, split-D clusters above)
    holds dQ, dK and dV to the float32 gate against the plain versions,
    resident and in splits of two tiles, and delta (float64, rounded once,
    as the plain version sums it) to the rows gate."""
    (q, k, v, do, o, lse, delta, scale), plain = _case(d, causal)
    split = 2 if streaming else None
    got_delta = (do.double() * o.double()).sum(-1).float()
    got = (emulate_dq(q, k, v, do, lse, got_delta, causal, scale,
                      split=split),
           *emulate_dkv(q, k, v, do, lse, got_delta, causal, scale,
                        split=split))
    worst = _gates(got, plain)
    worst["delta"] = _worst(got_delta, delta, ROWS_GATE)
    assert all(w <= 1.0 for w in worst.values()), worst


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_recipe_holds_the_card_tests_tolerance(d, causal, streaming):
    """At the card tests' shape [4, 256, D] (test_kernels_match_plain and
    test_streaming_kernels_match_plain, which hold float32 dQ, dK and dV to
    1e-5 of the plain version's largest element) the recipe stays within
    that tolerance, resident and in splits of two tiles: the evidence that
    the kernels can keep it."""
    (q, k, v, do, _, lse, delta, scale), plain = _case(d, causal, bh=4)
    split = 2 if streaming else None
    got = (emulate_dq(q, k, v, do, lse, delta, causal, scale, split=split),
           *emulate_dkv(q, k, v, do, lse, delta, causal, scale,
                        split=split))
    worst = {n: float((g - w).abs().max() / (1e-5 * w.abs().max()))
             for n, g, w in zip(("dq", "dk", "dv"), got, plain)}
    assert all(w <= 1.0 for w in worst.values()), worst


@pytest.mark.parametrize("causal", [False, True])
def test_single_tf32_rounding_misses_the_f32_gate(causal):
    """Recorded so nobody "simplifies" the kernels: each operand rounded to
    TF32 once (11 significant bits) misses the float32 gate at D = 512,
    in dQ, dK and dV alike."""
    (q, k, v, do, _, lse, delta, scale), plain = _case(512, causal)
    got = (emulate_dq(q, k, v, do, lse, delta, causal, scale, mm=mm1),
           *emulate_dkv(q, k, v, do, lse, delta, causal, scale, mm=mm1))
    worst = _gates(got, plain)
    assert all(w > 1.0 for w in worst.values()), worst


def test_one_accumulator_a_chunk_reads_higher():
    """The tensor cores truncate their float32 sums: summing a 128-column
    chunk's 48 MMAs (and a tile pair's 24 second-product MMAs) in one
    accumulator, as the first version of these kernels did, reads more
    than twice the gate of the 16-element partials at D = 512 causal
    (measured 0.50 against 0.10, the worst of dQ, dK and dV)."""
    (q, k, v, do, _, lse, delta, scale), plain = _case(512, True)
    worst = {}
    for name, mm in (("partials", mm3), ("chunk", mm3_chunk)):
        got = (emulate_dq(q, k, v, do, lse, delta, True, scale, mm=mm),
               *emulate_dkv(q, k, v, do, lse, delta, True, scale, mm=mm))
        worst[name] = max(_gates(got, plain).values())
    assert worst["chunk"] > 2 * worst["partials"], worst


def test_partials_in_another_order_give_other_probabilities():
    """Each of a tile pair's n CTAs applies P and dS to its own columns, so
    all must hold the same bits.  Summed in rank order once by the row's
    owner they do; had each CTA summed the partials itself starting from
    its own (rotated order), P and dS would differ between slices."""
    (q, k, v, do, _, lse, delta, scale), _ = _case(512, False)
    qt, kt, dot, vt = (t[:, :TILE] for t in (q, k, do, v))
    n = q.shape[-1] // slice_width(q.shape[-1])
    rotated = [_tile_pair(qt, kt, dot, vt, 0, 0, lse, delta, False, scale,
                          mm3, order=[(j + r) % n for j in range(n)])
               for r in range(n)]
    assert not all(torch.equal(rotated[0][0], p) for p, _ in rotated[1:])
    assert not all(torch.equal(rotated[0][1], ds) for _, ds in rotated[1:])


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 256, 384, 512])
def test_recipe_matches_jax_backward(d, causal, streaming):
    """At [2, 256, D] float32 the recipe, fed the JAX forward's O and LSE,
    agrees with jax.vjp of the JAX package's flash attention (Pallas
    interpreter, the resident or the streaming kernels) within the float32
    gate."""
    rng = np.random.RandomState(13 + causal)
    q, k, v, do = (rng.randn(2, 256, d).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    _, vjp = jax.vjp(lambda a, b, c: jax_flash(a, b, c, causal, None, 64,
                                               64, True, streaming),
                     jq, jk, jv)
    want = [torch.from_numpy(np.array(g)) for g in vjp(jdo)]
    o, (_, _, _, _, lse) = jax_flash_fwd(jq, jk, jv, causal, None, 64, 64,
                                         True, streaming)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    to = torch.from_numpy(np.array(o))
    tlse = torch.from_numpy(np.array(lse))[:, 0, :]
    delta = (tdo.double() * to.double()).sum(-1).float()
    scale = d ** -0.5
    split = 2 if streaming else None
    got = (emulate_dq(tq, tk, tv, tdo, tlse, delta, causal, scale,
                      split=split),
           *emulate_dkv(tq, tk, tv, tdo, tlse, delta, causal, scale,
                        split=split))
    worst = _gates(got, want)
    assert all(w <= 1.0 for w in worst.values()), worst


def _fwd_gates(got, want):
    return {"o": _worst(got[0], want[0], O_GATE),
            "lse": _worst(got[1], want[1], ROWS_GATE)}


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256, 384, 512])
def test_fwd_recipe_passes_the_f32_gates(d, causal, streaming):
    """The forward's recipe (one CTA holding all of D up to D = 128,
    split-D partials in rank order from 256, 3xTF32 S and P V, the online
    rescale) holds O to 1e-4 |plain| + 2e-5 and LSE to 1e-5 |plain| + 1e-6
    against the plain version, resident and in splits of two tiles (merged
    as the merge pass does)."""
    (q, k, v, _, o, lse, _, scale), _ = _case(d, causal)
    got = emulate_fwd(q, k, v, causal, scale, split=2 if streaming else None)
    worst = _fwd_gates(got, (o, lse))
    assert all(w <= 1.0 for w in worst.values()), worst


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_fwd_recipe_holds_the_card_tests_tolerance(d, causal, streaming):
    """At the card tests' shape [4, 256, D] (test_kernels_match_plain and
    test_streaming_kernels_match_plain hold float32 O to 1e-5 and LSE to
    1e-6 of the plain version's largest element) the forward's recipe
    stays within both, resident and in splits of two tiles."""
    (q, k, v, _, o, lse, _, scale), _ = _case(d, causal, bh=4)
    got = emulate_fwd(q, k, v, causal, scale, split=2 if streaming else None)
    worst = {n: float((g - w).abs().max() / (t * w.abs().max()))
             for n, g, w, t in (("o", got[0], o, 1e-5),
                                ("lse", got[1], lse, 1e-6))}
    assert all(w <= 1.0 for w in worst.values()), worst


@pytest.mark.parametrize("product", ["S", "PV"])
@pytest.mark.parametrize("causal", [False, True])
def test_fwd_single_tf32_rounding_misses_the_f32_gate(causal, product):
    """One TF32 rounding of each operand of S = Q K^T, or of P V (P in
    [0, 1] included), misses the forward's gate on O at D = 512: each of
    the forward's two products needs the hi/lo split (the factors are
    printed by running this file)."""
    (q, k, v, _, o, lse, _, scale), _ = _case(512, causal)
    mms = {"mm_s": mm1} if product == "S" else {"mm_pv": mm1}
    got = emulate_fwd(q, k, v, causal, scale, **mms)
    worst = _fwd_gates(got, (o, lse))
    assert worst["o"] > 1.0, worst


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 256, 384, 512])
def test_fwd_recipe_matches_jax_forward(d, causal, streaming):
    """At [2, 256, D] float32 the forward's recipe agrees with the JAX
    package's flash forward (Pallas interpreter, the resident or the
    streaming kernel) within the float32 gates on O and LSE."""
    rng = np.random.RandomState(17 + causal)
    q, k, v = (rng.randn(2, 256, d).astype(np.float32) for _ in range(3))
    o, (_, _, _, _, lse) = jax_flash_fwd(
        *(jnp.asarray(x) for x in (q, k, v)), causal, None, 64, 64, True,
        streaming)
    want = (torch.from_numpy(np.array(o)),
            torch.from_numpy(np.array(lse))[:, 0, :])
    got = emulate_fwd(*(torch.from_numpy(x) for x in (q, k, v)), causal,
                      d ** -0.5, split=2 if streaming else None)
    worst = _fwd_gates(got, want)
    assert all(w <= 1.0 for w in worst.values()), worst


if __name__ == "__main__":
    # The gate readings, for PERF.md: the backward at D <= 256 against the
    # float32 gate and, at [4, 256, D], the card tests' 1e-5 of the largest
    # element; at D = 384 and 512 3xTF32, one TF32 rounding, and 3xTF32
    # with one truncating accumulator a chunk; the forward's in 3xTF32 at
    # every D and, at 384 and 512, with one TF32 rounding of S or of P V.
    for d in (16, 32, 64, 128, 256):
        for causal in (False, True):
            for split in (None, 2):
                (q, k, v, do, _, lse, delta, scale), plain = _case(d, causal)
                got = (emulate_dq(q, k, v, do, lse, delta, causal, scale,
                                  split=split),
                       *emulate_dkv(q, k, v, do, lse, delta, causal, scale,
                                    split=split))
                gate = _gates(got, plain)
                (q, k, v, do, _, lse, delta, scale), plain = _case(
                    d, causal, bh=4)
                got = (emulate_dq(q, k, v, do, lse, delta, causal, scale,
                                  split=split),
                       *emulate_dkv(q, k, v, do, lse, delta, causal, scale,
                                    split=split))
                card = {n: float((g - w).abs().max() / (1e-5 * w.abs().max()))
                        for n, g, w in zip(("dq", "dk", "dv"), got, plain)}
                print(f"D {d} causal {causal} split {split}: gate",
                      {n: round(x, 4) for n, x in gate.items()},
                      "card tolerance",
                      {n: round(x, 4) for n, x in card.items()})
    for d in (16, 32, 64, 128, 256):
        for causal in (False, True):
            for split in (None, 2):
                (q, k, v, _, o, lse, _, scale), _ = _case(d, causal)
                got = emulate_fwd(q, k, v, causal, scale, split=split)
                print(f"D {d} causal {causal} split {split} forward:",
                      {n: round(w, 4)
                       for n, w in _fwd_gates(got, (o, lse)).items()})
    for d in (384, 512):
        for causal in (False, True):
            (q, k, v, do, _, lse, delta, scale), plain = _case(d, causal)
            for name, mm in (("3xTF32", mm3), ("1xTF32", mm1),
                             ("3xTF32, a chunk an accumulator", mm3_chunk)):
                got = (emulate_dq(q, k, v, do, lse, delta, causal, scale,
                                  mm=mm),
                       *emulate_dkv(q, k, v, do, lse, delta, causal, scale,
                                    mm=mm))
                print(f"D {d} causal {causal} {name}:",
                      {n: round(w, 4) for n, w in _gates(got, plain).items()})
            (q, k, v, _, o, lse, _, scale), _ = _case(d, causal)
            for name, mms in (("3xTF32", {}), ("S in 1xTF32", {"mm_s": mm1}),
                              ("P V in 1xTF32", {"mm_pv": mm1})):
                got = emulate_fwd(q, k, v, causal, scale, **mms)
                print(f"D {d} causal {causal} forward, {name}:",
                      {n: round(w, 4)
                       for n, w in _fwd_gates(got, (o, lse)).items()})
