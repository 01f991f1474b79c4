"""byteps_tpu_torch flash attention at the shapes its kernels are not built
for: head dims padded up to an instantiated one, float16, and the launch
plan for more B*H than one launch takes, against the JAX package's Pallas
kernels.

Inputs are made with numpy from a seed and fed to both packages; the JAX
kernels run in the Pallas interpreter, as tests/test_flash_attention.py runs
them, and on CPU tensors the port runs its kernels' plain versions through
the same padding code the kernels take on the card.  Float32 tolerances
are the JAX tests' own: forward atol 2e-5 / rtol 1e-4, gradients
1e-4 of their max.  Float16: both sides compute in float32 and round once
to float16, so they may differ by one float16 step, at most 2^-10 of the
value (9.8e-4 at |x| ~ 1) and 2^-24 (the subnormal step) near 0: rtol
2^-10 and atol 2^-24 for O, atol 2^-10 of the max for the gradients.
"""

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

FP16_STEP = 2.0 ** -10


def _inputs(seed, n, *shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


def _jax_vjp(q, k, v, do, causal, streaming, dtype=jnp.float32):
    """JAX flash forward and its vjp with ``do``, on numpy inputs."""
    out, grads, _ = jax_ref.vjp(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v, do)), causal, 64,
        64, streaming)
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def _port_vjp(q, k, v, do, causal, streaming, dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(x).to(dtype).requires_grad_()
                  for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal, None, 64, 64,
                             streaming=streaming)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(do).to(dtype))
    assert out.dtype == dtype and out.shape == tq.shape
    return [x.detach().float().numpy() for x in (out, *grads)]


def _spy_head_dims(monkeypatch):
    """The head dim of every forward wrapper call."""
    seen = []
    for name in ("flash_fwd", "flash_fwd_str"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda q, *a, _r=real:
                            seen.append(q.shape[-1]) or _r(q, *a))
    return seen


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 24, 40, 48, 96])
def test_padded_head_dims_match_jax(monkeypatch, d, causal, streaming):
    """D zero-padded to the next instantiated head dim (16, 32, 64, 64,
    128), the scale taken from the caller's D and the output and gradients
    sliced back: forward and dQ/dK/dV against JAX's kernels at D itself."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 64)
    q, k, v, do = _inputs(d, 4, 2, 128, d)
    want = _jax_vjp(q, k, v, do, causal, streaming)
    seen = _spy_head_dims(monkeypatch)
    got = _port_vjp(q, k, v, do, causal, streaming)
    assert seen == [fa.kernel_head_dim(d)] and seen[0] > d
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-4)


def test_padding_helper_adds_only_zero_columns():
    """The helper hands the entry point it is given q, k, v with zero
    columns appended, and slices its output back; the gradients of the
    padded columns never reach the caller."""
    (x,) = _inputs(0, 1, 1, 64, 40)
    t = torch.from_numpy(x).requires_grad_()
    seen = []

    def attn(q, k, v):
        seen.append(q.detach().clone())
        return q * 2 + k + v

    out = fa._pad_head_dim(attn, t, t, t)
    assert out.shape == t.shape and seen[0].shape == (1, 64, 64)
    assert torch.equal(seen[0][..., 40:], torch.zeros(1, 64, 24))
    (grad,) = torch.autograd.grad(out.sum(), t)
    assert torch.equal(out, 4 * t) and torch.equal(grad, torch.full_like(t, 4))


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_float16_matches_jax_float16(monkeypatch, causal, streaming):
    """float16 in and out, against the JAX kernels in float16: within one
    float16 step (see the module docstring)."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 64)
    q, k, v, do = _inputs(7, 4, 2, 128, 32)
    want = _jax_vjp(q, k, v, do, causal, streaming, jnp.float16)
    got = _port_vjp(q, k, v, do, causal, streaming, torch.float16)
    np.testing.assert_allclose(got[0], want[0], rtol=FP16_STEP,
                               atol=2.0 ** -24)
    for g, w in zip(got[1:], want[1:]):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g / scale, w / scale, atol=FP16_STEP)


def test_batch_heads_are_cut_into_launches_of_at_most_the_limit(
        monkeypatch):
    """The wrappers' launch plan: contiguous B*H slices in order, each at
    most MAX_LAUNCH_BH rows, covering every row once (one slice while B*H
    fits; the card test runs the kernels over such slices bit for bit
    against one launch)."""
    assert fa._bh_slices(65535) == [slice(0, 65535)]
    assert fa._bh_slices(65600) == [slice(0, 65535), slice(65535, 65600)]
    monkeypatch.setattr(fa, "MAX_LAUNCH_BH", 2)
    assert fa._bh_slices(5) == [slice(0, 2), slice(2, 4), slice(4, 5)]
    assert fa._bh_slices(1) == [slice(0, 1)]


def test_family_choice_is_made_on_the_callers_head_dim(monkeypatch):
    """float32, S = 16,384, D = 40: K+V are 5.24 MB, within the 6 MiB
    budget, so JAX runs the resident kernels; the port pads D to 64 (8.39
    MB, which alone would pick streaming) and still runs resident.  Meta
    tensors and a recording stand-in for the autograd op: no attention
    runs."""
    shape = (1, 16384, 40)
    assert not jfa._use_streaming(jax.ShapeDtypeStruct(shape, jnp.float32),
                                  None)
    assert fa._use_streaming(torch.empty(1, 16384, 64, device="meta"), None)
    seen = []

    def record(q, k, v, causal, scale, streaming):
        seen.append((q.shape[-1], scale, streaming))
        return q

    monkeypatch.setattr(fa._FlashAttention, "apply", record)
    q = torch.empty(shape, device="meta")
    assert fa.flash_attention(q, q, q, True, None, 64, 64).shape == shape
    assert seen == [(64, 40 ** -0.5, False)]


def test_head_dims_above_the_limit_are_refused():
    """The kernels' head-dim rule has no limit any more: D up to 256 runs
    at the next instantiated head dim, D above it at the next multiple of
    128 (the wide kernels' column slices), with nothing refused; the
    card tests run the kernels there.  The JAX package has no limit
    either."""
    assert [fa.kernel_head_dim(d) for d in (1, 16, 17, 136, 256)] == [
        16, 16, 32, 256, 256]
    assert [fa.kernel_head_dim(d) for d in (257, 264, 384, 512, 520,
                                            1024, 4104)] == [
        384, 384, 384, 512, 640, 1024, 4224]


@pytest.mark.parametrize("streaming", [False, True])
def test_head_dim_above_the_limit_runs_plain_on_cpu(streaming):
    """On CPU tensors the plain versions take D = 264 through the same
    padding as the kernels (to 384): forward and gradients against JAX's
    at D = 264 at the JAX tests' float32 tolerances."""
    q, k, v, do = _inputs(264, 4, 1, 64, 264)
    want = _jax_vjp(q, k, v, do, True, streaming)
    got = _port_vjp(q, k, v, do, True, streaming)
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-4)


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [264, 512])
def test_wide_head_dims_match_jax(monkeypatch, d, causal, streaming):
    """D = 264 and 512, above the instantiated head dims: the port pads to
    384 and 512 (the wide kernels' head dims) and matches JAX's kernels at
    D itself, forward and dQ/dK/dV, at the JAX tests' float32
    tolerances."""
    monkeypatch.setattr(fa, "_split_len", lambda s: 64)
    q, k, v, do = _inputs(d + 1, 4, 2, 128, d)
    want = _jax_vjp(q, k, v, do, causal, streaming)
    seen = _spy_head_dims(monkeypatch)
    got = _port_vjp(q, k, v, do, causal, streaming)
    assert seen == [fa.kernel_head_dim(d)] and seen[0] % 128 == 0
    np.testing.assert_allclose(got[0], want[0], atol=2e-5, rtol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        scale = float(np.abs(w).max())
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-4)


@pytest.mark.parametrize("s,d", [(128, 300), (100, 264), (100, 40)])
def test_adapter_falls_back_to_dense_before_the_limit(s, d):
    """A non-strict flash_attention_fn runs dense attention where the JAX
    adapter does (S % 64 or Dh % 8 not 0), whatever Dh: Dh = 300 or
    S = 100 at Dh = 264 is dense, not refused."""
    x, y, z = (torch.from_numpy(a) for a in _inputs(d, 3, 1, 2, s, d))
    got = tfm.flash_attention_fn(x, y, z, True)
    assert torch.equal(got, tfm.dense_attention(x, y, z, True))
    with pytest.raises(ValueError, match="divisible by 64"):
        tfm.flash_attention_fn(x, y, z, True, strict=True)


def test_transformer_with_head_dim_24_matches_jax():
    """The slice end to end: a 2-layer transformer with 4 heads of 24
    (d_model 96), flash attention, float32: loss to 1e-5 relative and every
    gradient leaf to 1e-4 of its max, against the JAX model on the same
    params and tokens."""
    kw = dict(d_model=96, num_heads=4, attn_impl="flash")
    jcfg = jtfm.get_config("tiny", dtype=jnp.float32, **kw)
    tcfg = tfm.get_config("tiny", dtype=torch.float32, **kw)
    assert tcfg.head_dim == 24
    params = jax.tree.map(np.asarray,
                          jtfm.init_params(jax.random.key(0), jcfg))
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 129))
    batch = toks[:, :-1], toks[:, 1:]
    jb = tuple(jnp.asarray(x, jnp.int32) for x in batch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtfm.loss_fn(p, jb, jcfg)))(params)
    tp = tfm.params_from_numpy(params, tcfg, device="cpu")
    tl = tfm.loss_fn(tp, tuple(torch.from_numpy(x).long() for x in batch),
                     tcfg)
    tg = torch.autograd.grad(tl, tree_leaves(tp))
    tl, jl = float(tl.detach()), float(jl)
    assert abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)
    for a, b in zip(tg, jax.tree.leaves(jg)):
        b = np.asarray(b, np.float32)
        scale = float(np.abs(b).max()) + 1e-12
        np.testing.assert_allclose(a.numpy() / scale, b / scale, atol=1e-4)
