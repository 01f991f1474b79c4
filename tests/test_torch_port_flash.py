"""byteps_tpu_torch flash attention vs the JAX package's Pallas kernels.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
kernels run in the Pallas interpreter, as tests/test_flash_attention.py
runs them; on CPU tensors the port runs its kernels' plain versions.  The
tolerances are the JAX tests' own: forward f32 atol 2e-5 / rtol 1e-4,
gradients scaled by their max at atol 1e-4, bf16 inputs atol 2e-2.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models.transformer import flash_attention_fn as jax_adapter
from byteps_tpu.ops.flash_attention import _flash_fwd as jax_flash_fwd
from byteps_tpu.ops.flash_attention import flash_attention as jax_flash
from byteps_tpu_torch.models.transformer import (dense_attention,
                                                 flash_attention_fn)
from byteps_tpu_torch.ops import flash_attention as fa
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)


def _inputs(seed, n, *shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("bh,s,d,bq,bk", [
    (2, 128, 32, 64, 64),
    (2, 128, 32, 64, 128),     # uneven q/k blocks
    (1, 256, 64, 128, 64),
])
def test_forward_parity(causal, bh, s, d, bq, bk):
    q, k, v = _inputs(0, 3, bh, s, d)
    want = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal,
                     None, bq, bk, True)
    got = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal, None, bq, bk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_parity(causal):
    """The saved log-sum-exp, compared by value: JAX keeps it [BH, 1, S]
    for TPU tiling, the port [BH, S]."""
    q, k, v = _inputs(1, 3, 2, 128, 32)
    _, (_, _, _, _, lse) = jax_flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, 64, 64,
        True, None)
    _, got = fa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal, 1.0 / math.sqrt(32))
    assert got.shape == (2, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(lse)[:, 0, :],
                               atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("streaming", [False, True])
def test_gradient_parity(causal, streaming):
    """dQ/dK/dV through torch.autograd vs jax.grad, on the JAX package's
    resident and streaming kernels, with block_q != block_k."""
    q, k, v, tgt = _inputs(2, 4, 2, 128, 32)

    def jloss(q, k, v):
        out = jax_flash(q, k, v, causal, None, 64, 128, True, streaming)
        return jnp.sum((out - jnp.asarray(tgt)) ** 2)

    want = jax.grad(jloss, (0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal, None, 64, 128,
                             streaming=streaming)
    ((out - torch.from_numpy(tgt)) ** 2).sum().backward()
    for got, ref in zip((tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        scale = float(np.abs(ref).max()) + 1e-9
        np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                   atol=1e-4)


def test_bf16_inputs():
    q, k, v = _inputs(3, 3, 2, 128, 32)
    want = jax_flash(*(jnp.asarray(x).astype(jnp.bfloat16)
                       for x in (q, k, v)), True, None, 64, 64, True)
    got = fa.flash_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                               for x in (q, k, v)), True, None, 64, 64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


def test_rejects_misaligned_seq():
    q = torch.zeros(1, 200, 64)
    with pytest.raises(ValueError, match="must divide"):
        fa.flash_attention(q, q, q, False, None, 128, 128)


def test_adapter_dense_fallback():
    """S=100 fits no 64-row block: the adapter falls back to dense, as the
    JAX adapter does, and matches it."""
    (x,) = _inputs(4, 1, 2, 2, 100, 32)
    t = torch.from_numpy(x)
    got = flash_attention_fn(t, t, t, causal=True)
    np.testing.assert_allclose(got.numpy(),
                               dense_attention(t, t, t, True).numpy(),
                               atol=1e-6)
    want = jax_adapter(jnp.asarray(x), jnp.asarray(x), jnp.asarray(x),
                       causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_adapter_strict_raises():
    t = torch.zeros(1, 2, 100, 32)
    with pytest.raises(ValueError, match="divisible by 64"):
        flash_attention_fn(t, t, t, causal=True, strict=True)
    t = torch.zeros(1, 2, 128, 12)     # head_dim not a multiple of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        flash_attention_fn(t, t, t, causal=True, strict=True)


def test_adapter_flash_parity_and_block_override():
    """The [B, H, S, Dh] adapter on the flash path matches the JAX adapter;
    a block override that is not a multiple of 64 reverts to the auto
    block, never to dense."""
    q, k, v = _inputs(5, 3, 2, 2, 128, 32)
    want = jax_adapter(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    for block, block_k in ((0, 0), (64, 128), (96, 32)):
        got = flash_attention_fn(tq, tk, tv, causal=True, block=block,
                                 block_k=block_k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                                   rtol=1e-4)


def test_cpu_path_counts_no_launch():
    """On CPU tensors the wrappers run the plain versions, and only a
    kernel launch counts."""
    fa.reset_launches()
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _inputs(6, 3, 1, 64, 16))
    fa.flash_attention(q, k, v, True, None, 64, 64).sum().backward()
    fa.flash_attention(q, k, v, True, None, 64, 64,
                       streaming=True).sum().backward()
    assert fa.launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                           "flash_bwd_dkv": 0, "flash_fwd_str": 0,
                           "flash_bwd_dq_str": 0, "flash_bwd_dkv_str": 0}
