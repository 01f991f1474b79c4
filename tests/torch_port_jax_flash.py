"""The JAX package's flash attention as the port's CPU tests hold it: the
Pallas kernels in interpret mode, each reference in one ``jax.jit``.

Dispatched op by op, the interpreted kernels of one forward and vjp took
about twice as long as under one jit (same values), and every call
compiled again.  Jitted here at module level, the compiled references are
shared by every test case, in any test file of the process, that asks for
the same shapes and flags.  ``streaming`` is True or False: the automatic
choice (None) reads a budget that tests monkeypatch, which a compiled
reference would not see again.
"""

import functools

import jax

from byteps_tpu.ops import flash_attention as jfa


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6))
def forward(q, k, v, causal, block_q, block_k, streaming):
    """(O, LSE [BH, S]) of the JAX forward kernels."""
    assert streaming in (False, True), streaming
    o, (*_, lse) = jfa._flash_fwd(q, k, v, causal, None, block_q, block_k,
                                  True, streaming)
    return o, lse[:, 0, :]


@functools.partial(jax.jit, static_argnums=(4, 5, 6, 7))
def vjp(q, k, v, do, causal, block_q, block_k, streaming):
    """(O, (dQ, dK, dV), LSE [BH, S]): the vjp of the JAX package's flash
    attention with ``do``, taken through its custom_vjp rules as jax.vjp
    takes it (``_flash_fwd``, then ``_flash_bwd`` on its residuals: the
    same bits, one forward where jax.vjp and a second call for the LSE
    took two)."""
    assert streaming in (False, True), streaming
    out, res = jfa._flash_fwd(q, k, v, causal, None, block_q, block_k, True,
                              streaming)
    grads = jfa._flash_bwd(causal, None, block_q, block_k, True, streaming,
                           res, do)
    return out, grads, res[-1][:, 0, :]
