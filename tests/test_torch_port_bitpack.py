"""byteps_tpu_torch's sign and level packing vs the JAX package's.

The port's plain pack/unpack (what its wrappers run for CPU tensors, and
what ``chip_smoke.py`` holds the CUDA kernels against) must give the JAX
package's words bit for bit: against the Pallas kernels in interpret mode
and against the jnp path, at ``tests/test_bitpack.py``'s sizes, on inputs
with +-0.0, +-inf and NaNs of both signs.  Words compare as numpy uint32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops.compressor import bitpack as jbp
from byteps_tpu_torch.ops.compressor import bitpack as bp
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

SIZES = [4096, 4096 * 8, 4096 * 33, 5000, 100, 131072 + 17, 1]


def _specials(n, seed):
    """Normal floats with +-0.0, +-inf and NaNs of both signs mixed in."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n).astype(np.float32)
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan],
                        np.float32)
    at = rng.randint(0, n, size=min(n, 64))
    x[at] = specials[np.arange(at.size) % specials.size]
    return x


def _u32(words: torch.Tensor) -> np.ndarray:
    assert words.dtype == torch.int32
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("n", SIZES)
def test_pack_unpack_match_jax_interpret_and_jnp(n):
    x = _specials(n, n)
    got = bp.pack_signs(torch.from_numpy(x))
    assert got.shape == (bp.words_len(n),) == (jbp.words_len(n),)
    want = np.asarray(jbp.pack_signs(jnp.asarray(x), impl="interpret"))
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(
        want, np.asarray(jbp.pack_signs(jnp.asarray(x), impl="jnp")))

    signs = bp.unpack_signs(got, n)
    assert signs.dtype == torch.float32 and signs.shape == (n,)
    jw = jnp.asarray(want)
    for impl in ("interpret", "jnp"):
        np.testing.assert_array_equal(
            signs.numpy(), np.asarray(jbp.unpack_signs(jw, n, impl=impl)))
    # x < 0 and nothing else: -0.0 and NaN of either sign are +1.
    np.testing.assert_array_equal(signs.numpy(),
                                  np.where(x < 0, -1.0, 1.0))


def test_pack_reads_any_float_shape_and_dtype():
    x = torch.from_numpy(_specials(3 * 4096 + 5, 7)).reshape(-1, 1)
    want = bp.pack_signs_plain(x.reshape(-1))
    assert torch.equal(bp.pack_signs(x), want)
    xb = x.to(torch.bfloat16)
    np.testing.assert_array_equal(
        _u32(bp.pack_signs(xb)),
        np.asarray(jbp.pack_signs(jnp.asarray(xb.float().numpy()),
                                  impl="jnp")))


def test_unpack_rows_is_one_row_at_a_time():
    """Gathered payloads [W, words_len(n)] unpack row by row."""
    n = 4096 * 2 + 3
    rows = [bp.pack_signs(torch.from_numpy(_specials(n, s)))
            for s in range(3)]
    batched = bp.unpack_signs(torch.stack(rows), n)
    assert batched.shape == (3, n)
    for r, w in enumerate(rows):
        assert torch.equal(batched[r], bp.unpack_signs(w, n))
    with pytest.raises(ValueError, match="words"):
        bp.unpack_signs(rows[0][:-128], n)


def test_words_len_contract_matches_jax():
    for n in [1, 4095, 4096, 4097, 4096 * 8, 4096 * 9, 4096 * 32,
              4096 * 33, 845824, 1048576, 0]:
        assert bp.words_len(n) == jbp.words_len(n), n
    # The flagship's ragged bucket: 206.5 tiles -> 207 -> 208 (round to 8).
    assert bp.words_len(845824) == 208 * 128
    assert bp.words_len(4096 * 33) == 128 * 40


def test_empty_input():
    assert bp.pack_signs(torch.zeros(0)).shape == (0,)
    assert bp.pack_signs(torch.zeros(0)).dtype == torch.int32
    out = bp.unpack_signs(torch.zeros(0, dtype=torch.int32), 0)
    assert out.shape == (0,) and out.dtype == torch.float32


@pytest.mark.parametrize("s,n", [(1, 4096), (7, 5000), (15, 4096 * 2 + 17),
                                 (127, 1000), (31, 1)])
def test_levels_match_jax(s, n):
    rng = np.random.RandomState(s)
    lv = rng.randint(0, s + 1, size=n).astype(np.uint8)
    got = bp.pack_levels(torch.from_numpy(lv), s)
    want = np.asarray(jbp.pack_levels(jnp.asarray(lv), s))
    assert bp.level_words_len(n, s) == jbp.level_words_len(n, s)
    np.testing.assert_array_equal(_u32(got), want)
    back = bp.unpack_levels(got, n, s)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jbp.unpack_levels(jnp.asarray(want), n, s)))
    np.testing.assert_array_equal(back.numpy(), lv)
    assert bp.pack_levels(torch.zeros(0, dtype=torch.uint8), s).shape == (0,)
