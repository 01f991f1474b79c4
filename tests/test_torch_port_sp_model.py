"""The port's transformer under sequence parallelism vs the JAX package's.

The JAX adaptors (``make_ring_attn_fn(mesh)``, ``make_ulysses_attn_fn``)
take the whole sequence under the outer jit, so ``transformer.forward``
numbers positions globally.  The port's adaptors run on this rank's block
of the sequence and carry the block's index, from which the model numbers
the block's positions.  One 2-rank gloo world
(``tests/torch_port_parallel_worker.py sp``), spawned once for the module,
runs ``forward`` on each rank's half of a [2, 32] batch through ring and
Ulysses, on ``llama_tiny`` (GQA, rope) and ``tiny`` (learned positions),
from JAX's parameters; the joined blocks are held to JAX's forward with
the adaptor on a 2-device mesh at the reference's own tolerance
(``tests/test_ring_attention.py::test_ulysses_with_llama_gqa_block``:
atol 2e-4, rtol 1e-4).  The gradients of the mean loss through the ring,
each rank's averaged over the ranks, are held to ``jax.grad`` of JAX's
loss with the ring adaptor at atol 1e-4.  The same world then runs
``train_long_context --attn ring --sp 2``, whose lines are held to the
JAX example's format.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from byteps_tpu.models import transformer as jtfm
from byteps_tpu.ops import ring_attention as jra
from byteps_tpu_torch.models import transformer as tfm
from torch_port_parallel_worker import collect, spawn
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 2
NAMES = ("tiny", "llama_tiny")
ADAPTORS = {"ring": jra.make_ring_attn_fn, "ulysses": jra.make_ulysses_attn_fn}


def _cfg(name):
    return jtfm.get_config(name, dtype=jnp.float32, remat=False)


def _params(cfg, rng):
    """JAX's parameter tree (init_params' keys and shapes) filled from a
    numpy generator: normal / sqrt(fan_in) weights, 0.02-scaled learned
    positions, norm scales near 1, small biases."""
    def fill(path, leaf):
        name = path[-1].key
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if name.endswith("_scale"):
            return 1 + np.float32(0.1) * x
        if name == "pos_embed":
            return np.float32(0.02) * x
        if leaf.ndim == 1 or name.endswith(("_b", "_bias")):
            return np.float32(0.1) * x
        return x / np.float32(np.sqrt(leaf.shape[-1] if name == "embed"
                                      else leaf.shape[-2]))
    shapes = jax.eval_shape(lambda: jtfm.init_params(jax.random.key(0),
                                                     cfg))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    params = {n: _params(_cfg(n), rng) for n in NAMES}
    toks = rng.randint(0, 1024, size=(2, 32)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    inputs = {"toks": toks, "tgts": tgts}
    for name, tree in params.items():
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            inputs[f"{name}/" + "/".join(p.key for p in path)] = leaf
    d = tmp_path_factory.mktemp("sp_world")
    procs = spawn("sp", inputs, d, world=WORLD)
    # The JAX runs, while the world runs.
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("sp",))
    refs = {}
    for name in NAMES:
        cfg = _cfg(name)
        p = jax.tree.map(jnp.asarray, params[name])
        for key, make in ADAPTORS.items():
            fn = make(mesh)
            refs[f"fwd/{name}/{key}"] = np.asarray(jax.jit(
                lambda p, t, cfg=cfg, fn=fn: jtfm.forward(p, t, cfg,
                                                          attn_fn=fn))(
                p, toks))
        ring = jra.make_ring_attn_fn(mesh)
        grads = jax.jit(jax.grad(
            lambda p, cfg=cfg, fn=ring: jtfm.loss_fn(
                p, (toks, tgts), cfg, attn_fn=fn)))(p)
        for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]:
            refs[f"grad/{name}/{jax.tree_util.keystr(path)}"] = \
                np.asarray(g)
    return refs, collect(procs, d)


def test_adaptors_carry_the_rank_block(world):
    _, ranks = world
    assert [r["sp_index"].tolist() for r in ranks] == [[0, 0], [1, 1]]


@pytest.mark.parametrize("adaptor", sorted(ADAPTORS))
@pytest.mark.parametrize("name", NAMES)
def test_forward_on_rank_blocks_matches_jax(world, name, adaptor):
    """Each rank's logits are its block of JAX's forward over the whole
    sequence (numbered from 0 on every rank, rank 1's block misses here
    by 4.5 with rope and 1.4 with learned positions)."""
    refs, ranks = world
    key = f"fwd/{name}/{adaptor}"
    got = np.concatenate([r[key] for r in ranks], axis=1)
    np.testing.assert_allclose(got, refs[key], atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_ring_gradients_match_jax(world, name):
    """The gradients of the mean loss: each rank's of its block's mean,
    averaged over the ranks (equal blocks), against jax.grad of JAX's
    loss with the ring adaptor; equal on both ranks."""
    refs, ranks = world
    keys = [k for k in refs if k.startswith(f"grad/{name}/")]
    assert keys and all(k in ranks[0] for k in keys)
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k])
        np.testing.assert_allclose(ranks[0][k], refs[k], atol=1e-4,
                                   err_msg=k)


def test_train_long_context_ring_on_two_ranks(world):
    """``train_long_context --attn ring --sp 2``: the JAX example's line,
    ``print(f"step {i}: loss={float(loss):.4f} (seq_len={args.seq_len})")``
    (example/jax/train_long_context.py:72), on both ranks, the same global
    losses, finite and falling."""
    _, ranks = world
    lines = [json.loads(str(r["example/lines"])) for r in ranks]
    for rank_lines in lines:
        assert len(rank_lines) == 3
        for i, line in enumerate(rank_lines):
            assert re.fullmatch(rf"step {i}: loss=\d+\.\d{{4}} "
                                r"\(seq_len=64\)", line), line
    losses = [r["example/losses"] for r in ranks]
    np.testing.assert_array_equal(losses[0], losses[1])
    assert np.isfinite(losses[0]).all() and losses[0][-1] < losses[0][0]


class _Block:
    """A stand-in adaptor: dense attention on block ``sp_index``."""

    def __init__(self, sp_index):
        self.sp_index = sp_index

    def __call__(self, q, k, v, causal):
        return tfm.dense_attention(q, k, v, causal)


def test_learned_positions_past_max_seq_len_raise():
    """A block whose positions run past ``max_seq_len`` raises, where the
    JAX forward fails to broadcast the sliced table; the last block that
    fits runs."""
    cfg = tfm.get_config("tiny", dtype=torch.float32, remat=False)
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device="cpu")
    toks = torch.zeros(1, 32, dtype=torch.long)
    with torch.no_grad():
        assert tfm.forward(params, toks, cfg, attn_fn=_Block(3)).shape == (
            1, 32, cfg.vocab_size)
    with pytest.raises(ValueError, match="run past max_seq_len=128"):
        tfm.forward(params, toks, cfg, attn_fn=_Block(4))
