"""byteps_tpu_torch's data-parallel trainer vs the JAX package's.

A 3-step AdamW trajectory on the tiny transformer (float32, flash) from the
same params and batch, against ``byteps_tpu.build_train_step`` on a
1-device mesh; the accum_steps contract; the MLP smoke model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh

import byteps_tpu as jbps
import byteps_tpu_torch as bps
from byteps_tpu.models import mlp as jmlp
from byteps_tpu.models import transformer as jtfm
from byteps_tpu_torch.common.tree import tree_leaves
from byteps_tpu_torch.models import mlp
from byteps_tpu_torch.models import transformer as tfm
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)


def _tiny(**kw):
    return (jtfm.get_config("tiny", dtype=jnp.float32, **kw),
            tfm.get_config("tiny", dtype=torch.float32, **kw))


def _batch(vocab, b, s, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, size=(b, s + 1))
    return toks[:, :-1], toks[:, 1:]


def _port_step(tcfg, params, opt, accum_steps=1):
    return bps.build_train_step(lambda p, b: tfm.loss_fn(p, b, tcfg), opt,
                                accum_steps=accum_steps, device="cpu")


def test_adamw_trajectory_matches_jax():
    jcfg, tcfg = _tiny(attn_impl="flash")
    params_np = jax.tree.map(np.asarray,
                             jtfm.init_params(jax.random.key(0), jcfg))
    toks, tgts = _batch(jcfg.vocab_size, 4, 64, seed=0)

    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jopt = jbps.DistributedOptimizer(optax.adamw(1e-3))
    jstep = jbps.build_train_step(lambda p, b: jtfm.loss_fn(p, b, jcfg),
                                  jopt, mesh, donate=True)
    jparams = jax.tree.map(jnp.array, params_np)        # donated copies
    jstate = jopt.init(jparams)
    jbatch = (jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32))
    jlosses = []
    for _ in range(3):
        jparams, jstate, loss = jstep(jparams, jstate, jbatch)
        jlosses.append(float(loss))

    params = tfm.params_from_numpy(params_np, tcfg, device="cpu")
    # optax.adamw's defaults, stated: torch's AdamW decays by 1e-2.
    opt = bps.DistributedOptimizer(torch.optim.AdamW(
        tree_leaves(params), lr=1e-3, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-4))
    step = _port_step(tcfg, params, opt)
    batch = (torch.from_numpy(toks).long(), torch.from_numpy(tgts).long())
    losses = [float(step(params, batch)) for _ in range(3)]

    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    # Each leaf within 1e-5 relative, in L2 norm: the zero-initialised
    # biases hold nothing but three Adam updates, and Adam's normalised
    # update m / (sqrt(v) + eps) magnifies float32 gradient noise in
    # elements whose gradient is tiny (single elements differ by up to
    # 9e-5 of their value, 8e-8 absolute, on this seed).  The K slice of
    # qkv_b is left out: softmax ignores a per-row shift of the logits, so
    # its gradient is exactly zero and both frameworks feed Adam pure
    # rounding noise, which it turns into +-lr steps of either sign.
    H, Dh = tcfg.num_heads, tcfg.head_dim
    k_cols = np.arange(H * Dh, (H + tcfg.kv_heads) * Dh)
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for (path, want), got in zip(paths, tree_leaves(params)):
        got, want = got.detach().numpy(), np.asarray(want)
        if jax.tree_util.keystr(path) == "['layers']['qkv_b']":
            for x in (got, want):          # three steps of at most lr
                assert float(np.abs(x[:, k_cols]).max()) <= 3.1e-3
            got, want = np.delete(got, k_cols, 1), np.delete(want, k_cols, 1)
        diff = np.linalg.norm(got - want)
        assert diff <= 1e-5 * np.linalg.norm(want), diff


def test_onebit_ef_trajectory_matches_jax():
    """Three AdamW steps of the tiny transformer (float32, flash) with
    onebit + error feedback through DistributedOptimizer(inter_compressor)
    against the JAX package's on a 1-device mesh, from the same params."""
    jcfg, tcfg = _tiny(attn_impl="flash")
    params_np = jax.tree.map(np.asarray,
                             jtfm.init_params(jax.random.key(0), jcfg))
    toks, tgts = _batch(jcfg.vocab_size, 4, 64, seed=2)
    kw = {"compressor": "onebit", "ef": "vanilla"}

    mesh = Mesh(np.array(jax.devices()[:1]), ("dp",))
    jopt = jbps.DistributedOptimizer(optax.adamw(1e-3),
                                     inter_compressor=jbps.compressor.create(
                                         kw))
    jstep = jbps.build_train_step(lambda p, b: jtfm.loss_fn(p, b, jcfg),
                                  jopt, mesh, donate=True)
    jparams = jax.tree.map(jnp.array, params_np)
    jstate = jopt.init(jparams)
    jbatch = (jnp.asarray(toks, jnp.int32), jnp.asarray(tgts, jnp.int32))
    jlosses = []
    for _ in range(3):
        jparams, jstate, loss = jstep(jparams, jstate, jbatch)
        jlosses.append(float(loss))

    params = tfm.params_from_numpy(params_np, tcfg, device="cpu")
    opt = bps.DistributedOptimizer(
        torch.optim.AdamW(tree_leaves(params), lr=1e-3, betas=(0.9, 0.999),
                          eps=1e-8, weight_decay=1e-4),
        inter_compressor=bps.compressor.create(kw))
    assert opt.compression_state["worker"][0]["error"].device.type == "cpu"
    step = _port_step(tcfg, params, opt)
    batch = (torch.from_numpy(toks).long(), torch.from_numpy(tgts).long())
    losses = [float(step(params, batch)) for _ in range(3)]

    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    # The K slice of qkv_b is left out: its gradient is exactly zero, and
    # onebit turns each framework's rounding noise there into +-scale.
    H, Dh = tcfg.num_heads, tcfg.head_dim
    k_cols = np.arange(H * Dh, (H + tcfg.kv_heads) * Dh)
    paths = jax.tree_util.tree_flatten_with_path(jparams)[0]
    for (path, want), got in zip(paths, tree_leaves(params)):
        got, want = got.detach().numpy(), np.asarray(want)
        if jax.tree_util.keystr(path) == "['layers']['qkv_b']":
            got, want = np.delete(got, k_cols, 1), np.delete(want, k_cols, 1)
        diff = np.linalg.norm(got - want)
        assert diff <= 1e-5 * np.linalg.norm(want), (path, diff)


def test_accum_steps_equals_full_batch():
    """accum_steps=2 over two half-batches gives the full batch's gradient
    (read through SGD with lr=1: the update is the gradient)."""
    _, tcfg = _tiny(attn_impl="dense")
    toks, tgts = _batch(tcfg.vocab_size, 4, 64, seed=1)
    batch = (torch.from_numpy(toks).long(), torch.from_numpy(tgts).long())
    results = []
    for accum in (1, 2):
        params = tfm.init_params(torch.Generator().manual_seed(0), tcfg,
                                 device="cpu")
        opt = bps.DistributedOptimizer(torch.optim.SGD(tree_leaves(params),
                                                       lr=1.0))
        loss = _port_step(tcfg, params, opt, accum)(params, batch)
        results.append((float(loss), [p.detach().clone()
                                      for p in tree_leaves(params)]))
    (l1, p1), (l2, p2) = results
    assert abs(l1 - l2) <= 1e-6 * abs(l1)
    for a, b in zip(p1, p2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_accum_steps_refuses_backward_passes_per_step():
    _, tcfg = _tiny()
    params = tfm.init_params(torch.Generator().manual_seed(0), tcfg,
                             device="cpu")
    opt = bps.DistributedOptimizer(torch.optim.SGD(tree_leaves(params),
                                                   lr=0.1),
                                   backward_passes_per_step=2)
    with pytest.raises(ValueError, match="alternative forms"):
        _port_step(tcfg, params, opt, accum_steps=2)
    with pytest.raises(ValueError, match="accum_steps"):
        _port_step(tcfg, params, opt, accum_steps=0)


def test_optimizer_options():
    """backward_passes_per_step scales the reduced gradient; the fp16 cast
    round-trips it through bf16; an inter_compressor that is not an
    ops.compressor InterCompressor, or a world that is not the group's,
    is refused; what is not ported yet raises."""
    w = torch.zeros(3, requires_grad=True)
    g = torch.tensor([1.0, 1.0 / 3.0, -2.5])
    opt = bps.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   backward_passes_per_step=2)
    w.grad = g.clone()
    opt.synchronize()
    torch.testing.assert_close(w.grad, g / 2)
    opt = bps.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                   compression=bps.Compression.fp16)
    w.grad = g.clone()
    opt.synchronize()
    assert w.grad.dtype == torch.float32
    torch.testing.assert_close(w.grad, g.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
    with pytest.raises(TypeError, match="InterCompressor"):
        bps.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                 inter_compressor=object())
    with pytest.raises(ValueError, match="world=2"):
        bps.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                 inter_compressor=bps.compressor.create(
                                     {"compressor": "onebit"}), world=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        bps.DistributedOptimizer(torch.optim.SGD([w], lr=1.0),
                                 hierarchical=True)


def test_mlp_smoke():
    """The smallest model end to end: the loss matches the JAX MLP's from
    the same params, and training on a separable problem drives it down."""
    rng = np.random.RandomState(0)
    sizes = (16, 32, 4)
    centers = rng.randn(4, 16).astype(np.float32) * 3
    y = rng.randint(0, 4, size=64)
    x = (centers[y] + rng.randn(64, 16)).astype(np.float32)
    jparams = jax.tree.map(np.asarray,
                           jmlp.init_params(jax.random.key(0), sizes))
    params = [{k: torch.tensor(v, requires_grad=True) for k, v in l.items()}
              for l in jparams]
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())
    want = float(jmlp.loss_fn(jparams, (jnp.asarray(x), jnp.asarray(y))))
    assert abs(float(mlp.loss_fn(params, batch).detach()) - want) \
        <= 1e-5 * abs(want)
    opt = bps.DistributedOptimizer(torch.optim.Adam(tree_leaves(params),
                                                    lr=1e-2))
    step = bps.build_train_step(mlp.loss_fn, opt, device="cpu")
    losses = [float(step(params, batch)) for _ in range(30)]
    assert losses[-1] < 0.25 * losses[0]
    assert float(mlp.accuracy(params, batch)) > 0.9
    own = mlp.init_params(torch.Generator().manual_seed(0), sizes,
                          device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(own)] == \
        [a.shape for a in jax.tree.leaves(jparams)]
