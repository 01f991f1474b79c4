"""byteps_tpu_torch.models.cnn against the flax models of byteps_tpu.

ResNet18 at 32 x 32 and VGG16 at 64 x 64, batch 2, the port in float32:
the flax variables (params and batch_stats, as numpy) load through
``params_from_numpy``, and the loss of ``cnn_loss_fn`` (BatchNorm on its
running statistics, as the JAX loss) must match to rtol 1e-5 and every
parameter's gradient to relative L2 1e-4.  ResNet18 is held to flax in
float32.  VGG16 is held to flax computing in float64: flax's own float32
gradients of VGG's first two convolutions miss their float64 values by
3.4e-3 relative on the CPU (XLA's float32 backward there, whatever the
matmul precision), where the port's float32 ones miss them by 1.7e-6
(scripts/cpu_precision_checks.py).  The batch statistics and the
BatchNorm scales are randomized first: with flax's zero-initialized last
scale, a residual branch adds nothing, and a wrong pad inside it would not
show.  Two controls show the comparison can fail: ResNet18 with torch's
symmetric padding in place of flax's "SAME", and VGG16 flattening NCHW in
place of NHWC, each miss the flax loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.models import cnn as jcnn
from byteps_tpu_torch.models import cnn
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

CLASSES = 10


def _randomize(variables, seed):
    """Random BatchNorm statistics and scales (flax starts at 0/1 and at a
    zero scale for each block's last norm)."""
    rng = np.random.RandomState(seed)
    out = jax.tree.map(np.asarray, variables)

    def walk(params, stats):
        for k, v in params.items():
            if isinstance(v, dict):
                walk(v, stats.get(k, {}) if stats is not None else None)
            elif k == "scale":
                params[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
            elif k == "bias" and stats is not None and stats:
                params[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        if stats:
            for k, v in stats.items():
                if k == "mean":
                    stats[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
                elif k == "var":
                    stats[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
    out = {k: dict(v) for k, v in out.items()}
    out = jax.tree.map(lambda x: np.array(x), out)
    walk(out["params"], out.get("batch_stats"))
    return out


@functools.lru_cache(maxsize=None)
def _inputs(name, hw, seed):
    """Flax's variables (randomized, float32) and the batch."""
    model = jcnn.create_cnn(name, num_classes=CLASSES, dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    x = rng.rand(2, hw, hw, 3).astype(np.float32)
    y = rng.randint(0, CLASSES, size=(2,)).astype(np.int32)
    variables = jax.jit(lambda key, x: model.init(key, x, train=False))(
        jax.random.key(seed), jnp.asarray(x))
    return _randomize(variables, seed), x, y


@functools.lru_cache(maxsize=None)
def _flax(name, hw, seed, x64=False):
    """Flax's variables (randomized, float32), batch, loss and gradients;
    with ``x64`` the loss and gradients are computed in float64 on the
    same float32 variables and batch.  Computed once per arguments (the
    controls reuse the parity cases' inputs and references) and under
    jit: the flax model's init and gradient dispatched op by op took 5-10x
    as long on the CPU."""
    variables, x, y = _inputs(name, hw, seed)
    with jax.enable_x64(x64):
        dt = jnp.float64 if x64 else jnp.float32
        model = jcnn.create_cnn(name, num_classes=CLASSES, dtype=dt)
        loss_fn = jcnn.cnn_loss_fn(model)
        vs = jax.tree.map(lambda a: jnp.asarray(a, dt), variables)

        def f(params):
            return loss_fn({**vs, "params": params},
                           (jnp.asarray(x, dt), jnp.asarray(y)))
        loss, grads = jax.jit(jax.value_and_grad(f))(vs["params"])
        return (variables, (x, y), float(loss),
                jax.tree.map(lambda a: np.asarray(a, np.float64), grads))


def _port(name, hw, variables, batch):
    kw = {"image_size": hw} if name.startswith("vgg") else {}
    model = cnn.create_cnn(name, num_classes=CLASSES, device="cpu", **kw)
    cnn.params_from_numpy(model, variables)
    x, y = batch
    loss = cnn.cnn_loss_fn(model)(None, (torch.from_numpy(x),
                                         torch.from_numpy(y).long()))
    loss.backward()
    return model, float(loss.detach())


def _grads_match(model, grads):
    tree = cnn.cnn_variables(model)["params"]

    def walk(mine, ref, path):
        for k, v in mine.items():
            if isinstance(v, dict):
                walk(v, ref[k], f"{path}.{k}")
                continue
            g = v.grad.numpy().astype(np.float64)
            r = np.asarray(ref[k], np.float64)
            if r.ndim == 4:
                r = r.transpose(3, 2, 0, 1)
            err = np.linalg.norm(g - r) / (np.linalg.norm(r) + 1e-30)
            assert err <= 1e-4, (f"{path}.{k}", err)
    walk(tree, grads, "params")


@pytest.mark.parametrize("name,hw,x64", [("resnet18", 32, False),
                                         ("vgg16", 64, True)])
def test_cnn_matches_flax(name, hw, x64):
    variables, batch, want, grads = _flax(name, hw, 0, x64)
    model, got = _port(name, hw, variables, batch)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    _grads_match(model, grads)


def test_symmetric_padding_would_miss_flax(monkeypatch):
    """Control: torch's symmetric padding in the strided 3x3 convs and the
    max-pool gives the same shapes and another loss."""
    variables, batch, want, _ = _flax("resnet18", 32, 0, False)
    monkeypatch.setattr(cnn, "_same_pad",
                        lambda size, k, s: ((k - 1) // 2, (k - 1) // 2))
    _, got = _port("resnet18", 32, variables, batch)
    assert abs(got - want) > 1e-3 * abs(want), (got, want)


def test_nchw_flattening_would_miss_flax(monkeypatch):
    """Control: VGG flattening its 2 x 2 x 512 map in NCHW order."""
    variables, batch, want, _ = _flax("vgg16", 64, 0, False)
    monkeypatch.setattr(cnn, "_flatten", lambda x: x.reshape(x.shape[0], -1))
    _, got = _port("vgg16", 64, variables, batch)
    assert abs(got - want) > 1e-3 * abs(want), (got, want)


def test_model_family_and_layout():
    """Every name of the JAX package builds; ResNet-50 has the 161
    parameter tensors of the flax model, and the variable tree holds
    flax's names; the train-mode BatchNorm update is flax's (momentum 0.9,
    biased batch variance)."""
    assert cnn.CNN_NAMES == jcnn.CNN_NAMES
    m = cnn.create_cnn("resnet50", device="cpu")
    assert len(list(m.parameters())) == 161
    tree = cnn.cnn_variables(m)
    assert sorted(tree) == ["batch_stats", "params"]
    assert tree["params"]["conv_init"]["kernel"].shape == (64, 3, 7, 7)
    assert "conv_proj" in tree["params"]["BottleneckResNetBlock_0"]
    assert "BottleneckResNetBlock_15" in tree["params"]
    with pytest.raises(ValueError, match="unknown cnn"):
        cnn.create_cnn("alexnet", device="cpu")
    bn = cnn.BatchNorm(3)
    x = torch.randn(4, 3, 5, 5)
    bn.train()
    bn(x)
    mean, var = x.mean((0, 2, 3)), x.var((0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.mean, 0.1 * mean)
    torch.testing.assert_close(bn.var, 0.9 + 0.1 * var)
