"""byteps_tpu_torch stands alone: it imports neither JAX nor byteps_tpu,
importing it builds no CUDA kernel and no C++ core, and its entry points
refuse to run on the CPU unless asked to."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
import byteps_tpu_torch
from byteps_tpu_torch.ops import _build
mods = [m.name for m in pkgutil.walk_packages(byteps_tpu_torch.__path__,
                                               "byteps_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from byteps_tpu_torch.torch import CrossBarrier
from byteps_tpu_torch.core import build, native
from byteps_tpu_torch.server import wire
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "byteps_tpu", "optax",
                                    "flax"))
print(json.dumps({"modules": mods, "bad": bad, "built": sorted(_build._libs),
                  "triton": "triton" in sys.modules,
                  "native": [native.is_native(), build.last_build_seconds,
                             wire._CWIRE]}))
"""


def test_import_pulls_in_no_jax_and_no_reference_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=50)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["built"] == [] and not res["triton"]   # no kernel built
    assert res["native"] == [False, None, False]      # no C++ core built
    for mod in ("byteps_tpu_torch.ops.flash_attention",
                "byteps_tpu_torch.ops.collectives",
                "byteps_tpu_torch.ops.ring_attention",
                "byteps_tpu_torch.ops.compressor",
                "byteps_tpu_torch.ops.compressor.base",
                "byteps_tpu_torch.ops.compressor.bitpack",
                "byteps_tpu_torch.ops.compressor.onebit",
                "byteps_tpu_torch.ops.compressor.dithering",
                "byteps_tpu_torch.ops.compressor.topk",
                "byteps_tpu_torch.ops.compressor.randomk",
                "byteps_tpu_torch.ops.compressor.decorators",
                "byteps_tpu_torch.ops.compressor.registry",
                "byteps_tpu_torch.ops.compressor.reduce",
                "byteps_tpu_torch.models.transformer",
                "byteps_tpu_torch.parallel.data_parallel",
                "byteps_tpu_torch.common.api",
                "byteps_tpu_torch.core.native",
                "byteps_tpu_torch.torch",
                "byteps_tpu_torch.torch.fp16",
                "byteps_tpu_torch.models.cnn",
                "byteps_tpu_torch.callbacks",
                "byteps_tpu_torch.utils.checkpoint",
                "byteps_tpu_torch.utils.data",
                "byteps_tpu_torch.launcher.launch",
                "byteps_tpu_torch.launcher.dist_launcher",
                "byteps_tpu_torch.parallel.mesh",
                "byteps_tpu_torch.parallel.cross_barrier",
                "byteps_tpu_torch.torch.cross_barrier",
                "byteps_tpu_torch.examples.train_mnist",
                "byteps_tpu_torch.examples.train_mnist_fp16",
                "byteps_tpu_torch.examples.benchmark_cross_barrier",
                "byteps_tpu_torch.parallel.sharded",
                "byteps_tpu_torch.parallel.tensor_parallel",
                "byteps_tpu_torch.parallel.pipeline",
                "byteps_tpu_torch.parallel.expert",
                "byteps_tpu_torch.models.hybrid",
                "byteps_tpu_torch.common.telemetry",
                "byteps_tpu_torch.common.flightrec",
                "byteps_tpu_torch.common.trace_analysis",
                "byteps_tpu_torch.common.devprof",
                "byteps_tpu_torch.common.signals",
                "byteps_tpu_torch.common.doctor",
                "byteps_tpu_torch.common.ring",
                "byteps_tpu_torch.common.fusion",
                "byteps_tpu_torch.core.build",
                "byteps_tpu_torch.server",
                "byteps_tpu_torch.server.__main__",
                "byteps_tpu_torch.server.wire",
                "byteps_tpu_torch.server.codec_pool",
                "byteps_tpu_torch.server.client",
                "byteps_tpu_torch.parallel.hierarchy",
                "byteps_tpu_torch.parallel.async_ps",
                "byteps_tpu_torch.parallel.server_opt",
                "byteps_tpu_torch.parallel.embedding"):
        assert mod in res["modules"]


def test_sources_never_name_jax():
    pkg = os.path.join(REPO, "byteps_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        if s.startswith(("import ", "from ")):
                            assert "jax" not in s and "byteps_tpu." \
                                not in s.replace("byteps_tpu_torch", ""), s


def test_default_device_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import byteps_tpu_torch as bps
    from byteps_tpu_torch.models import mlp
    from byteps_tpu_torch.models import transformer as tfm
    cfg = tfm.get_config("tiny")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.init_params(gen, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.synthetic_batch(gen, 2, 64, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfm.params_from_numpy({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mlp.init_params(gen)
    from byteps_tpu_torch.models import hybrid
    from byteps_tpu_torch.parallel import expert
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hybrid.init_params(gen, hybrid.HybridConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        expert.init_moe_params(gen, 4, 8, 16)
    w = torch.zeros(2, requires_grad=True)
    opt = bps.DistributedOptimizer(torch.optim.SGD([w], lr=0.1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bps.build_train_step(lambda p, b: (p[0] ** 2).sum(), opt)
    # Asked for explicitly, the CPU works; a step built for CPU refuses
    # params that live elsewhere only by device type.
    step = bps.build_train_step(lambda p, b: (p[0] ** 2).sum(), opt,
                                device="cpu")
    assert float(step([w], None)) == 0.0


_EXPORT_PROBE = """
import json, sys
import byteps_tpu_torch as bps
from byteps_tpu_torch.ops import _build, ring_attention
from byteps_tpu_torch.parallel import sharded
names = ["build_sharded_train_step", "shard_params", "init_sharded",
         "zero1_opt_specs", "zero1_init", "fsdp_param_specs", "fsdp_init"]
import byteps_tpu_torch.models.hybrid as hybrid
print(json.dumps({"same": bps.ring_attention is ring_attention,
                  "sharded": all(getattr(bps, n) is getattr(sharded, n)
                                 and n in bps.__all__ for n in names),
                  "hybrid": bps.models.hybrid is hybrid,
                  "listed": "ring_attention" in bps.__all__,
                  "attention": callable(
                      bps.ring_attention.ring_attention_shard),
                  "triton": "triton" in sys.modules,
                  "built": sorted(_build._libs)}))
"""


def test_top_level_exports_ring_attention():
    """``byteps_tpu_torch.ring_attention`` resolves to the ops module, as
    ``byteps_tpu.ring_attention`` does, the seven sharded-step names of
    ``byteps_tpu/__init__.py`` are exported from ``parallel.sharded``,
    ``models.hybrid`` is reachable as in the reference, and importing the
    package still imports no Triton and builds no kernel."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", _EXPORT_PROBE], env=env,
                         cwd=REPO, capture_output=True, text=True, timeout=50)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"same": True, "sharded": True, "hybrid": True,
                   "listed": True, "attention": True, "triton": False,
                   "built": []}
