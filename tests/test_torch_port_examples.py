"""byteps_tpu_torch's native examples against the reference's.

Each ``main(argv)`` runs in process on ``--device cpu`` with small
arguments.  ``train_mnist`` and ``train_mnist_fp16`` print the lines that
``example/torch/train_mnist_torch_byteps.py`` and
``train_mnist_fp16_byteps.py`` (on ``byteps_tpu.torch``, run in process
through ``runpy``) print with the same seed and arguments;
``benchmark_cross_barrier`` prints the reference's rate line and its two
runs end at the same parameters.  The counterparts of ``example/jax/*``
print the JAX scripts' lines (their format strings, cited at each test,
with the numbers masked) and train with finite, falling losses;
``train_long_context --attn ring --sp 2`` runs in the 2-rank world of
``tests/test_torch_port_sp_model.py``.  Without CUDA, the default device
stops each example with an error.
"""

import os
import re
import runpy
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from byteps_tpu.ops import compressor as jC
from byteps_tpu_torch.core import native
from byteps_tpu_torch.examples import (
    benchmark, benchmark_cross_barrier, elastic_benchmark, train_compressed,
    train_hybrid_parallel, train_imagenet_resnet, train_llama,
    train_long_context, train_mnist, train_mnist_fp16)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(monkeypatch, capsys, name, *args):
    """The reference example's standard output, run in process."""
    path = os.path.join(REPO, "example", "torch", name)
    monkeypatch.setattr(sys, "argv", [path, *args])
    capsys.readouterr()
    runpy.run_path(path, run_name="__main__")
    return capsys.readouterr().out.splitlines()


@pytest.mark.parametrize("module,reference,args", [
    (train_mnist, "train_mnist_torch_byteps.py",
     ("--epochs", "1", "--batch-size", "512")),
    (train_mnist_fp16, "train_mnist_fp16_byteps.py", ("--steps", "21")),
])
def test_example_prints_the_references_lines(monkeypatch, capsys, module,
                                             reference, args):
    want = _reference(monkeypatch, capsys, reference, *args)
    result = module.main([*args, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want and got
    if module is train_mnist:
        assert [l.split(":")[0] for l in got] == ["rank 0/1 epoch 0"]
        assert result["acc"] > 0.5        # chance is 0.1
    else:
        assert result["last_loss"] < result["first_loss"]
        assert got[-1] == "fp16 training done"


def test_benchmark_cross_barrier(capsys):
    result = benchmark_cross_barrier.main(
        ["--steps", "4", "--width", "64", "--depth", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"rank 0/1: baseline [\d.]+ steps/s, cross-barrier "
                        r"[\d.]+ steps/s \([\d.]+x\)", out[0]), out
    assert out[1].startswith("params after 5 steps: cross-barrier vs "
                             "baseline, largest relative difference")
    assert result["baseline_steps_per_s"] > 0
    assert result["cross_barrier_steps_per_s"] > 0
    assert result["params_rel_diff"] <= 1e-5


NUM = r"-?\d+\.\d+"
EXAMPLES = (train_mnist, train_mnist_fp16, benchmark_cross_barrier,
            train_llama, train_hybrid_parallel, train_long_context,
            train_compressed, train_imagenet_resnet, benchmark,
            elastic_benchmark)


def _run(module, capsys, *args):
    """main(args + --device cpu): (its printed lines, its result)."""
    capsys.readouterr()
    result = module.main([*args, "--device", "cpu"])
    return capsys.readouterr().out.splitlines(), result


def _falls(losses):
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


@pytest.mark.parametrize("args", [
    (), ("--attn", "flash"), ("--zero1",), ("--fsdp",),
], ids=["dp", "flash", "zero1", "fsdp"])
def test_train_llama(capsys, args):
    """example/jax/train_llama_byteps.py:93-95:
    ``print(f"step {i} loss {last:.4f}", flush=True)`` at every fifth step
    and the last, then ``print(f"final: first={first:.4f} last={last:.4f}
    improved={last < first}")``."""
    out, res = _run(train_llama, capsys, "--steps", "6", "--batch-size",
                    "4", "--seq-len", "32", *args)
    want = [rf"step 0 loss {NUM}", rf"step 5 loss {NUM}",
            rf"final: first={NUM} last={NUM} improved=True"]
    assert len(out) == 3 and all(re.fullmatch(w, l)
                                 for w, l in zip(want, out)), out
    _falls(res["losses"])


@pytest.mark.parametrize("args", [(), ("--experts", "4")],
                         ids=["dense", "moe"])
def test_train_hybrid_parallel(capsys, args):
    """example/jax/train_hybrid_parallel.py:50:
    ``print(f"step {i}: loss={float(loss):.4f}")`` every step, on a world
    of one (every axis 1)."""
    out, res = _run(train_hybrid_parallel, capsys, "--steps", "3",
                    "--layers", "2", "--d-model", "32", *args)
    assert [re.sub(NUM, "X", l) for l in out] == [
        f"step {i}: loss=X" for i in range(3)], out
    _falls(res["losses"])


@pytest.mark.parametrize("attn", ["flash", "ring"])
def test_train_long_context(capsys, attn):
    """example/jax/train_long_context.py:54-55 (flash:
    ``f"step {i}: loss={float(loss):.4f} (flash, seq_len={args.seq_len})"``)
    and :72 (ring, ``(seq_len=...)``); the ring on an sp mesh of one here,
    of two in tests/test_torch_port_sp_model.py."""
    out, res = _run(train_long_context, capsys, "--attn", attn, "--sp", "1",
                    "--seq-len", "128", "--steps", "3")
    tag = "flash, " if attn == "flash" else ""
    assert [re.sub(NUM, "X", l) for l in out] == [
        f"step {i}: loss=X ({tag}seq_len=128)" for i in range(3)], out
    _falls(res["losses"])


@pytest.mark.parametrize("args", [
    ("--compressor", "onebit"),
    ("--compressor", "onebit", "--ef", "vanilla", "--momentum", "nesterov"),
    ("--compressor", "topk"), ("--compressor", "dithering"),
], ids=["onebit", "onebit_ef_nesterov", "topk", "dithering"])
def test_train_compressed(capsys, args):
    """example/jax/train_compressed_byteps.py:44,55:
    ``print(f"compressor={kwargs} ratio~{C.compression_ratio(tree,
    comp):.1f}x")``, then ``print(f"step {i}: loss={float(loss):.4f}")``
    every fifth step; the ratio is the JAX package's for the same tree and
    compressor."""
    out, res = _run(train_compressed, capsys, "--steps", "10", *args)
    kwargs = {"compressor": args[1], "k": 64}
    kwargs.update(zip((a[2:] for a in args[2::2]), args[3::2]))
    want = jC.compression_ratio({"w": jnp.zeros(64 * 128 + 128 * 10)},
                                jC.create(kwargs))
    assert res["ratio"] == pytest.approx(want, rel=1e-12)
    assert out[0] == f"compressor={kwargs} ratio~{want:.1f}x"
    assert [re.sub(NUM, "X", l) for l in out[1:]] == [
        "step 0: loss=X", "step 5: loss=X"], out
    _falls(res["losses"])


def test_train_imagenet_resnet(capsys):
    """example/jax/train_imagenet_resnet_byteps.py:56:
    ``print(f"step {i}: loss={float(loss):.4f}")`` every second step;
    ResNet-50 on 32 x 32 ones."""
    out, res = _run(train_imagenet_resnet, capsys, "--steps", "3",
                    "--batch-size", "2", "--image-size", "32")
    assert [re.sub(NUM, "X", l) for l in out] == [
        "step 0: loss=X", "step 2: loss=X"], out
    _falls(res["losses"])


@pytest.mark.parametrize("model", ["tiny", "resnet50"])
def test_benchmark(capsys, tmp_path, model):
    """example/jax/benchmark_byteps.py:81,84-88: ``print(f"profile written
    to {args.trace_dir}")`` under --profiler, the rate line
    ``f"{args.model}: {mean:.1f} +- {std:.1f} {unit}/sec per worker (total
    {mean * size:.1f})"`` and ``print(f"push_pull speed: {speed:.2f}
    MB/s")``."""
    small = (("--seq-len", "64", "--profiler", "--trace-dir", str(tmp_path))
             if model == "tiny" else ("--image-size", "32"))
    out, res = _run(benchmark, capsys, "--model", model, "--batch-size", "2",
                    "--num-warmup", "1", "--num-iters", "2", *small)
    unit = "tokens" if model == "tiny" else "imgs"
    want = [rf"{model}: {NUM} \+- {NUM} {unit}/sec per worker "
            rf"\(total {NUM}\)", rf"push_pull speed: {NUM} MB/s"]
    if model == "tiny":
        want.insert(0, f"profile written to {re.escape(str(tmp_path))}")
        assert os.listdir(tmp_path)
    assert len(out) == len(want) and all(
        re.fullmatch(w, l) for w, l in zip(want, out)), out
    assert res["unit"] == unit and min(res["rates"]) > 0


def test_elastic_benchmark(monkeypatch, capsys):
    """example/jax/elastic_benchmark_byteps.py:40,52: ``print(f"phase 1
    done: loss={loss:.4f}, declared={bps.declared_key('Gradient.b0')}")``
    and ``print(f"phase 2 done after resume: loss={loss:.4f}")``; the keys
    after resume are a fresh process's, 0 and 1."""
    monkeypatch.setattr(native, "_core", None)   # a fresh registry
    monkeypatch.setenv("DMLC_NUM_WORKER", "1")   # resume() writes these
    monkeypatch.setenv("DMLC_NUM_SERVER", "0")
    out, res = _run(elastic_benchmark, capsys)
    assert [re.sub(NUM, "X", l) for l in out] == [
        "phase 1 done: loss=X, declared=1",
        "phase 2 done after resume: loss=X"], out
    assert res["keys"] == {"Gradient.w0": 0, "Gradient.b0": 1}
    assert res["phase2_loss"] < res["phase1_loss"]


@pytest.mark.parametrize("module", EXAMPLES,
                         ids=[m.__name__.rsplit(".", 1)[1] for m in EXAMPLES])
def test_default_device_without_cuda_stops(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(SystemExit) as e:
        module.main([])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
