"""byteps_tpu_torch's native examples against the reference's.

Each ``main(argv)`` runs in process on ``--device cpu`` with small
arguments.  ``train_mnist`` and ``train_mnist_fp16`` print the lines that
``example/torch/train_mnist_torch_byteps.py`` and
``train_mnist_fp16_byteps.py`` (on ``byteps_tpu.torch``, run in process
through ``runpy``) print with the same seed and arguments;
``benchmark_cross_barrier`` prints the reference's rate line and its two
runs end at the same parameters.  Without CUDA, the default device stops
each example with an error.
"""

import os
import re
import runpy
import sys

import pytest
import torch

from byteps_tpu_torch.examples import (benchmark_cross_barrier, train_mnist,
                                       train_mnist_fp16)
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


@pytest.mark.parametrize("module", [train_mnist, train_mnist_fp16,
                                    benchmark_cross_barrier])
def test_default_device_without_cuda_stops(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(SystemExit) as e:
        module.main([])
    assert e.value.code == 2
    assert "no CUDA device" in capsys.readouterr().err
