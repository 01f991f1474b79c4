"""BYTEPS_DEBUG_SAMPLE_TENSOR in the port, as ``tests/test_api.py::
test_debug_sample_tensor_logging`` holds it in the JAX package: a tensor
whose name contains the setting is sampled to stderr at push entry and
after synchronize, in the reference's line format
(``byteps_tpu/common/api.py:1043-1063``); other names are not.  In
process, through the eager API and through the Horovod face, which
passes through the eager API's push_pull_async and synchronize."""

import re

import pytest
import torch

import byteps_tpu_torch as bps
import byteps_tpu_torch.torch as hvd
from byteps_tpu_torch.common.config import get_config
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse)

LINE = (r"\[byteps_tpu DEBUG_SAMPLE\] (push|pull) name=(\S+) shape=\(4,\) "
        r"dtype=float32 norm2=3\.74166 sum=6 first=\[0, 1, 2, 3\]")


@pytest.fixture
def sampling(monkeypatch):
    monkeypatch.setenv("BYTEPS_DEBUG_SAMPLE_TENSOR", "probe")
    yield
    monkeypatch.delenv("BYTEPS_DEBUG_SAMPLE_TENSOR")
    get_config(refresh=True)


@pytest.mark.parametrize("face", ["api", "horovod"])
def test_debug_sample_tensor_logging(sampling, capfd, face):
    mod = bps if face == "api" else hvd
    mod.init()
    try:
        capfd.readouterr()
        out = mod.push_pull(torch.arange(4.0), name="Gradient.probe",
                            average=False)
        mod.push_pull(torch.ones(3), name="unrelated", average=False)
    finally:
        mod.shutdown()
    err = capfd.readouterr().err
    assert torch.equal(out, torch.arange(4.0))
    lines = [m.groups() for m in re.finditer(LINE, err)]
    assert lines == [("push", "Gradient.probe"), ("pull", "Gradient.probe")]
    assert "DEBUG_SAMPLE] push name=Gradient.probe" in err
    assert "DEBUG_SAMPLE] pull name=Gradient.probe" in err
    assert "sum=6" in err
    assert "name=unrelated" not in err


def test_debug_sample_tensor_off_by_default(monkeypatch, capfd):
    monkeypatch.delenv("BYTEPS_DEBUG_SAMPLE_TENSOR", raising=False)
    bps.init()
    try:
        capfd.readouterr()
        bps.push_pull(torch.arange(4.0), name="Gradient.probe")
    finally:
        bps.shutdown()
    assert get_config().debug_sample_tensor == ""
    assert "DEBUG_SAMPLE" not in capfd.readouterr().err
