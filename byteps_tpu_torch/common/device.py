"""Where the package's entry points run: CUDA unless the caller asks for
another device.  Without CUDA they raise; they never carry on silently on
the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "byteps_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``torch.distributed`` DTensor (a leaf or an
    activation of the sharded step, ``parallel/sharded.py``)."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
