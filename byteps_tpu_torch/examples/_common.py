"""What the examples share: the ``--device`` flag."""

from __future__ import annotations

import argparse

import torch

from ..common.device import resolve_device


def add_device_arg(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help='"cuda" (default) or "cpu"; without a CUDA device '
                         'the example stops unless given "cpu"')


def device(ap: argparse.ArgumentParser, args) -> torch.device:
    """The device asked for; an argparse error (exit 2) when it is CUDA
    and there is none."""
    try:
        return resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
