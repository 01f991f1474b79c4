"""Checkpoint save and restore.

Counterpart of ``byteps_tpu/utils/checkpoint.py`` with the port's own
on-disk format: a ``torch.save`` of the state (any tree of tensors) in
``<path>/state.pt``.  The distributed rules are the JAX package's: only
rank 0 writes, every rank restores, and the restored state is broadcast
from rank 0, so every worker starts bit-identical.  Orbax checkpoints
are not read.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional

import torch

from ..common.tree import tree_leaves, tree_unflatten

Tree = Any
STATE_FILE = "state.pt"


def _should_write() -> bool:
    from ..common.api import rank
    return rank() == 0


def _to_cpu(state: Tree) -> Tree:
    return tree_unflatten(state, [
        l.detach().to("cpu", copy=True) if torch.is_tensor(l) else l
        for l in tree_leaves(state)])


def _write(path: str, state: Tree, force: bool) -> None:
    apath = os.path.abspath(os.path.expanduser(path))
    if os.path.exists(apath) and not force:
        raise FileExistsError(f"checkpoint {apath} exists (force=False)")
    os.makedirs(apath, exist_ok=True)
    tmp = os.path.join(apath, f".{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(apath, STATE_FILE))


def save(path: str, state: Tree, force: bool = True) -> None:
    """Write ``state`` to the directory ``path`` (rank 0 only)."""
    if _should_write():
        _write(path, _to_cpu(state), force)


def restore(path: str, template: Optional[Tree] = None,
            broadcast: bool = True) -> Tree:
    """Load the checkpoint at ``path``.  With a ``template``, each restored
    leaf takes the template leaf's device and dtype and the template's
    structure must match.  With ``broadcast`` (default) the result is
    broadcast from rank 0."""
    apath = os.path.abspath(os.path.expanduser(path))
    restored = torch.load(os.path.join(apath, STATE_FILE),
                          map_location="cpu", weights_only=True)
    if template is not None:
        got, want = tree_leaves(restored), tree_leaves(template)
        if len(got) != len(want):
            raise ValueError(f"checkpoint {apath} has {len(got)} leaves, "
                             f"the template {len(want)}")
        restored = tree_unflatten(template, [
            g.to(device=w.device, dtype=w.dtype)
            if torch.is_tensor(w) and torch.is_tensor(g) else g
            for g, w in zip(got, want)])
    if broadcast:
        from ..common.api import broadcast_parameters, size
        if size() > 1:
            restored = broadcast_parameters(restored, root_rank=0)
    return restored


class AsyncSaver:
    """Non-blocking checkpoint writes: ``save()`` returns once the state is
    copied to host memory; the write runs on a thread and overlaps the
    next steps.  ``wait()`` before the next save or shutdown.

        saver = AsyncSaver()
        saver.save(path, state)
        ...
        saver.wait()
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, state: Tree, force: bool = True) -> None:
        self.wait()
        if not _should_write():
            return
        snapshot = _to_cpu(state)

        def run():
            try:
                _write(path, snapshot, force)
            except BaseException as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the write in flight (if any) is on disk; re-raise its
        error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def latest_step_dir(root: str) -> Optional[str]:
    """The highest-numbered subdirectory of ``root``, or None."""
    if not os.path.isdir(root):
        return None
    steps = [d for d in os.listdir(root) if d.isdigit()]
    if not steps:
        return None
    return os.path.join(root, max(steps, key=int))
