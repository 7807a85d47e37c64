"""Step-indexed checkpoint / resume — the port of ``sparktorch_tpu/utils/checkpoint.py:144-305``.

A snapshot is the trainer's whole state: the module's ``state_dict``
(buffers included, so BatchNorm running statistics too), the
optimizer's ``state_dict`` and the step counter. The format is torch's
(one ``torch.save`` file per step), not orbax's.

Layout: ``<dir>/<step>/state.pt``. A save writes
``<dir>/<step>.tmp-<pid>/`` and then ``os.replace``s it to
``<dir>/<step>/``, so a step directory either holds a whole snapshot or
does not exist; then the directory is pruned to ``max_to_keep`` steps.
Tensors go to the CPU before ``torch.save`` (a CUDA tensor would pickle
its device), and ``restore`` loads under ``weights_only=True``.
Each save and restore is a goodput ``checkpoint`` span (``op`` save,
restore, save_model, load_model), as in the JAX package.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional

import torch

from sparktorch_tpu_torch.obs import goodput as _goodput

_TMP_MARKER = ".tmp-"
_STATE_FILE = "state.pt"


def _finalized(directory: str, name: str) -> bool:
    """Whether ``<directory>/<name>`` is a finalized step: an all-digits
    directory holding a snapshot file and no tmp marker."""
    if not name.isdigit():
        return False
    try:
        entries = os.listdir(os.path.join(directory, name))
    except OSError:  # not a directory, or gone
        return False
    return _STATE_FILE in entries and not any(_TMP_MARKER in e
                                              for e in entries)


def latest_step(directory: str) -> Optional[int]:
    """Newest FINALIZED snapshot step in ``directory``, from a plain
    directory scan (safe while another process may still be writing).
    In-progress or interrupted saves (``<step>.tmp-<pid>``, or a step
    directory still holding tmp items) and empty directories are
    skipped. Returns None when the directory is missing or holds
    nothing finalized."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    steps = [int(n) for n in names if _finalized(directory, n)]
    return max(steps) if steps else None


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _save_file(path: str, tree: Any) -> None:
    torch.save(_to_cpu(tree), path)


def _load_file(path: str, map_location=None) -> Any:
    return torch.load(path, map_location=map_location, weights_only=True)


class CheckpointManager:
    """Step-indexed snapshots in one directory, with retention.

    ``state`` is any nest of dicts, lists and tuples of tensors and
    Python scalars (the trainers pass ``{"model": ..., "optimizer": ...,
    "step": ...}``). Saves are synchronous: ``wait`` has nothing to
    flush and exists for the reference's interface."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 save_interval_steps: int = 1):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = max(1, int(save_interval_steps))

    def save(self, step: int, state: Any, force: bool = False) -> bool:
        """Snapshot ``state`` as ``step``. Without ``force`` a step off
        the save interval, or not past the newest saved step, is
        skipped (orbax's rule). Returns whether a snapshot was
        written."""
        step = int(step)
        if not force:
            last = self.latest_step()
            if step % self.save_interval_steps or (
                    last is not None and step <= last):
                return False
        final = os.path.join(self._dir, str(step))
        tmp = f"{final}{_TMP_MARKER}{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with _goodput.span("checkpoint", {"op": "save"}):
            _save_file(os.path.join(tmp, _STATE_FILE), state)
        if os.path.exists(final):  # a forced save over the same step
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._prune()
        return True

    def _prune(self) -> None:
        if self.max_to_keep is None or self.max_to_keep <= 0:
            return
        for step in self.all_steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self._dir, str(step)),
                          ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        return latest_step(self._dir)

    def all_steps(self) -> list:
        """Finalized steps on disk, oldest first (at most
        ``max_to_keep`` after a save)."""
        return sorted(int(n) for n in os.listdir(self._dir)
                      if _finalized(self._dir, n))

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The snapshot of ``step`` (default: the newest), its tensors
        placed by ``map_location`` as ``torch.load`` takes it."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        with _goodput.span("checkpoint", {"op": "restore"}):
            return _load_file(os.path.join(self._dir, str(step),
                                           _STATE_FILE), map_location)

    def wait(self) -> None:
        pass

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def save_model(directory: str, params: Any, model_state: Any = None) -> None:
    """One-shot final-model save: ``params`` (a ``state_dict``) and an
    optional ``model_state`` under ``<directory>/model/``."""
    path = os.path.join(os.path.abspath(directory), "model")
    os.makedirs(path, exist_ok=True)
    with _goodput.span("checkpoint", {"op": "save_model"}):
        _save_file(os.path.join(path, _STATE_FILE),
                   {"params": params, "model_state": model_state or {}})


def load_model(directory: str, map_location=None):
    """``(params, model_state)`` as :func:`save_model` wrote them."""
    with _goodput.span("checkpoint", {"op": "load_model"}):
        out = _load_file(os.path.join(os.path.abspath(directory), "model",
                                      _STATE_FILE), map_location)
    return out["params"], out.get("model_state") or {}
