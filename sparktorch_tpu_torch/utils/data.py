"""Feature batching, validation split, padding — the port of ``sparktorch_tpu/utils/data.py``.

:class:`DataBatch` is a batched (x, y, w) triple of tensors. ``w`` is a
per-example float32 weight: padding rows carry weight 0, so the weighted
loss and gradient means of the training step are unaffected by them.
:func:`handle_features` stacks rows and splits off a validation batch
with the same ``numpy`` permutation as the JAX package, so both packages
split a frame row for row alike.
"""

from __future__ import annotations

from typing import Iterable, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch


class DataBatch(NamedTuple):
    """Batched examples. ``y`` may be ``x`` (label-free mode). ``w`` is
    float32 (batch,)."""

    x: torch.Tensor
    y: torch.Tensor
    w: torch.Tensor

    @property
    def size(self) -> int:
        return self.x.shape[0]

    def to(self, device) -> "DataBatch":
        return DataBatch(*(a.to(device) for a in self))


def _stack_rows(rows: Sequence, has_label: bool
                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    xs, ys = [], []
    for row in rows:
        if has_label:
            x, y = row
            ys.append(np.asarray(y))
        else:
            x = row
        xs.append(np.asarray(x, dtype=np.float32))
    x = np.stack(xs) if xs else np.zeros((0, 1), np.float32)
    y = np.stack(ys) if ys else None
    return x, y


def _tensor(a: np.ndarray) -> torch.Tensor:
    """float64 → float32 (the JAX package's default precision); integer
    labels become int64, torch's index type."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif np.issubdtype(a.dtype, np.integer):
        a = a.astype(np.int64)
    return torch.from_numpy(a)


def handle_features(
    data: Union[Iterable, np.ndarray],
    labels: Optional[np.ndarray] = None,
    validation_pct: float = 0.0,
    seed: int = 0,
) -> Tuple[DataBatch, Optional[DataBatch]]:
    """Stack rows into a train batch (+ optional validation batch), on
    the CPU. Accepts parallel ``data``/``labels`` arrays or an iterable
    of ``(x, y)`` rows / bare ``x`` rows."""
    if labels is None and not isinstance(data, np.ndarray):
        rows = list(data)
        has_label = bool(rows) and isinstance(rows[0], tuple) and len(rows[0]) == 2
        x, y = _stack_rows(rows, has_label=has_label)
    else:
        x = np.asarray(data, dtype=np.float32)
        y = np.asarray(labels) if labels is not None else None
    if y is None:
        y = x  # label-free / autoencoder target

    n = x.shape[0]
    w = np.ones((n,), np.float32)
    if validation_pct and validation_pct > 0.0 and n > 1:
        perm = np.random.default_rng(seed).permutation(n)
        n_val = max(1, int(n * validation_pct))
        val_idx, train_idx = perm[:n_val], perm[n_val:]
        return (DataBatch(_tensor(x[train_idx]), _tensor(y[train_idx]),
                          _tensor(w[train_idx])),
                DataBatch(_tensor(x[val_idx]), _tensor(y[val_idx]),
                          _tensor(w[val_idx])))
    return DataBatch(_tensor(x), _tensor(y), _tensor(w)), None


def pad_batch(batch: DataBatch, to_size: int) -> DataBatch:
    """Zero-pad to ``to_size`` rows; padding rows get weight 0."""
    n = batch.size
    if n == to_size:
        return batch
    if n > to_size:
        raise ValueError(f"batch of {n} cannot be padded down to {to_size}")

    def _pad(a):
        return torch.cat([a, a.new_zeros((to_size - n, *a.shape[1:]))])

    return DataBatch(_pad(batch.x), _pad(batch.y), _pad(batch.w))


def pad_to_multiple(batch: DataBatch, multiple: int) -> DataBatch:
    """Pad so the batch divides evenly across ``multiple`` shards."""
    n = batch.size
    return pad_batch(batch, max(multiple, -(-n // multiple) * multiple))


def shard_batch(batch: DataBatch, rank: int, world: int) -> DataBatch:
    """Rank ``rank``'s shard of ``batch`` over a world of ``world``: the
    batch padded to a multiple of ``world`` with weight-0 rows, then the
    rank's contiguous slice — the layout of the JAX package's
    ``prepare_sharded_batch`` (``sparktorch_tpu/train/sync.py:61-75``)
    over a dp mesh, padding rows in the last shards."""
    padded = pad_to_multiple(batch, world)
    per = padded.size // world
    return DataBatch(*(a[rank * per:(rank + 1) * per] for a in padded))


def sample_minibatch(batch: DataBatch, generator: torch.Generator,
                     mini_batch: int) -> DataBatch:
    """A contiguous block of ``mini_batch`` rows at a uniform random
    offset (the JAX package's sampling rule: the trainer reshuffles the
    resident rows between rounds, so blocks are uniform across steps).
    The offset comes from a host-side generator, so sampling forces no
    device sync; the slices are views."""
    off = int(torch.randint(0, batch.size - mini_batch + 1, (),
                            generator=generator))
    return DataBatch(*(a[off:off + mini_batch] for a in batch))
