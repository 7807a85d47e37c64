"""Synchronous training on one GPU — the port of ``train_distributed`` (``sparktorch_tpu/train/sync.py:159``).

The whole training batch goes onto the card once. Each round (the
reference's partition shuffle) starts with an on-device permutation of
the resident rows, drawn from a ``torch.Generator`` seeded with
``seed + 1``; round 0 shuffles too when minibatch sampling is on, since
the sampler takes contiguous blocks. Each step is
:func:`~sparktorch_tpu_torch.train.step.train_step`.

Read-backs: the step losses come back to the host once per chunk of
``steps_per_call`` steps (default: up to 32), so the card is never
stalled by a per-step sync. With early stopping or a validation split
the host needs each step's signal before it may start the next step, so
then every step is read back — which makes the stop fire at exactly the
step the JAX package's stops at.

Records have the JAX package's keys: ``round, iter, loss, val_loss,
examples, grad_norm, step_time_s``. Not ported yet (ROADMAP, Queue 1):
several GPUs (``torch.distributed``), pipeline parallelism,
checkpoint/resume, and the gang, chaos, goodput, health and profiler
hooks.
"""

from __future__ import annotations

import copy
import dataclasses
import logging
import time
from typing import Any, NamedTuple, Optional, Union

import numpy as np
import torch

from sparktorch_tpu_torch.inference import _resolve_device
from sparktorch_tpu_torch.train.step import eval_step, train_step
from sparktorch_tpu_torch.utils.data import DataBatch, handle_features
from sparktorch_tpu_torch.utils.early_stopper import EarlyStopping
from sparktorch_tpu_torch.utils.metrics import MetricsRecorder
from sparktorch_tpu_torch.utils.serde import (
    ModelSpec,
    deserialize_model,
    meta_copy,
)

log = logging.getLogger("sparktorch_tpu_torch.train")


class TrainResult(NamedTuple):
    params: Any      # the trained state_dict, on the CPU
    metrics: list    # per-step record dicts
    spec: ModelSpec  # weight-free: the module on the meta device
    summary: Optional[dict] = None


def _shuffle_batch(batch: DataBatch, generator: torch.Generator) -> DataBatch:
    """On-device permutation of the resident rows between rounds."""
    perm = torch.randperm(batch.size, generator=generator,
                          device=batch.x.device)
    return DataBatch(*(a[perm] for a in batch))


def _resolve_steps_per_call(steps_per_call: Optional[int], default: int,
                            iters: int) -> int:
    """Chunk size between read-backs: ``steps_per_call`` or the default,
    at most ``iters``, and a divisor of ``iters``."""
    n = max(1, min(int(default if steps_per_call is None else steps_per_call),
                   iters))
    while iters % n:
        n -= 1
    return n


def train_distributed(
    torch_obj: Union[str, ModelSpec],
    data: Any,
    labels: Optional[np.ndarray] = None,
    iters: int = 10,
    partition_shuffles: int = 1,
    verbose: int = 0,
    mini_batch: Optional[int] = None,
    validation_pct: float = 0.0,
    early_stop_patience: int = -1,
    seed: int = 0,
    device=None,
    steps_per_call: Optional[int] = None,
) -> TrainResult:
    """Synchronous training of the packaged model on one device (CUDA
    unless ``device`` says otherwise; raises when there is no card and
    no device was asked for). ``data``/``labels`` as
    :func:`~sparktorch_tpu_torch.utils.data.handle_features` takes them;
    the other parameters as in the JAX package. ``mini_batch`` ≤ 0 or
    None trains on the full batch each step."""
    dev = _resolve_device(device)
    spec = deserialize_model(torch_obj)
    train_batch, val_batch = handle_features(data, labels, validation_pct,
                                             seed)
    if spec.input_shape is None:
        spec.input_shape = tuple(train_batch.x.shape[1:])
    train_batch = train_batch.to(dev)
    if val_batch is not None:
        val_batch = val_batch.to(dev)

    module = spec.make_module()
    if isinstance(torch_obj, ModelSpec) and spec.module is not None:
        module = copy.deepcopy(module)  # leave the caller's module as it is
    module = module.to(dev).train()
    optimizer = spec.make_optimizer(module.parameters())
    loss_fn = spec.loss_fn()

    stopper = (EarlyStopping(patience=early_stop_patience)
               if early_stop_patience is not None and early_stop_patience > 0
               else None)
    per_step = stopper is not None or val_batch is not None
    chunk = 1 if per_step else _resolve_steps_per_call(
        steps_per_call, min(iters, 32), iters)
    mini_batch = mini_batch if mini_batch is not None and mini_batch > 0 else None
    shuffle_gen = torch.Generator(device=dev).manual_seed(seed + 1)
    sample_gen = torch.Generator().manual_seed(seed)

    recorder = MetricsRecorder()
    for shuffle_round in range(max(1, partition_shuffles)):
        if shuffle_round > 0 or mini_batch is not None:
            train_batch = _shuffle_batch(train_batch, shuffle_gen)
        stop = False
        i = 0
        while i < iters and not stop:
            n = min(chunk, iters - i)
            t0 = time.perf_counter()
            steps = [train_step(module, loss_fn, optimizer, train_batch,
                                mini_batch, sample_gen) for _ in range(n)]
            # The chunk's one read-back: (n, 3) loss, examples, grad norm.
            host = torch.stack([torch.stack(m) for m in steps]).tolist()
            dt = (time.perf_counter() - t0) / n
            val_loss = (float(eval_step(module, loss_fn, val_batch))
                        if val_batch is not None else None)
            for loss, examples, gnorm in host:
                record = {
                    "round": shuffle_round,
                    "iter": i,
                    "loss": loss,
                    "val_loss": val_loss,
                    "examples": examples,
                    "grad_norm": gnorm,
                    "step_time_s": dt,
                }
                recorder.record(record)
                if verbose:
                    msg = (f"[sparktorch_tpu_torch] round {shuffle_round} "
                           f"iter {i} loss {loss:.6f}")
                    if val_loss is not None:
                        msg += f" val_loss {val_loss:.6f}"
                    log.info(msg)
                if stopper is not None and stopper.step(
                        val_loss if val_loss is not None else loss):
                    stop = True
                    break
                i += 1
        if stop:
            break

    params = {k: v.detach().cpu() for k, v in module.state_dict().items()}
    if spec.module is not None:
        spec = dataclasses.replace(spec, module=meta_copy(module))
    return TrainResult(params=params, metrics=recorder.records, spec=spec,
                       summary=recorder.summary())
