"""Bitwise poison-batch replay — the port of ``sparktorch_tpu/obs/replay.py``.

``python -m sparktorch_tpu_torch.obs.replay bundle.json`` re-runs the
training step a health replay bundle recorded (see
:class:`~sparktorch_tpu_torch.obs.health.TrainHealthLedger`) and checks
that it reproduces the recorded bad numerics **bitwise**: which batch
broke the run, not which function.

A bundle is the JAX package's format: a ``.json`` meta file plus a
sibling ``.npz`` holding the pre-step state anchor and the offending
batch, leaf by leaf (``state_<i>``, ``batch_<i>``). The port's meta adds
``state_keys`` (the anchor's :func:`~sparktorch_tpu_torch.obs.health.
trainer_state` names, ``model.<name>`` and ``optim.<index>.<key>``) and
``deterministic`` (the recording process's
:func:`~sparktorch_tpu_torch.obs.health.determinism_settings`). The
bundle names a *builder*, ``"module:function"``, that rebuilds the step
in the replaying process and returns ``{"step_fn", "state", "batch"}``:
``state`` is the ``(module, optimizer)`` pair the anchor loads into,
``batch`` a :class:`~sparktorch_tpu_torch.utils.data.DataBatch` template
(its dtypes and device), and ``step_fn(state, batch) -> (state,
StepMetrics)`` one step with the health vector on. The replay then:

1. applies the recorded deterministic settings, before the first CUDA
   call (cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` at its start),
2. loads the anchor into the builder's module and optimizer and checks
   the state against the bundle's checksum (a replay against drifted
   parameters fails loudly),
3. runs ``step - anchor_step + 1`` steps (the anchor re-arms on every
   batch change, so the batch is constant over that range),
4. compares each recorded metric with the replayed one by its float32
   **bit pattern**, the only comparison under which two NaNs agree.

Exit code 0 iff every recorded metric reproduced bitwise. Builders for
the port: :func:`net_builder` (the JAX bench's health drill: ``Net``,
MSE, Adam) and :func:`lm_builder` (a causal LM of any width, as the GPU
smoke script's LM).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
from typing import Any, Dict, Mapping, Optional

import numpy as np

from sparktorch_tpu_torch.obs.health import (
    apply_determinism_settings,
    float_bits,
    load_trainer_state,
    trainer_state,
    tree_checksum,
)


def load_bundle(meta_path: str) -> Dict[str, Any]:
    """Read a replay bundle: the meta dict plus its npz arrays."""
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("kind") != "health_replay":
        raise ValueError(f"{meta_path}: not a health replay bundle "
                         f"(kind={meta.get('kind')!r})")
    npz_path = os.path.join(os.path.dirname(os.path.abspath(meta_path)),
                            meta["npz"])
    with np.load(npz_path) as z:
        arrays = {k: z[k] for k in z.files}
    return {"meta": meta, "arrays": arrays, "path": meta_path}


def resolve_builder(spec: str):
    """Import ``"module:function"`` and return the callable."""
    mod_name, sep, fn_name = spec.partition(":")
    if not sep or not fn_name:
        raise ValueError(f"builder must be 'module:function', got {spec!r}")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name, None)
    if fn is None:
        raise ValueError(f"builder {spec!r}: {mod_name} has no {fn_name}")
    return fn


def _step_fn(loss_fn, module):
    """``step_fn(state, batch)``: one full-batch train step of the
    ``(module, optimizer)`` pair with the health vector on."""
    from sparktorch_tpu_torch.train.step import health_buffer, train_step

    buf = health_buffer(module)

    def step_fn(state, batch):
        return state, train_step(state[0], loss_fn, state[1], batch,
                                 health_buf=buf)

    return step_fn


def _built(spec, rows: int, x_shape, x_dtype, y_shape, y_dtype,
           device) -> Dict[str, Any]:
    """A builder's result for a model spec: the trainer's own module,
    optimizer and loss (``train/sync.py``'s set-up, so the optimizer is
    configured exactly as in the run) and a batch template."""
    import torch

    from sparktorch_tpu_torch.inference import _resolve_device
    from sparktorch_tpu_torch.train.sync import _build_trainer
    from sparktorch_tpu_torch.utils.data import DataBatch

    dev = _resolve_device(device)
    module, optimizer, loss_fn = _build_trainer(spec, spec, dev)
    batch = DataBatch(
        torch.zeros((rows, *x_shape), dtype=x_dtype, device=dev),
        torch.zeros((rows, *y_shape), dtype=y_dtype, device=dev),
        torch.ones((rows,), dtype=torch.float32, device=dev))
    return {"step_fn": _step_fn(loss_fn, module),
            "state": (module, optimizer),
            "batch": batch}


def net_builder(n_features: int = 10, rows: int = 256,
                device: Optional[str] = None) -> Dict[str, Any]:
    """Builder of the JAX bench's health drill (its
    ``_health_replay_builder``): :class:`~sparktorch_tpu_torch.models.Net`
    (``n_features`` → 20 → 1), MSE, Adam at 1e-2, a full batch of
    ``rows`` rows."""
    import torch

    from sparktorch_tpu_torch.models import Net
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    spec = ModelSpec(module=Net(in_features=n_features), loss="mse",
                     optimizer="adam", optimizer_params={"lr": 1e-2},
                     input_shape=(n_features,))
    return _built(spec, rows, (n_features,), torch.float32, (),
                  torch.float32, device)


def lm_builder(rows: int, seq: int, lr: float = 3e-4,
               device: Optional[str] = None, **config) -> Dict[str, Any]:
    """Builder of a causal LM (``config`` the
    :class:`~sparktorch_tpu_torch.models.transformer.TransformerConfig`
    fields, e.g. the GPU smoke script's d 512, 8 heads, 4 layers, vocab
    32,768) under AdamW at ``lr`` with cross-entropy, on ``rows`` rows of
    ``seq`` float token ids and int64 next-token labels."""
    import torch

    from sparktorch_tpu_torch.inference import _resolve_device
    from sparktorch_tpu_torch.models import CausalLM
    from sparktorch_tpu_torch.models.transformer import TransformerConfig
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    # Allocated on the device, uninitialized: every weight is the
    # bundle's (an init of the full-width LM on the host takes seconds).
    with torch.device("meta"):
        module = CausalLM(TransformerConfig(**config))
    module = module.to_empty(device=_resolve_device(device))
    spec = ModelSpec(module=module, loss="cross_entropy", optimizer="adamw",
                     optimizer_params={"lr": lr})
    return _built(spec, rows, (seq,), torch.float32, (seq,), torch.int64,
                  device)


def _rebuild_batch(template, arrays: Mapping[str, np.ndarray], n: int):
    import torch

    leaves = list(template)
    if len(leaves) != n:
        raise ValueError(
            f"bundle has {n} batch leaves but the builder's template has "
            f"{len(leaves)} — wrong builder for this bundle")
    out = []
    for i, tmpl in enumerate(leaves):
        # The recorded dtype stands; the template gives the device.
        a = torch.from_numpy(np.asarray(arrays[f"batch_{i}"]))
        if tmpl.dtype == torch.bfloat16 and a.dtype == torch.int16:
            a = a.view(torch.bfloat16)
        out.append(a.to(tmpl.device))
    return type(template)(*out)


def _metric_values(metrics: Any) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for name in ("loss", "grad_norm"):
        v = getattr(metrics, name, None)
        if v is not None:
            out[name] = float(v)
    health = getattr(metrics, "health", None)
    if health is not None:
        for name in ("finite", "update_ratio"):
            v = getattr(health, name, None)
            if v is not None:
                out[name] = float(v)
    return out


def replay_bundle(bundle: Any, builder: Optional[str] = None
                  ) -> Dict[str, Any]:
    """Replay a bundle (path or the dict from :func:`load_bundle`).

    Returns ``{"match": bool, "steps_run": n, "compared": {name:
    {"recorded_bits", "replayed_bits", "recorded", "replayed",
    "match"}}}``."""
    if isinstance(bundle, str):
        bundle = load_bundle(bundle)
    meta, arrays = bundle["meta"], bundle["arrays"]
    if meta.get("deterministic"):
        apply_determinism_settings(meta["deterministic"])
    builder_spec = builder or meta.get("builder")
    if not builder_spec:
        raise ValueError(
            "bundle names no builder — pass --builder module:function")
    build = resolve_builder(builder_spec)
    built = build(**(meta.get("builder_kwargs") or {}))
    step_fn = built["step_fn"]
    module, optimizer = built["state"]
    n_state = int(meta["n_state_leaves"])
    keys = meta.get("state_keys")
    if not keys or len(keys) != n_state:
        raise ValueError(f"bundle has {n_state} state leaves and "
                         f"{len(keys or [])} state keys")
    load_trainer_state(module, optimizer,
                       {k: arrays[f"state_{i}"] for i, k in enumerate(keys)})
    checksum = tree_checksum(trainer_state(module, optimizer))
    if checksum != meta["param_checksum"]:
        raise ValueError(
            f"param checksum mismatch: bundle {meta['param_checksum']} vs "
            f"rebuilt state {checksum} — the anchor did not survive the "
            f"round trip")
    batch = _rebuild_batch(built["batch"], arrays,
                           int(meta["n_batch_leaves"]))
    n_steps = int(meta["step"]) - int(meta["anchor_step"]) + 1
    if n_steps < 1:
        raise ValueError(f"bad step range: anchor {meta['anchor_step']} "
                         f"> step {meta['step']}")
    state, metrics = (module, optimizer), None
    for _ in range(n_steps):
        state, metrics = step_fn(state, batch)
    replayed = _metric_values(metrics)
    compared: Dict[str, Any] = {}
    ok = True
    for name, rec in (meta.get("bad") or {}).items():
        if name not in replayed:
            compared[name] = {"match": False, "replayed": None,
                              "recorded": rec.get("value"),
                              "recorded_bits": rec["bits"],
                              "replayed_bits": None}
            ok = False
            continue
        rbits = float_bits(replayed[name])
        match = rbits == int(rec["bits"])
        compared[name] = {
            "recorded": rec.get("value"), "replayed": replayed[name],
            "recorded_bits": int(rec["bits"]), "replayed_bits": rbits,
            "match": match,
        }
        ok = ok and match
    return {"match": ok, "steps_run": n_steps, "compared": compared,
            "step": int(meta["step"]), "akind": meta.get("akind"),
            "rank": meta.get("rank")}


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sparktorch_tpu_torch.obs.replay",
        description="Re-run the step a health replay bundle recorded and "
                    "verify the bad numerics reproduce bitwise.")
    ap.add_argument("bundle", help="path to the bundle .json")
    ap.add_argument("--builder", default=None,
                    help="module:function overriding the bundle's builder")
    args = ap.parse_args(argv)
    bundle = load_bundle(args.bundle)
    meta = bundle["meta"]
    print(f"replay bundle: step {meta['step']} (anchor "
          f"{meta['anchor_step']}) rank {meta['rank']} "
          f"akind={meta.get('akind')}")
    result = replay_bundle(bundle, builder=args.builder)
    for name, cmp_ in sorted(result["compared"].items()):
        mark = "ok " if cmp_["match"] else "FAIL"
        print(f"  [{mark}] {name}: recorded bits "
              f"0x{cmp_['recorded_bits']:08x} ({cmp_['recorded']}) vs "
              f"replayed "
              + (f"0x{cmp_['replayed_bits']:08x} ({cmp_['replayed']})"
                 if cmp_["replayed_bits"] is not None else "<absent>"))
    verdict = "bitwise reproduction" if result["match"] else "MISMATCH"
    print(f"replay: {verdict} over {result['steps_run']} step(s)")
    return 0 if result["match"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
