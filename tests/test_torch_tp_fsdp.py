"""The sharded trainer on a (fsdp 2, tp 2) mesh against the JAX package's.

A gloo world of 4 ranks builds ``MeshConfig(fsdp=2, tp=2)``: FSDP2 over
the fsdp sub-mesh of each tp coordinate on top of the tp layout (the
embedding split by vocabulary over tp and by model dimension over fsdp).
Three Adam steps and three SGD steps of ``tests/test_torch_tp_train.py``
(weight-0 rows falling unevenly: 4 + 1 real rows) beside the JAX
``make_sharded_train_step`` on a JAX mesh of the same shape: losses,
global grad norms and parameters within 1e-4. Then Lamb, whose trust
ratio must read the global norms of leaves split over fsdp, tp and both,
against the one-process step on the whole batch (losses within 1e-5
relative, parameters within 1e-5). Adafactor raises on the split leaves.
The JAX steps compile while the ranks run.

The spawned ranks import this module, so the JAX package is imported
inside the functions that use it.
"""

import functools

import numpy as np

from test_torch_dp import start_world
from test_torch_sharded_train import (
    LM,
    comparable,
    jax_init,
    reference_run,
    sharded_run,
)
from test_torch_tp_train import (
    OPTIMIZERS,
    check_against_jax,
    check_local_shards,
    jax_tp_sharded,
    tp_job,
)

AXES = {"fsdp": 2, "tp": 2}


def lm_spec_with(optimizer, params, **cfg):
    from sparktorch_tpu_torch.models import transformer as torch_tf
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    return ModelSpec(module=torch_tf.CausalLM(torch_tf.TransformerConfig(
        **dict(LM, **cfg))), loss="cross_entropy", optimizer=optimizer,
        optimizer_params=params)


def _one_process_job(rank, init):
    """Lamb against the one-process step; Adafactor's refusal."""
    from sparktorch_tpu_torch.convert import full_state_dict
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu_torch.train.sharded import create_sharded_state

    mesh = build_mesh(MeshConfig(**AXES))
    out = {}
    for key, spec in (("lamb", lambda: lm_spec_with("lamb", {"lr": 1e-2})),):
        records, state, _ = sharded_run(mesh, spec(), init)
        got = {k: v.numpy() for k, v in full_state_dict(state.module).items()}
        ref, want = reference_run(spec(), init)
        out[key] = ([float(m.loss) for m in records],
                    [float(m.loss) for m in ref], got, want)
    try:
        create_sharded_state(lm_spec_with("adafactor", {}), mesh, device="cpu")
        out["adafactor"] = None
    except NotImplementedError as e:
        out["adafactor"] = str(e)
    return out


def _jobs(rank, init):
    return {"tp": tp_job(rank, AXES, init),
            "one_process": _one_process_job(rank, init)}


@functools.lru_cache(maxsize=None)
def _world():
    init = jax_init()
    join = start_world(4, _jobs, init)
    want = {}
    try:
        for name, params in OPTIMIZERS:
            want[name] = jax_tp_sharded(AXES, init, name, params)
    finally:
        ranks = join()
    return ranks, want


def test_fsdp2_tp2_adam_steps_match_the_jax_sharded_trainer():
    ranks, want = _world()
    assert [r["tp"]["mesh"][3:] for r in ranks] == [(0, 0), (0, 1), (1, 0),
                                                     (1, 1)]
    check_against_jax([r["tp"] for r in ranks], "adam", want["adam"])


def test_fsdp2_tp2_sgd_steps_match_the_jax_sharded_trainer_and_one_process():
    ranks, want = _world()
    check_against_jax([r["tp"] for r in ranks], "sgd", want["sgd"])


def test_fsdp2_tp2_embedding_is_split_over_tp_and_fsdp():
    ranks, _ = _world()
    first = ranks[0]["tp"]
    assert first["shardings"]["backbone.tok_embed.weight"] == ("tp", "fsdp")
    # tp shards of (V/tp, d), each an fsdp shard of (V/tp, d/fsdp) here.
    v, d = LM["vocab_size"], LM["d_model"]
    assert first["local"]["backbone.tok_embed.weight"].shape == (v // 2,
                                                                 d // 2)
    check_local_shards([r["tp"] for r in ranks], 2)


def test_lamb_reads_the_global_norms_of_split_leaves():
    got_losses, want_losses, got, want = _world()[0][0]["one_process"]["lamb"]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-6)
    for key, value in got.items():
        np.testing.assert_allclose(comparable(key, value),
                                   comparable(key, want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_adafactor_raises_on_split_leaves():
    msg = _world()[0][0]["one_process"]["adafactor"]
    assert msg is not None and "ROADMAP" in msg and "tp" in msg
