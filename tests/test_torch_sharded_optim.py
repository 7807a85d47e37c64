"""The sharded trainer and its optimizers on a 1 × 2 (dp, fsdp) mesh.

A gloo world of 2 ranks (``tests/test_torch_dp.py``'s seeded spawn
helper) builds ``MeshConfig(fsdp=2)`` and takes three sharded steps of
``tests/test_torch_sharded_train.py``'s tiny CausalLM on its batch,
whose weight-0 rows fall unevenly over the two shards (4 + 1 real
rows): with Adam beside the JAX ``make_sharded_train_step`` on a (dp 1,
fsdp 2) mesh, losses, global grad norms and parameters within 1e-4
(the JAX step compiles while the ranks run); then with each optimizer.
Every optimizer but Adafactor steps as the one-process step on
the whole batch does (which ``tests/test_torch_optim.py`` holds to
optax): losses within 1e-5 relative, parameters within 1e-5. That takes
in the coupled ones: Lamb's per-tensor trust ratio reads the global
norms of the sharded leaves. Adafactor's factored moments over DTensor
shards are not ported, so it raises there.
"""

import functools

import numpy as np
import pytest

from test_torch_dp import start_world
from test_torch_sharded_train import (
    SHAPES,
    check_against_jax,
    check_placements,
    comparable,
    jax_init,
    jax_sharded,
    lm_spec,
    reference_run,
    sharded_job,
    sharded_run,
)

OPTIMIZERS = [("sgd", {"lr": 0.1}), ("adam", {"lr": 1e-2}),
              ("adamw", {"lr": 1e-2}), ("rmsprop", {"lr": 1e-3}),
              ("adagrad", {"lr": 1e-2}), ("lion", {"lr": 1e-3}),
              ("lamb", {"lr": 1e-2})]


def _optimizer_job(rank, init):
    """Each optimizer: 3 sharded steps against the one-process step on
    the whole batch (rank 0 keeps both)."""
    from sparktorch_tpu_torch.convert import full_state_dict
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from sparktorch_tpu_torch.train.sharded import create_sharded_state

    mesh = build_mesh(MeshConfig(fsdp=2))
    out = {}
    for name, params in OPTIMIZERS:
        records, state, _ = sharded_run(mesh, lm_spec(name, params), init)
        got = {k: v.numpy() for k, v in full_state_dict(state.module).items()}
        if rank == 0:
            ref, want = reference_run(lm_spec(name, params), init)
            out[name] = ([float(m.loss) for m in records],
                         [float(m.loss) for m in ref], got, want)
    try:
        create_sharded_state(lm_spec("adafactor", {}), mesh, device="cpu")
        out["adafactor"] = None
    except NotImplementedError as e:
        out["adafactor"] = str(e)
    return out


def _jobs(rank, init):
    return {"sharded": sharded_job(rank, 2, init),
            "optimizers": _optimizer_job(rank, init)}


@functools.lru_cache(maxsize=None)
def _world():
    init = jax_init()
    join = start_world(2, _jobs, init)
    try:
        want = jax_sharded(SHAPES[2], init)
    finally:
        ranks = join()
    return ranks, want


def test_sharded_steps_match_the_jax_sharded_trainer():
    ranks, want = _world()
    check_against_jax([r["sharded"] for r in ranks], want)


def test_fsdp_leaves_are_dtensor_shards_of_their_rule():
    check_placements(_world()[0][0]["sharded"])


@pytest.mark.parametrize("name", [n for n, _ in OPTIMIZERS])
def test_optimizers_step_the_fsdp_shards_as_one_process_does(name):
    got_losses, want_losses, got, want = _world()[0][0]["optimizers"][name]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5, atol=1e-6)
    for key, value in got.items():
        np.testing.assert_allclose(comparable(key, value),
                                   comparable(key, want[key]), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


def test_adafactor_raises_on_fsdp_shards():
    msg = _world()[0][0]["optimizers"]["adafactor"]
    assert msg is not None and "ROADMAP" in msg
