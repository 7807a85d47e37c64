"""The sharded trainer on a (dp 2, tp 2) mesh against the JAX package's.

A gloo world of 4 ranks builds ``MeshConfig(dp=2, tp=2)``: two batch
shards (ranks 0, 1 and ranks 2, 3, tp peers adjacent), each replicated
over dp, the tiny CausalLM split over tp. Three Adam steps and three SGD
steps of ``tests/test_torch_tp_train.py``, whose batch's weight-0 rows
fall unevenly over the batch shards (4 + 1 real rows), beside the JAX
``make_sharded_train_step`` on a JAX mesh of the same shape: losses,
global grad norms and parameters within 1e-4, health norms and SGD
parameters equal to the one-process step's (a gradient all-reduce over
the whole world would count each batch shard twice). A ``remat`` LM,
whose recomputed layers repeat their tp collectives in the backward,
takes the same SGD steps as one process (parameters within 1e-6). The
JAX steps compile while the ranks run.

The spawned ranks import this module, so the JAX package is imported
inside the functions that use it.
"""

import functools

import numpy as np

from test_torch_dp import start_world
from test_torch_sharded_train import jax_init, reference_run, sharded_run
from test_torch_tp_fsdp import lm_spec_with
from test_torch_tp_train import (
    OPTIMIZERS,
    check_against_jax,
    check_local_shards,
    jax_tp_sharded,
    tp_job,
)

AXES = {"dp": 2, "tp": 2}


def _remat_job(rank, init):
    """A remat LM under SGD against the one-process step."""
    from sparktorch_tpu_torch.convert import full_state_dict
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    def spec():
        return lm_spec_with("sgd", {"lr": 0.1}, remat=True)

    records, state, _ = sharded_run(build_mesh(MeshConfig(**AXES)), spec(),
                                    init)
    got = {k: v.numpy() for k, v in full_state_dict(state.module).items()}
    ref, want = reference_run(spec(), init)
    return ([float(m.loss) for m in records], [float(m.loss) for m in ref],
            got, want)


def _jobs(rank, init):
    out = tp_job(rank, AXES, init)
    out["remat"] = _remat_job(rank, init)
    return out


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


def test_ranks_fill_the_grid_with_tp_peers_adjacent():
    ranks, _ = _world()
    # (dp, fsdp, tp, batch_index, tp_rank) of ranks 0..3.
    assert [r["mesh"] for r in ranks] == [(2, 1, 2, 0, 0), (2, 1, 2, 0, 1),
                                          (2, 1, 2, 1, 0), (2, 1, 2, 1, 1)]


def test_dp2_tp2_adam_steps_match_the_jax_sharded_trainer():
    ranks, want = _world()
    check_against_jax(ranks, "adam", want["adam"])


def test_dp2_tp2_sgd_steps_match_the_jax_sharded_trainer_and_one_process():
    ranks, want = _world()
    check_against_jax(ranks, "sgd", want["sgd"])


def test_dp2_tp2_ranks_hold_their_shards():
    check_local_shards(_world()[0], 2)


def test_remat_layers_repeat_their_tp_collectives_in_order():
    for rank in _world()[0]:
        got_losses, want_losses, got, want = rank["remat"]
        np.testing.assert_allclose(got_losses, want_losses, rtol=1e-6,
                                   atol=1e-6)
        for key, value in got.items():
            np.testing.assert_allclose(value, want[key], rtol=1e-6,
                                       atol=1e-6, err_msg=key)
