"""Every trainer's batch over a 1 × 2 (dp, fsdp) mesh, against the JAX package.

A gloo world of 2 ranks (``tests/test_torch_dp.py``'s seeded spawn
helper) builds ``MeshConfig(fsdp=2)``. In it
``train_distributed``, ``SparkTorch.setMesh(MeshConfig(fsdp=2))``,
``train_distributed_multihost`` and ``train_distributed_streaming``
(rank 0 writing the snapshots) split the batch over dp × fsdp with the
parameters replicated and match the JAX trainers on a 2-device (dp 1,
fsdp 2) mesh within 1e-5; a ``BatchPredictor`` over the mesh gives
every row. The JAX programs compile while the ranks run
(``tests/test_torch_sharded_optim.py`` runs the sharded trainer on this
mesh).

The spawned ranks import this module, so the JAX package is imported
inside the functions that use it.
"""

import functools
import os
import shutil
import tempfile

import numpy as np
import torch

from test_torch_dp import _mnist, _packages, start_world

ROWS, DATA_SEED, STREAM_CHUNK = 40, 5, 23


def _trainer_jobs(rank, mesh, obj, x, y, snapshots):
    """train_distributed, the estimator, multihost, BatchPredictor and
    the streaming trainer over the mesh."""
    import sparktorch_tpu_torch as port
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig
    from sparktorch_tpu_torch.train.sync import (
        train_distributed,
        train_distributed_multihost,
        train_distributed_streaming,
    )
    from sparktorch_tpu_torch.utils.checkpoint import latest_step
    from sparktorch_tpu_torch.utils.serde import deserialize_model

    out = {}
    fit = train_distributed(obj, x, labels=y, mesh=mesh, iters=5,
                            device="cpu")
    out["fit"] = (fit.metrics, {k: v.numpy() for k, v in fit.params.items()})
    est = port.SparkTorch(inputCol="features", labelCol="label",
                          torchObj=obj, iters=5, device="cpu").setMesh(
                              MeshConfig(fsdp=2))
    est.fit({"features": list(x), "label": y.astype(np.float32)})
    out["estimator"] = [m["loss"] for m in est._last_metrics]
    part = np.array_split(np.arange(len(x)), 2)[rank]
    multi = train_distributed_multihost(obj, x[part], y[part], mesh=mesh,
                                        iters=5, device="cpu")
    out["multihost"] = [m["loss"] for m in multi.metrics]
    module = deserialize_model(obj).make_module()
    module.load_state_dict(fit.params)
    pred = BatchPredictor(module, chunk=16, mesh=mesh, device="cpu")
    out["predict"] = pred.predict(x[:37])
    stream = train_distributed_streaming(
        obj, (x, y), mesh=mesh, chunk_rows=STREAM_CHUNK, epochs=2,
        device="cpu", checkpoint_dir=snapshots, checkpoint_every=2)
    out["streaming"] = (stream.metrics,
                        {k: v.numpy() for k, v in stream.params.items()},
                        latest_step(snapshots))
    return out


def _jobs(rank, mlp):
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    return _trainer_jobs(rank, build_mesh(MeshConfig(fsdp=2)), *mlp)


def _jax_trainers(jax_obj, x, y):
    """The JAX trainers over a (dp 1, fsdp 2) mesh on the MLP job."""
    import jax
    from sparktorch_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from sparktorch_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from sparktorch_tpu.train.sync import train_distributed as jax_train
    from sparktorch_tpu.train.sync import (
        train_distributed_streaming as jax_streaming,
    )

    mesh = jax_build_mesh(JaxMeshConfig(dp=1, fsdp=2), jax.devices()[:2])
    fit = jax_train(jax_obj, x, labels=y, iters=5, seed=0, mesh=mesh)
    stream = jax_streaming(jax_obj, (x, y), mesh=mesh,
                           chunk_rows=STREAM_CHUNK, epochs=2)
    return fit, stream


@functools.lru_cache(maxsize=None)
def _world():
    from sparktorch_tpu_torch.convert import state_dict_from_flax

    x, y = _mnist(ROWS, DATA_SEED)
    jax_obj, obj, model = _packages("mlp", x, "sgd", 0.1)
    snapshots = tempfile.mkdtemp()
    try:
        join = start_world(2, _jobs, (obj, x, y, snapshots))
        want = {}
        try:
            for name, result in zip(("fit", "streaming"),
                                    _jax_trainers(jax_obj, x, y)):
                params = state_dict_from_flax(result.params, model)
                want[name] = (result.metrics,
                              {k: v.numpy() for k, v in params.items()})
        finally:
            ranks = join()
        files = sorted(os.listdir(snapshots))
    finally:
        shutil.rmtree(snapshots, ignore_errors=True)
    return ranks, want, files


def test_train_distributed_splits_the_batch_over_dp_and_fsdp():
    ranks, want, _ = _world()
    want_metrics, want_params = want["fit"]
    for rank in ranks:
        metrics, params = rank["fit"]
        for key in ("loss", "grad_norm", "examples"):
            np.testing.assert_allclose([m[key] for m in metrics],
                                       [m[key] for m in want_metrics],
                                       rtol=1e-5, atol=1e-5, err_msg=key)
        for key, value in params.items():
            np.testing.assert_allclose(value, want_params[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
        # The estimator's setMesh(MeshConfig(fsdp=2)) and each rank's
        # own partition train the same steps.
        np.testing.assert_allclose(rank["estimator"],
                                   [m["loss"] for m in metrics], rtol=1e-6)
        np.testing.assert_allclose(rank["multihost"],
                                   [m["loss"] for m in metrics], rtol=1e-5)


def test_batch_predictor_over_a_dp_fsdp_mesh_gives_every_row():
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.utils.serde import deserialize_model

    ranks, _, _ = _world()
    x, _ = _mnist(ROWS, DATA_SEED)
    obj = _packages("mlp", x, "sgd", 0.1)[1]
    module = deserialize_model(obj).make_module()
    module.load_state_dict({k: torch.from_numpy(v)
                            for k, v in ranks[0]["fit"][1].items()})
    want = BatchPredictor(module, chunk=16, device="cpu").predict(x[:37])
    for rank in ranks:
        assert rank["predict"].shape == (37, 10)
        np.testing.assert_allclose(rank["predict"], want, rtol=1e-5,
                                   atol=1e-6)


def test_streaming_over_a_dp_fsdp_world_matches_the_jax_mesh():
    # 40 rows in chunks of 23 rounded up to 24 (a multiple of the two
    # batch shards): 24 and a ragged 16, two epochs; rank 0 alone writes
    # the snapshots (every 2 steps; the last is the final one).
    ranks, want, files = _world()
    want_metrics, want_params = want["streaming"]
    for rank in ranks:
        metrics, params, latest = rank["streaming"]
        assert [m["examples"] for m in metrics] == [24.0, 16.0] * 2
        np.testing.assert_allclose([m["loss"] for m in metrics],
                                   [m["loss"] for m in want_metrics],
                                   rtol=1e-5, atol=1e-5)
        for key, value in params.items():
            np.testing.assert_allclose(value, want_params[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)
        assert latest == 4
    assert files == ["2", "4"]
