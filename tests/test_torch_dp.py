"""Data-parallel training over a ``torch.distributed`` world against the JAX package's N-device mesh.

Worlds of 2 and 4 processes run under ``gloo`` on the CPU, spawned on a
free port; each rank trains its shard with the port's trainer
(``train_distributed(mesh=build_mesh())``) and the JAX package trains
the same numpy data from the same initial weights with
``train_distributed(mesh=build_mesh(MeshConfig(), jax.devices()[:N]))``,
both full batch. Every world runs once (all its fits in the same
processes) and the tests read its results. The spawned ranks import this
module, so the JAX package is imported inside the functions that use it.
"""

import functools
import multiprocessing as mp
import os
import shutil
import socket
import tempfile
import time
import traceback

import numpy as np
import pytest
import torch

import sparktorch_tpu_torch as port
from sparktorch_tpu_torch.models import resnet as torch_resnet
from sparktorch_tpu_torch.models import simple as torch_simple
from sparktorch_tpu_torch.parallel.mesh import Mesh, MeshConfig, build_mesh

JOIN_S = 180
TINY_RESNET = dict(stage_sizes=(1, 1), num_classes=3, width=4)
# A top-2 MoE LM (tests/test_torch_moe.py's): groups of 24 tokens cut
# across a shard's rows, so each rank routes its own shard, as each
# device of the JAX mesh does.
MOE_LM = dict(vocab_size=128, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_len=32, n_experts=4, moe_every=2, dtype="float32",
              moe_group_size=24, moe_top_k=2)
# Uneven partitions of 37 rows, one empty, for each world.
PARTS = {2: (0, 37), 4: (10, 0, 3, 24)}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port_no, queue, fn, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port_no}",
                            rank=rank, world_size=world)
    try:
        queue.put((rank, True, fn(rank, *args)))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


def start_world(world, fn, *args):
    """Spawn :func:`run_world`'s world and return, without waiting, the
    function that waits for it and gives :func:`run_world`'s result."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port_no = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port_no, queue, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    return functools.partial(_join_world, world, procs, queue)


def run_world(world, fn, *args):
    """``fn(rank, *args)`` on every rank of a spawned gloo world; the
    ranks' results in rank order. Fails (and ends the world) when a rank
    raises or a rank gives no result within ``JOIN_S`` seconds."""
    return start_world(world, fn, *args)()


def _join_world(world, procs, queue):
    results, failed = {}, None
    try:
        for _ in range(world):
            rank, ok, payload = queue.get(timeout=JOIN_S)
            if not ok:
                failed = f"rank {rank} raised:\n{payload}"
                break
            results[rank] = payload
    finally:
        for p in procs:
            if failed is not None:
                p.terminate()
            p.join(timeout=JOIN_S)
            if p.is_alive():
                p.kill()
                failed = failed or f"a rank did not exit within {JOIN_S} s"
    if failed is not None:
        pytest.fail(failed)
    return [results[r] for r in range(world)]


def _mnist(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 784)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _pair(kind, x):
    """The JAX module and the port's module holding the params the JAX
    trainer initialises for seed 0."""
    import jax
    import jax.numpy as jnp
    from sparktorch_tpu.models import resnet as jax_resnet
    from sparktorch_tpu.models import simple as jax_simple

    from sparktorch_tpu_torch.convert import state_dict_from_flax

    if kind == "mlp":
        jax_model, model = jax_simple.MnistMLP(), torch_simple.MnistMLP()
    elif kind == "moe":
        from sparktorch_tpu.models import transformer as jax_tf

        from sparktorch_tpu_torch.models import transformer as torch_tf

        jax_model = jax_tf.CausalLM(jax_tf.TransformerConfig(**MOE_LM))
        model = torch_tf.CausalLM(torch_tf.TransformerConfig(**MOE_LM))
    else:
        jax_model = jax_resnet.ResNet(block_cls=jax_resnet.ResNetBlock,
                                      compute_dtype=jnp.float32,
                                      **TINY_RESNET)
        model = torch_resnet.ResNet(block_cls=torch_resnet.ResNetBlock,
                                    compute_dtype="float32", **TINY_RESNET)
    variables = jax.device_get(jax_model.init(jax.random.key(0),
                                              jnp.asarray(x[:1])))
    model.load_state_dict(state_dict_from_flax(variables, model))
    return jax_model, model


def _packages(kind, x, optimizer, lr):
    import sparktorch_tpu as jax_pkg

    jax_model, model = _pair(kind, x)
    kw = dict(criterion="cross_entropy", optimizer=optimizer,
              optimizer_params={"lr": lr})
    if kind == "mlp":
        kw["input_shape"] = (784,)
    return (jax_pkg.serialize_torch_obj(jax_model, **kw),
            port.serialize_torch_obj(model, **kw), model)


# name: (model, optimizer, lr, rows, data seed, worlds, extra fit args)
JOBS = {
    "sgd": ("mlp", "sgd", 0.1, 64, 0, (2, 4), {}),
    "adam": ("mlp", "adam", 1e-3, 64, 0, (2, 4), {}),
    "ragged": ("mlp", "sgd", 0.1, 37, 1, (2, 4), {"validation_pct": 0.25}),
    "multihost": ("mlp", "sgd", 0.1, 37, 2, (2, 4), {}),
    "resnet": ("resnet", "sgd", 0.1, 16, 6, (2,), {}),
    "estimator": ("mlp", "adam", 1e-3, 64, 0, (2,), {}),
    "checkpoint": ("mlp", "adam", 1e-3, 64, 0, (2,), {}),
    "streaming": ("mlp", "sgd", 0.1, 64, 0, (2,), {}),
    "bench": ("mlp", "adam", 1e-3, 64, 0, (2,), {}),
    # 6 rows: 3 a rank; 5 rows: the second rank's third row is a weight-0
    # pad, masked out of its routing.
    "moe": ("moe", "adamw", 3e-3, 6, 3, (2,), {}),
    "moe_ragged": ("moe", "sgd", 0.5, 5, 4, (2,), {}),
}


def _data(name):
    kind, _, _, n, seed, _, _ = JOBS[name]
    if kind == "mlp":
        return _mnist(n, seed)
    if kind == "moe":
        ids = np.random.default_rng(seed).integers(0, 128, (n, 17))
        return ids[:, :-1].astype(np.float32), ids[:, 1:].astype(np.int32)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 8, 8, 3)).astype(np.float32),
            rng.integers(0, 3, n).astype(np.int32))


def _fit_jobs(rank, world, jobs):
    """Every job of this world on this rank: (step records, params)."""
    from sparktorch_tpu_torch.train.sync import (
        train_distributed,
        train_distributed_multihost,
        train_distributed_streaming,
    )

    out = {}
    for name, (obj, x, y, kw) in jobs.items():
        if name == "multihost":
            cuts = np.cumsum((0,) + PARTS[world])
            part = slice(cuts[rank], cuts[rank + 1])
            result = train_distributed_multihost(
                obj, x[part], y[part], iters=5, device="cpu", **kw)
            metrics, params = result.metrics, result.params
        elif name == "checkpoint":
            # 4 steps with a snapshot every 2, then 2 more resumed from
            # the newest, against 6 straight steps.
            fit = functools.partial(train_distributed, obj, x, labels=y,
                                    device="cpu", mesh=build_mesh())
            straight = fit(iters=6)
            fit(iters=4, checkpoint_every=2, **kw)
            resumed = fit(iters=2, resume=True, **kw)
            from sparktorch_tpu_torch.utils.checkpoint import latest_step

            out[name] = (kw["checkpoint_dir"],
                         latest_step(kw["checkpoint_dir"]),
                         {k: v.numpy() for k, v in straight.params.items()},
                         {k: v.numpy() for k, v in resumed.params.items()})
            continue
        elif name == "streaming":
            result = train_distributed_streaming(obj, (x, y), chunk_rows=24,
                                                 epochs=2, device="cpu")
            metrics, params = result.metrics, result.params
        elif name == "bench":
            # Rank 1's clock runs 3x fast: left to itself it would stop
            # growing the harness's long span before rank 0 does.
            from sparktorch_tpu_torch import bench
            from sparktorch_tpu_torch.utils.serde import deserialize_model

            real = time.perf_counter
            if rank == 1:
                time.perf_counter = lambda: 3 * real()
            try:
                out[name] = bench._sync_epoch_bench(
                    deserialize_model(obj), x, y, len(x), iters=5, repeats=2,
                    device="cpu")
            finally:
                time.perf_counter = real
            continue
        elif name == "estimator":
            est = port.SparkTorch(inputCol="features", labelCol="label",
                                  torchObj=obj, iters=5, device="cpu",
                                  mesh=build_mesh())
            fitted = est.fit({"features": list(x),
                              "label": y.astype(np.float32)})
            metrics, params = est._last_metrics, fitted.getModel().params
        else:
            result = train_distributed(obj, x, labels=y, device="cpu",
                                       mesh=build_mesh(), iters=5, **kw)
            metrics, params = result.metrics, result.params
        out[name] = (metrics, {k: v.numpy() for k, v in params.items()})
    return out


@functools.lru_cache(maxsize=None)
def _world(world):
    """Run every job of a world of ``world`` ranks once."""
    jobs = {}
    for name, (kind, opt, lr, _, _, worlds, kw) in JOBS.items():
        if world in worlds:
            x, y = _data(name)
            if name == "checkpoint":
                kw = dict(kw, checkpoint_dir=tempfile.mkdtemp())
            jobs[name] = (_packages(kind, x, opt, lr)[1], x, y, kw)
    return run_world(world, _fit_jobs, world, jobs)


@functools.lru_cache(maxsize=None)
def _jax_fit(name, world):
    """The JAX package's fit of job ``name`` on a ``world``-device mesh."""
    import jax
    from sparktorch_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from sparktorch_tpu.parallel.mesh import build_mesh as jax_build_mesh
    from sparktorch_tpu.train.sync import train_distributed as jax_train

    from sparktorch_tpu_torch.convert import state_dict_from_flax

    kind, opt, lr, _, _, _, kw = JOBS[name]
    x, y = _data(name)
    jax_obj, _, model = _packages(kind, x, opt, lr)
    mesh = jax_build_mesh(JaxMeshConfig(), jax.devices()[:world])
    want = jax_train(jax_obj, x, labels=y, iters=5, seed=0, mesh=mesh, **kw)
    params = state_dict_from_flax(
        {"params": want.params, **jax.device_get(want.model_state)}, model)
    return want.metrics, {k: v.numpy() for k, v in params.items()}


def _comparable(key, value):
    """The key third of the qkv bias has a zero gradient in exact
    arithmetic, so AdamW steps on each package's rounding noise there
    (tests/test_torch_train_sync.py): that third is left out."""
    if key.endswith("attn.qkv.bias"):
        return value.reshape(3, -1)[[0, 2]]
    return value


def _check(name, world, keys, tol):
    ranks = _world(world)
    want_metrics, want_params = _jax_fit(name, world)
    got_metrics, got_params = ranks[0][name]
    for other in ranks[1:]:  # every rank holds the same replica
        for key, value in other[name][1].items():
            np.testing.assert_array_equal(value, got_params[key], err_msg=key)
        assert [m["loss"] for m in other[name][0]] == [
            m["loss"] for m in got_metrics]
    assert len(got_metrics) == len(want_metrics) == 5
    for key in keys:
        np.testing.assert_allclose([m[key] for m in got_metrics],
                                   [m[key] for m in want_metrics],
                                   atol=tol, rtol=tol, err_msg=key)
    assert set(got_params) == set(want_params)
    for key, value in got_params.items():
        np.testing.assert_allclose(_comparable(key, value),
                                   _comparable(key, want_params[key]),
                                   atol=tol, rtol=tol, err_msg=key)
    return got_params


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name,tol", [("sgd", 1e-5), ("adam", 1e-4)])
def test_mlp_steps_match_the_jax_mesh(name, tol, world):
    _check(name, world, ("loss", "grad_norm", "examples"), tol)


@pytest.mark.parametrize("name,tol", [("moe", 1e-4), ("moe_ragged", 1e-5)])
def test_moe_lm_steps_match_the_jax_mesh(name, tol):
    # Each rank routes its shard; the aux losses enter the one
    # all-reduce scaled by each rank's weight sum, and the drop counts
    # ride in it: the losses, the drop fractions and the parameters are
    # the JAX 2-device mesh's.
    _check(name, 2, ("loss", "grad_norm", "examples"), tol)
    got = [m["moe_drop_fraction"] for m in _world(2)[0][name][0]]
    want = [m["moe_drop_fraction"] for m in _jax_fit(name, 2)[0]]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("world", [2, 4])
def test_rows_not_divisible_by_the_world_pad_exactly(world):
    # 37 rows, a quarter split off for validation: the train and the
    # validation rows both pad to a multiple of the world with weight-0
    # rows, and the losses are the global weighted means.
    _check("ragged", world, ("loss", "val_loss", "grad_norm", "examples"),
           1e-5)
    got = _world(world)[0]["ragged"][0]
    assert [m["examples"] for m in got] == [28.0] * 5


def test_batchnorm_running_statistics_are_averaged_like_the_pmean():
    # Even shards (8 rows a rank): each rank normalises by its shard's
    # statistics, as each device of the JAX mesh does, and the running
    # statistics are averaged over the ranks.
    params = _check("resnet", 2, ("loss", "grad_norm"), 1e-5)
    moved = [k for k, v in params.items()
             if k.endswith("running_var") and not np.allclose(v, 1.0)]
    assert moved


@pytest.mark.parametrize("world", [2, 4])
def test_multihost_uneven_partitions_match_the_concatenated_fit(world):
    # Each rank brings its own partition (one of them empty); the JAX
    # reference trains the concatenated rows.
    _check("multihost", world, ("loss", "grad_norm", "examples"), 1e-5)


def test_rank0_checkpoints_and_every_rank_resumes():
    # Rank 0 writes the snapshots behind a barrier; every rank restores
    # the newest and the resumed fit equals the straight one.
    ranks = _world(2)
    snapshots = ranks[0]["checkpoint"][0]
    try:
        assert [r["checkpoint"][1] for r in ranks] == [6, 6]
        assert sorted(os.listdir(snapshots)) == ["2", "4", "6"]
        for rank in ranks:
            _, _, straight, resumed = rank["checkpoint"]
            for key, value in straight.items():
                np.testing.assert_array_equal(resumed[key], value,
                                              err_msg=key)
    finally:
        shutil.rmtree(snapshots, ignore_errors=True)


def test_estimator_trains_over_a_dp_mesh():
    import jax
    import sparktorch_tpu as jax_pkg
    from sparktorch_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from sparktorch_tpu.parallel.mesh import build_mesh as jax_build_mesh

    x, y = _data("estimator")
    jax_obj, _, _ = _packages("mlp", x, "adam", 1e-3)
    jax_est = jax_pkg.SparkTorch(
        inputCol="features", labelCol="label", torchObj=jax_obj, iters=5,
        mesh=jax_build_mesh(JaxMeshConfig(), jax.devices()[:2]))
    jax_est.fit({"features": list(x), "label": y.astype(np.float32)})
    got = _world(2)[0]["estimator"][0]
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in jax_est._last_metrics],
                               atol=1e-4, rtol=1e-4)


def test_estimator_mesh_settings():
    # A world of one (no process group) through a mesh trains as without
    # one; any axis but dp above 1 names the roadmap.
    x, y = _mnist(32, 3)
    frame = {"features": list(x), "label": y.astype(np.float32)}
    torch.manual_seed(0)
    obj = port.serialize_torch_obj(torch_simple.MnistMLP(),
                                   criterion="cross_entropy", optimizer="sgd",
                                   optimizer_params={"lr": 0.1},
                                   input_shape=(784,))
    kw = dict(inputCol="features", labelCol="label", torchObj=obj, iters=3,
              device="cpu")
    mesh = build_mesh()
    assert isinstance(mesh, Mesh) and mesh.dp == 1 and mesh.batch_group is None
    plain = port.SparkTorch(**kw)
    plain.fit(frame)
    meshed = port.SparkTorch(mesh=mesh, **kw)
    meshed.fit(frame)
    assert ([m["loss"] for m in meshed._last_metrics]
            == [m["loss"] for m in plain._last_metrics])
    configured = port.SparkTorch(**kw).setMesh(MeshConfig(dp=1))
    configured.fit(frame)
    assert ([m["loss"] for m in configured._last_metrics]
            == [m["loss"] for m in plain._last_metrics])
    # fsdp is ported: a world of one has no room for two shards.
    with pytest.raises(ValueError, match="world size"):
        port.SparkTorch(mesh=MeshConfig(fsdp=2), **kw).fit(frame)
    # tp is ported too: a world of one has no room for two tp peers.
    with pytest.raises(ValueError, match="world size"):
        port.SparkTorch(**kw).setMesh(MeshConfig(tp=2)).fit(frame)
    with pytest.raises(ValueError, match="world size"):
        build_mesh(MeshConfig(dp=2))


def test_streaming_trainer_refuses_a_dp_world():
    # The streaming trainer now runs over a DP world (the name is the
    # test's from when it raised there): each rank feeds its shard of
    # every chunk (64 rows in chunks of 24: 24, 24 and a ragged 16, two
    # epochs), and the full-chunk steps equal one process's on all rows.
    from sparktorch_tpu_torch.train.sync import train_distributed_streaming

    x, y = _data("streaming")
    obj = _packages("mlp", x, "sgd", 0.1)[1]
    want = train_distributed_streaming(obj, (x, y), chunk_rows=24, epochs=2,
                                       device="cpu")
    for rank in _world(2):
        metrics, params = rank["streaming"]
        assert [m["examples"] for m in metrics] == [24.0, 24.0, 16.0] * 2
        np.testing.assert_allclose([m["loss"] for m in metrics],
                                   [m["loss"] for m in want.metrics],
                                   rtol=1e-5, atol=1e-6)
        for key, value in want.params.items():
            np.testing.assert_allclose(params[key], value.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=key)


def test_bench_harness_over_a_dp_world():
    # Every step is an all-reduce, so the ranks must run the same calls:
    # the long span grows on the slowest rank's difference, and rank 1's
    # fast clock does not make it stop alone.
    from sparktorch_tpu_torch import bench

    recs = [rank["bench"] for rank in _world(2)]
    jax_keys, omitted, added = bench.RECORD_KEYS["mnist_mlp_sync"]
    for rec in recs:
        assert set(rec) == (jax_keys - omitted - {"config", "unit"}) | added
        assert rec["n_chips"] == 2
        # 64 rows a step over the world: 32 per chip.
        assert rec["examples_per_sec_per_chip"] == round(
            64 / rec["step_time_p50_s"] / 2, 1)
    assert recs[0]["steps_run"] == recs[1]["steps_run"] >= 5 * 3 + 5 * 2 * 8
    assert recs[0]["final_loss"] == recs[1]["final_loss"]
    assert np.isfinite(recs[0]["final_loss"])
