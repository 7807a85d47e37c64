"""Every other trainer in a (dp 1, tp 2) world: tp peers are replicas of one batch shard.

A gloo world of 2 ranks builds ``MeshConfig(tp=2)``: one batch shard,
two tp peers. The JAX package's shard_map trainers replicate the
parameters over the whole mesh and split the batch over dp × fsdp only;
so here ``train_distributed`` (minibatch sampling on),
``SparkTorch.setMesh(MeshConfig(tp=2))``, ``train_distributed_multihost``
(each peer given the same rows; peers given different partitions are
refused) and ``train_distributed_streaming`` give
each peer the one-process fit's records and parameters (a peer that
drew its own minibatches, or a gradient summed over both peers, would
not), and a ``BatchPredictor`` over the mesh gives each peer every row.
The same world runs the bench's ``sharded_trace``, whose mesh is
``tp2`` there and whose capture holds the tp collectives.

The spawned ranks import this module, so the JAX package is imported
inside the functions that use it.
"""

import functools

import numpy as np

from test_torch_dp import _mnist, _packages, start_world

ROWS, DATA_SEED, MINI, CHUNK = 40, 7, 16, 23


def _fits(obj, x, y, mesh):
    """train_distributed, the estimator, multihost and streaming on
    ``mesh`` (None: one process), with a predictor of the first fit."""
    import sparktorch_tpu_torch as port
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.train.sync import (
        train_distributed,
        train_distributed_multihost,
        train_distributed_streaming,
    )
    from sparktorch_tpu_torch.utils.serde import deserialize_model

    def params(result):
        return {k: v.numpy() for k, v in result.params.items()}

    out = {}
    fit = train_distributed(obj, x, labels=y, mesh=mesh, iters=5,
                            mini_batch=MINI, device="cpu")
    out["fit"] = (fit.metrics, params(fit))
    est = port.SparkTorch(inputCol="features", labelCol="label",
                          torchObj=obj, iters=5, device="cpu")
    if mesh is not None:
        from sparktorch_tpu_torch.parallel.mesh import MeshConfig

        est.setMesh(MeshConfig(tp=2))
    est.fit({"features": list(x), "label": y.astype(np.float32)})
    out["estimator"] = [m["loss"] for m in est._last_metrics]
    multi = train_distributed_multihost(obj, x, y, mesh=mesh, iters=5,
                                        device="cpu")
    out["multihost"] = (multi.metrics, params(multi))
    stream = train_distributed_streaming(obj, (x, y), mesh=mesh,
                                         chunk_rows=CHUNK, epochs=2,
                                         device="cpu")
    out["streaming"] = (stream.metrics, params(stream))
    module = deserialize_model(obj).make_module()
    module.load_state_dict(fit.params)
    out["predict"] = BatchPredictor(module, chunk=16, mesh=mesh,
                                    device="cpu").predict(x[:37])
    return out


def _multihost_mismatch(obj, x, y, mesh, rank):
    """Each peer given its own rows: the same count with other values,
    then another count. Returns each call's ValueError (None if none)."""
    from sparktorch_tpu_torch.train.sync import train_distributed_multihost

    out = []
    for parts in ((slice(0, 20), slice(20, 40)), (slice(0, 20), slice(0, 25))):
        rows = parts[rank]
        try:
            train_distributed_multihost(obj, x[rows], y[rows], mesh=mesh,
                                        iters=1, device="cpu")
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def _job(rank, obj, x, y):
    from sparktorch_tpu_torch import bench
    from sparktorch_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    mesh = build_mesh(MeshConfig(tp=2))
    out = _fits(obj, x, y, mesh)
    out["multihost_refused"] = _multihost_mismatch(obj, x, y, mesh, rank)
    out["mesh"] = (mesh.batch_shards, mesh.batch_index, mesh.tp_rank)
    out["sharded_trace"] = bench.bench_sharded_trace(device="cpu")
    return out


@functools.lru_cache(maxsize=None)
def _world():
    x, y = _mnist(ROWS, DATA_SEED)
    obj = _packages("mlp", x, "sgd", 0.1)[1]
    join = start_world(2, _job, obj, x, y)
    try:
        want = _fits(obj, x, y, None)
    finally:
        ranks = join()
    return ranks, want


def _same(got, want, key):
    got_metrics, got_params = got
    want_metrics, want_params = want
    assert len(got_metrics) == len(want_metrics)
    for field in ("loss", "examples"):
        np.testing.assert_allclose([m[field] for m in got_metrics],
                                   [m[field] for m in want_metrics],
                                   rtol=1e-6, atol=1e-7, err_msg=key)
    for name, value in got_params.items():
        np.testing.assert_allclose(value, want_params[name], rtol=1e-6,
                                   atol=1e-7, err_msg=f"{key} {name}")


def test_tp_peers_share_one_batch_shard():
    ranks, _ = _world()
    assert [r["mesh"] for r in ranks] == [(1, 0, 0), (1, 0, 1)]


def test_train_distributed_gives_each_tp_peer_the_one_process_fit():
    ranks, want = _world()
    assert [m["examples"] for m in want["fit"][0]] == [MINI] * 5
    for rank in ranks:
        _same(rank["fit"], want["fit"], "fit")
        np.testing.assert_allclose(rank["estimator"], want["estimator"],
                                   rtol=1e-6)


def test_multihost_and_streaming_give_each_tp_peer_the_one_process_fit():
    ranks, want = _world()
    assert [m["examples"] for m in want["streaming"][0]] == [23, 17] * 2
    for rank in ranks:
        _same(rank["multihost"], want["multihost"], "multihost")
        _same(rank["streaming"], want["streaming"], "streaming")


def test_multihost_refuses_tp_peers_given_different_partitions():
    # A peer's rows would otherwise train a replica of their own that
    # rank 0's returned fit silently leaves out.
    ranks, _ = _world()
    for rank in ranks:
        refused = rank["multihost_refused"]
        assert len(refused) == 2 and all(
            m is not None and "tp peers of batch shard 0" in m
            for m in refused), refused
    assert "rows [20, 20]" in ranks[0]["multihost_refused"][0]
    assert "rows [20, 25]" in ranks[0]["multihost_refused"][1]


def test_batch_predictor_gives_each_tp_peer_every_row():
    ranks, want = _world()
    for rank in ranks:
        assert rank["predict"].shape == (37, 10)
        np.testing.assert_allclose(rank["predict"], want["predict"],
                                   rtol=1e-6, atol=1e-6)


def test_sharded_trace_gates_hold_in_a_tp2_world():
    from sparktorch_tpu_torch import bench

    ranks, _ = _world()
    keys = bench.RECORD_KEYS["sharded_trace"][0]
    for rank in ranks:
        rec = rank["sharded_trace"]
        assert set(rec) == keys and rec["mesh"] == "tp2"
        assert rec["n_chips"] == 2 and rec["n_steps"] == 6
        assert rec["n_collective_events"] >= 1
        assert rec["collective_counts"].get("all_reduce", 0) >= 1
        assert rec["scrape_parity"] == "ok"
        assert rec["comm_drift"]["status"] == "no_prior_record"


def test_sharded_trace_record_keys_are_the_jax_records():
    import json
    from pathlib import Path

    from sparktorch_tpu_torch import bench

    path = (Path(__file__).resolve().parent.parent / "benchmarks"
            / "bench_r06_tune.jsonl")
    recs = [json.loads(ln) for ln in path.read_text().splitlines()
            if ln.strip()]
    newest = [r for r in recs if r.get("config") == "sharded_trace"][-1]
    jax_keys, omitted, added = bench.RECORD_KEYS["sharded_trace"]
    assert set(newest) - {"ts"} == jax_keys and not omitted and not added
