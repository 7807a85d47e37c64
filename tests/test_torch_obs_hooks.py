"""The obs and chaos hooks of the port's parameter server, wire client, gang and bench against the JAX package's.

The same traffic goes to a JAX parameter server and a port one: the
counter names and values their ``/metrics`` scrapes show agree, and each
scrape equals its bus's JSONL dump. One ``ChaosConfig`` per wire site
(``param_server.pull``, ``param_server.update``, ``transport.request``)
gives the same injector events in both packages. A gloo world of 2
brought up with a heartbeat directory writes one heartbeat file per rank
holding the step the trainer last published, which both packages'
``gang_report`` read. ``--telemetry-dump`` writes the bench's ``bench/*``
spans.

Spawned ranks import this module, so jax is imported inside the test
functions only.
"""

import functools
import json
import multiprocessing as mp
import os
import re
import socket
import time
import traceback
import types
import urllib.request

import numpy as np
import pytest
import torch

from sparktorch_tpu_torch import obs
from sparktorch_tpu_torch import serialize_torch_obj
from sparktorch_tpu_torch.ft import ChaosConfig, inject
from sparktorch_tpu_torch.models import Net
from sparktorch_tpu_torch.net import wire
from sparktorch_tpu_torch.net.transport import BinaryTransport
from sparktorch_tpu_torch.serve.param_server import (
    ParameterServer,
    ParamServerHttp,
)

JOIN_S = 240


def _payloads():
    from sparktorch_tpu import serialize_torch_obj as jax_serialize
    from sparktorch_tpu.models import Net as JaxNet

    kw = dict(criterion="mse", optimizer="adam",
              optimizer_params={"lr": 5e-3}, input_shape=(10,))
    torch.manual_seed(0)
    return jax_serialize(JaxNet(), **kw), serialize_torch_obj(Net(), **kw)


def _servers():
    """A JAX and a port (server, http, telemetry) on run-scoped buses."""
    from sparktorch_tpu import obs as jax_obs
    from sparktorch_tpu.serve import param_server as jax_ps

    jax_obj, obj = _payloads()
    jax_tele = jax_obs.Telemetry(run_id="ps-jax")
    tele = obs.Telemetry(run_id="ps-port")
    jax_server = jax_ps.ParameterServer(jax_obj, window_len=1,
                                        telemetry=jax_tele)
    server = ParameterServer(obj, window_len=1, telemetry=tele, device="cpu")
    return {"jax": (jax_server,
                    jax_ps.ParamServerHttp(jax_server, port=0).start(),
                    jax_tele),
            "port": (server, ParamServerHttp(server, port=0).start(), tele)}


def _stop(servers):
    for server, http, _ in servers.values():
        http.stop()
        server.stop()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.headers.get("Content-Type", ""), r.read()


def _ones(tree):
    """Ones shaped like a pulled tree (the JAX server's is nested)."""
    if isinstance(tree, dict):
        return {k: _ones(v) for k, v in tree.items()}
    return np.ones_like(np.asarray(tree))


def test_param_server_routes_match_jax(tmp_path):
    servers = _servers()
    try:
        got = {}
        for name, (server, http, tele) in servers.items():
            v0, params = server.get_parameters(-1)
            assert server.get_parameters(v0) is None
            server.push_gradients(_ones(params))
            server.drain()
            server.post_loss(0.5)
            status, ctype, body = _get(http.url + "/metrics")
            assert status == 200 and ctype.startswith("text/plain")
            scraped = obs.parse_prometheus(body.decode())
            # The dump is the same snapshot: every series of the scrape
            # holds the dump's value (the scrape counted itself first).
            dump = str(tmp_path / name / "ps.jsonl")
            snap = tele.dump(dump)
            (line,) = obs.read_jsonl(dump)
            assert line["kind"] == "snapshot"
            assert line["counters"] == snap["counters"]
            text = obs.render_prometheus(snap)
            assert obs.parse_prometheus(text).keys() == scraped.keys()
            for series, value in obs.parse_prometheus(text).items():
                if "quantile" not in series and "_sum" not in series:
                    assert scraped[series] == value, series
            status, ctype, body = _get(http.url + "/telemetry")
            assert ctype == "application/json"
            served = json.loads(body)
            assert served["counters"] == tele.snapshot()["counters"]
            got[name] = (snap["counters"], sorted(snap["gauges"]),
                         {k: v["count"]
                          for k, v in snap["histograms"].items()})
        assert got["port"] == got["jax"]
        assert got["port"][0] == {
            "param_server.applies": 1.0,
            "param_server.http_requests{route=/metrics}": 1.0,
            "param_server.losses_posted": 1.0,
            "param_server.pull_fresh": 1.0,
            "param_server.pulls": 2.0,
            "param_server.pushes": 1.0}
        assert got["port"][1] == ["param_server.queue_depth",
                                  "param_server.version"]
    finally:
        _stop(servers)


def _truncated_pull(transport, ports):
    with pytest.raises(ports["WireError"]):
        transport.pull(-1)


def _forced_500(transport, ports):
    v, params = transport.pull(-1)
    with pytest.raises(Exception):
        transport.push(_ones(params))


def _dropped_connection(transport, ports):
    v, _ = transport.pull(-1)
    assert transport.stats["reconnects"] == 1
    assert transport.pull(v) is None


def settled_snapshot(tele, timeout=5.0):
    """``tele``'s snapshot once its request tracer has stopped counting
    spans: a server handler closes its serve span just after the reply
    the client is already holding."""
    def spans():
        return sum(v for k, v in tele.snapshot()["counters"].items()
                   if k.startswith("rpctrace.spans_total"))

    last, deadline = spans(), time.monotonic() + timeout
    while time.monotonic() < deadline:
        time.sleep(0.05)
        now = spans()
        if now == last:
            break
        last = now
    return tele.snapshot()


@pytest.mark.parametrize("config,drive,site", [
    (dict(truncate_pull_frames=1), _truncated_pull, "param_server.pull"),
    (dict(server_error_pushes=1), _forced_500, "param_server.update"),
    (dict(drop_connections=1), _dropped_connection, "transport.request"),
], ids=["param_server.pull", "param_server.update", "transport.request"])
def test_wire_chaos_sites_match_jax(config, drive, site, monkeypatch):
    # Every request traced in both packages: the request tracer's
    # counters are compared with the rest.
    monkeypatch.setenv("SPARKTORCH_TPU_RPC_SAMPLE", "1.0")
    from sparktorch_tpu.ft import ChaosConfig as JaxChaosConfig
    from sparktorch_tpu.ft import inject as jax_inject
    from sparktorch_tpu.net import wire as jax_wire
    from sparktorch_tpu.net.transport import (
        BinaryTransport as JaxBinaryTransport,
    )

    servers = _servers()
    try:
        events, counters = {}, {}
        for name, cfg, injector, client, wire_mod in (
                ("jax", JaxChaosConfig, jax_inject, JaxBinaryTransport,
                 jax_wire),
                ("port", ChaosConfig, inject, BinaryTransport, wire)):
            _, http, tele = servers[name]
            transport = client(http.url, quant=None, telemetry=tele)
            try:
                with injector(cfg(**config), telemetry=tele) as inj:
                    drive(transport, {"WireError": wire_mod.WireError})
            finally:
                transport.close()
            events[name] = inj.events
            # Each server has its own port: the label names it.
            counters[name] = {re.sub(r"port=\d+", "port=*", k): v
                              for k, v in settled_snapshot(tele)[
                                  "counters"].items()
                              if not k.startswith(
                                  "param_server.wire_bytes_total")}
        assert events["port"] == events["jax"]
        assert [e["site"] for e in events["port"]] == [site]
        assert counters["port"] == counters["jax"]
        assert counters["port"][f"chaos_injections_total{{site={site}}}"] == 1
    finally:
        _stop(servers)


def test_run_tags_ride_the_frames():
    """Pushes carry the run's tag; the server counts a push tagged by
    another run (and applies it), and the client counts a pulled frame
    of another run."""
    _, obj = _payloads()
    tele = obs.Telemetry(run_id="run-a")
    server = ParameterServer(obj, window_len=1, telemetry=tele, device="cpu")
    http = ParamServerHttp(server, port=0).start()
    try:
        same = BinaryTransport(http.url, quant=None, telemetry=tele,
                               run_id="run-a")
        other = BinaryTransport(http.url, quant=None, telemetry=tele,
                                run_id="run-b")
        for t in (same, other):
            v, params = t.pull(-1)
            t.push(_ones(params))
            t.close()
        counters = tele.snapshot()["counters"]
        host = {"host": "127.0.0.1", "port": http.port}
        assert counters["param_server.run_tag_mismatches_total"] == 1.0
        assert tele.counter_value("transport_run_tag_mismatches_total",
                                  labels=host) == 1.0
        assert counters["param_server.applies"] == 2.0
    finally:
        http.stop()
        server.stop()


def test_run_hogwild_worker_takes_ctx_telemetry():
    from sparktorch_tpu_torch.train.hogwild import run_hogwild_worker

    _, obj = _payloads()
    x = np.random.default_rng(0).normal(0, 1, (32, 10)).astype(np.float32)
    server = ParameterServer(obj, window_len=1, device="cpu")
    http = ParamServerHttp(server, port=0).start()
    try:
        tele = obs.Telemetry(run_id="worker")
        out = run_hogwild_worker(obj, http.url, (x, x[:, 0]), iters=4,
                                 push_every=2, worker_id=3, device="cpu",
                                 ctx=types.SimpleNamespace(telemetry=tele))
    finally:
        http.stop()
        server.stop()
    snap = tele.snapshot()
    assert out["pushes"] == 2
    assert snap["counters"] == {"hogwild.iters{worker=3}": 4.0,
                                "hogwild.pushes{worker=3}": 2.0,
                                "tracing.annotated_steps": 2.0}
    # The worker's health ledger (rank w3) publishes the health.* gauges.
    assert sorted(snap["gauges"]) == sorted(
        ["hogwild.pulled_version{worker=3}", "health.loss{rank=w3}",
         "health.last_step{rank=w3}", "health.pending_fetch{rank=w3}"]
        + [f"health.anomaly{{akind={k},rank=w3}}" for k in (
            "nonfinite", "loss_spike", "grad_explosion", "plateau")])
    assert snap["sections"]["health"]["ranks"]["w3"]["steps_ingested"] == 4
    # As in the JAX package, a worker process keeps no phase histograms.
    assert snap["histograms"] == {}
    assert server.telemetry.counter_value("param_server.applies") == 2.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _heartbeat_rank(rank, world, gang_port, dist_port, hb_dir, queue):
    """One rank of the world: the gang (with heartbeat files), then a
    3-step fit that publishes each chunk's step."""
    import torch.distributed as dist

    from sparktorch_tpu_torch.parallel import launch
    from sparktorch_tpu_torch.train.sync import train_distributed

    os.environ["SPARKTORCH_TPU_HEARTBEAT_DIR"] = hb_dir
    os.environ["SPARK_LOCAL_IP"] = "127.0.0.1"
    torch.set_num_threads(1)
    worker = None
    try:
        tele = obs.Telemetry(run_id=f"rank{rank}")
        # The coordinator runs in the test's process, as a Spark driver
        # runs it for barrier tasks: no rank can dial before it listens.
        _, worker = launch.bringup_multihost(
            rank, world, "127.0.0.1", gang_port=gang_port,
            dist_port=dist_port, start_coordinator=False, backend="gloo",
            telemetry=tele)
        torch.manual_seed(0)
        obj = serialize_torch_obj(Net(), criterion="mse", optimizer="sgd",
                                  optimizer_params={"lr": 0.1},
                                  input_shape=(10,))
        x = np.random.default_rng(0).normal(0, 1, (16, 10)).astype(
            np.float32)
        result = train_distributed(obj, x, labels=x[:, 0], iters=3,
                                   steps_per_call=1, device="cpu")
        with open(worker.heartbeat.path) as f:
            live = json.load(f)
        dist.barrier()
        queue.put((rank, True, {"live": live, "run_id": tele.run_id,
                                "steps": len(result.metrics),
                                "beats": tele.counter_value(
                                    "gang.heartbeats",
                                    labels={"rank": rank,
                                            "host": worker.heartbeat.host})}))
    except Exception:
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        launch.register_gang_worker(None)
        if worker is not None:
            worker.close()


def test_gang_heartbeats_carry_the_published_step(tmp_path):
    from sparktorch_tpu import obs as jax_obs
    from sparktorch_tpu_torch.native.gang import GangCoordinator

    world, hb_dir = 2, str(tmp_path / "hb")
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    coord = GangCoordinator(world_size=world, run_id="hb-world")
    dist_port = _free_port()
    procs = [ctx.Process(target=_heartbeat_rank,
                         args=(r, world, coord.port, dist_port, hb_dir,
                               queue))
             for r in range(world)]
    for p in procs:
        p.start()
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
        coord.stop()
    if failed is not None:
        pytest.fail(failed)
    files = sorted(os.listdir(hb_dir))
    assert files == ["gang_hb_rank0.json", "gang_hb_rank1.json"]
    for rank, res in results.items():
        assert res["steps"] == 3
        # The last chunk's step, from notify_gang_step, while running.
        assert res["live"]["step"] == 2 and res["live"]["alive"]
        assert res["live"]["rank"] == rank
        assert res["live"]["run_id"] == res["run_id"] == "hb-world"
        assert res["beats"] >= 3
    for pkg in (obs, jax_obs):
        report = pkg.gang_report(hb_dir)
        assert report["n_ranks"] == 2
        rows = pkg.read_heartbeats(hb_dir)
        # A clean close leaves alive=False over the last step.
        assert [(r["rank"], r["step"], r["alive"]) for r in rows] == [
            (0, 2, False), (1, 2, False)]


def test_bench_telemetry_dump_writes_the_bench_spans(tmp_path, monkeypatch,
                                                     capsys):
    from sparktorch_tpu_torch import bench

    # The CLI runs on the card; here the config runs on the CPU at a
    # cut depth through the same main().
    monkeypatch.setitem(bench.CONFIGS, "hogwild_wire",
                        functools.partial(bench.bench_hogwild_wire,
                                          device="cpu", iters=8))
    monkeypatch.setattr(bench, "_device_label", lambda: "cpu")
    previous = obs.get_telemetry()
    obs.set_telemetry(obs.Telemetry(run_id="bench"))
    try:
        path = str(tmp_path / "dump.jsonl")
        bench.main(["--config", "hogwild_wire", "--telemetry-dump", path])
    finally:
        obs.set_telemetry(previous)
    (line,) = [json.loads(s) for s in capsys.readouterr().out.splitlines()
               if s.startswith("{")]
    jax_keys, omitted, added = bench.RECORD_KEYS["hogwild_wire"]
    assert set(line) - {"ts", "device"} == jax_keys - omitted | added
    for leg in ("dill", "binary"):
        assert line[leg]["pushes"] == 2  # 8 iterations, a push every 4
    (dump,) = obs.read_jsonl(path)
    assert dump["kind"] == "snapshot"
    spans = dump["spans"]
    for phase in ("data", "init", "compile_warmup", "measure"):
        assert spans[f"bench/{phase}"]["count"] == 1
    assert spans["bench/measure/hogwild/data_prep"]["count"] == 2
    assert dump["counters"]["hogwild.rounds"] == 3.0
    assert dump["counters"]["param_server.http_requests{route=/update}"] > 0
