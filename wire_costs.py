#!/usr/bin/env python3
"""Time two choices of the port's HTTP wire on one card: how a ``ShardedTransport`` fans its requests out to a fleet's shards, and ``TCP_NODELAY`` on the port's sockets.

    python3 wire_costs.py [--repeats R]

Fan-out: the transport's own ``_fan`` ("pool": one pool thread a shard,
so the shards render and send at once) against "serial" (one shard
after the other over the kept-alive connections), swapped in here.

- ``bert``: BERT-base (flash attention, 12 layers, seeded weights) in a
  4-shard ``ParamServerFleet`` on the card, and two
  ``ShardedTransport(pull_quant="int8")`` clients, synced (the two
  serving replicas' pullers of ``chip_smoke.py``'s fleet (b)). Each
  round pushes ones on every leaf through ``fleet.scatter_push``, then
  both clients pull at once: the seconds from the push's return to both
  holding the new tree; then the same for a sparse push (the last
  encoder layer and the classifier).
- ``bench``: ``bench.bench_hogwild_ps_fleet(pairs=1,
  timing_gates=False)`` (the 66 MB MLP, 6 pullers of hot-quarter
  deltas): the fleet legs' pull p50 and p99 and the ratios to the
  single server.

Nagle: TCP_NODELAY "on" (the port's client connections and server
handlers) against "off" (the kernel's default, Nagle's algorithm on,
for both), swapped in here: ``bench.bench_hogwild_wire`` (the binary
and dill wires' seconds per push and per fresh pull) and the ``bench``
workload above with the pool.

Full pull (``full_pull``): where a single server's full f32 pull of
BERT-base (0.44 GB; ``chip_smoke.py``'s serve_online (c)) goes, idle
and beside two serving loops (one-row forwards of a dense-attention
BERT-base, back to back, as two busy replicas): after each dense push,
the render's host copy (``tree_to_host``) and encode; two clients'
concurrent ``BinaryTransport.pull`` (the server renders inside), then
after another push into reused pinned buffers (``pull(into=)``, as a
``WeightPuller`` on a card does); one client's read of the rendered body and its decode; an install's module
copy and load (``copy_stream``) and a whole ``update_params``, from a
fresh body and from a pinned one; and raw
loopback TCP for the same bytes: a ``recv_into`` loop on a socket with
a timeout into a fresh buffer and into a reused one, and one blocking
``MSG_WAITALL`` receive.

Each pair of variants runs interleaved A, B, B, A, ``--repeats`` times.
``--workloads`` picks among bert, bench, nagle, full_pull (all by
default). Prints one JSON line with the card's name and power limit.
"""

import argparse
import copy
import http.client
import json
import socket
import socketserver
import subprocess
import sys
import threading
import time

import numpy as np


def serial_fan(self, fn, items):
    return [fn(item) for item in items]


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--repeats", type=int, default=1)
    parser.add_argument("--workloads", default="bert,bench,nagle,full_pull")
    args = parser.parse_args()
    workloads = set(args.workloads.split(","))

    import torch

    if not torch.cuda.is_available():
        print("wire_costs: no CUDA device", file=sys.stderr)
        return 1
    from sparktorch_tpu_torch.net import sharded, transport

    device = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    fans = {"pool": sharded.ShardedTransport._fan, "serial": serial_fan}
    nodelay_connect = transport._Connection.connect
    stock_setup = socketserver.StreamRequestHandler.setup

    def nagle_setup(self):
        self.disable_nagle_algorithm = False
        stock_setup(self)

    def use(fan="pool", nodelay=True):
        sharded.ShardedTransport._fan = fans[fan]
        transport._Connection.connect = (
            nodelay_connect if nodelay
            else http.client.HTTPConnection.connect)
        socketserver.StreamRequestHandler.setup = (
            stock_setup if nodelay else nagle_setup)

    def abba(a, b):
        return [a, b, b, a] * args.repeats

    out = {"device": device, "repeats": args.repeats}
    if "full_pull" in workloads:
        out["full_pull"] = full_pull_costs(torch, args.repeats)
    if "bert" in workloads:
        out["bert"] = bert_fan_costs(torch, fans, use, abba)
    if "bench" in workloads:
        out["bench_fan"] = [dict(fan=f, **fleet_bench(use, fan=f))
                            for f in abba("serial", "pool")]
    if "nagle" in workloads:
        out["bench_nagle"] = [dict(nodelay=n, **fleet_bench(use, nodelay=n))
                              for n in abba(True, False)]
        out["wire_nagle"] = [wire(use, n) for n in abba(True, False)]
    print(json.dumps(out))
    return 0


def bert_fan_costs(torch, fans, use, abba):
    """bert: two int8 clients after a dense and a sparse push."""
    from sparktorch_tpu_torch.models import bert_base
    from sparktorch_tpu_torch.net import sharded
    from sparktorch_tpu_torch.serve.fleet import ParamServerFleet
    from sparktorch_tpu_torch.utils.serde import ModelSpec

    torch.manual_seed(0)
    fleet = ParamServerFleet(ModelSpec(
        module=bert_base(attn_impl="flash"), loss="cross_entropy",
        optimizer="sgd", optimizer_params={"lr": 1e-3},
        input_shape=(128,)), n_shards=4, device="cuda").start()
    clients = [sharded.ShardedTransport(fleet, pull_quant="int8")
               for _ in range(2)]
    try:
        for c in clients:
            c.pull(-1)
        ones = {(n,): torch.ones_like(v)
                for n, v in fleet.assemble().items()}
        sparse = {p: g for p, g in ones.items()
                  if p[0].startswith(("backbone.layers.11.", "classifier."))}
        bert = {f: {"dense_s": [], "sparse_s": [], "dense_mb": [],
                    "sparse_mb": []} for f in fans}
        for fan in abba("serial", "pool"):
            use(fan=fan)
            for label, grads in (("dense", ones), ("sparse", sparse)):
                fleet.scatter_push(grads, wait=True)
                bytes0 = [c.stats["pull_bytes"] for c in clients]
                got = [None] * len(clients)

                def pull(i):
                    got[i] = clients[i].pull(0)

                t0 = time.perf_counter()
                threads = [threading.Thread(target=pull, args=(i,))
                           for i in range(len(clients))]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t0
                if any(g is None for g in got):
                    raise AssertionError(f"bert {fan} {label}: a pull was "
                                         "not fresh")
                bert[fan][f"{label}_s"].append(wall)
                bert[fan][f"{label}_mb"].append(
                    (clients[0].stats["pull_bytes"] - bytes0[0]) / 1e6)
        return bert
    finally:
        use()
        for c in clients:
            c.close()
        fleet.stop()
        del fleet
        torch.cuda.empty_cache()


def fleet_bench(use, **kw):
    from sparktorch_tpu_torch import bench

    use(**kw)
    try:
        rec = bench.bench_hogwild_ps_fleet(pairs=1, timing_gates=False)
    finally:
        use()
    return {"fleet_p50_ms": rec["fleet"]["pull_p50_ms"],
            "fleet_p99_ms": rec["fleet"]["pull_p99_ms"],
            "int8_p50_ms": rec["fleet_int8"]["pull_p50_ms"],
            "int8_p99_ms": rec["fleet_int8"]["pull_p99_ms"],
            "single_p99_ms": rec["single"]["pull_p99_ms"],
            "bandwidth_ratio": rec["bandwidth_ratio"],
            "p99_ratio": rec["p99_ratio"]}


def wire(use, nodelay):
    from sparktorch_tpu_torch import bench

    use(nodelay=nodelay)
    try:
        rec = bench.bench_hogwild_wire()
    finally:
        use()
    return {"nodelay": nodelay, **{
        f"{w}_{k}_ms": rec[w][k] * 1e3 for w in ("binary", "dill")
        for k in ("push_wire_s_per_push", "pull_s_per_fresh_pull")}}


def loopback_s(payload: memoryview, mode: str, reuse=None) -> float:
    """Seconds to receive ``payload`` over loopback TCP: "loop" (a
    ``recv_into`` loop on a socket with a timeout, as http.client
    reads) into a fresh buffer or ``reuse``; "waitall" (one blocking
    ``MSG_WAITALL`` receive)."""
    n = len(payload)
    with socket.create_server(("127.0.0.1", 0)) as srv:
        def send():
            c, _ = srv.accept()
            with c:
                c.sendall(payload)

        sender = threading.Thread(target=send)
        sender.start()
        with socket.create_connection(srv.getsockname()) as s:
            t0 = time.perf_counter()
            view = memoryview(reuse if reuse is not None else bytearray(n))
            got = 0
            if mode == "waitall":
                s.settimeout(None)
                while got < n:
                    got += s.recv_into(view[got:], n - got, socket.MSG_WAITALL)
            else:
                s.settimeout(60.0)
                while got < n:
                    got += s.recv_into(view[got:])
            dt = time.perf_counter() - t0
        sender.join()
    return dt


def full_pull_costs(torch, repeats: int, device: str = "cuda",
                    **bert_overrides) -> list:
    """full_pull: a single server's full BERT-base pull by piece
    (``bert_overrides`` shrink the model for a dry run off the card)."""
    from sparktorch_tpu_torch.inference import BatchPredictor
    from sparktorch_tpu_torch.models import bert_base
    from sparktorch_tpu_torch.net import wire as binwire
    from sparktorch_tpu_torch.net.transport import BinaryTransport, tree_to_host
    from sparktorch_tpu_torch.serve.infer import state_dict_for
    from sparktorch_tpu_torch.serve.param_server import (ParameterServer,
                                                         ParamServerHttp)
    from sparktorch_tpu_torch.utils.serde import ModelSpec
    from sparktorch_tpu_torch.utils.streams import copy_stream

    torch.manual_seed(0)
    server = ParameterServer(ModelSpec(
        module=bert_base(attn_impl="dense", **bert_overrides),
        loss="cross_entropy", optimizer="sgd", optimizer_params={"lr": 1e-3},
        input_shape=(128,)), device=device)
    http = ParamServerHttp(server, port=0).start()
    clients = [BinaryTransport(http.url, quant=None) for _ in range(2)]
    preds = [BatchPredictor(bert_base(attn_impl="dense", **bert_overrides),
                            device=device, chunk=8) for _ in range(2)]
    vocab = preds[0].module.config.vocab_size
    ids = np.random.default_rng(0).integers(0, vocab, (1, 128))
    _, params = server.slot.read()
    ones = {k: torch.ones_like(v) for k, v in params.items()}
    nbytes = sum(v.numel() * v.element_size() for v in params.values())
    payload = memoryview(np.ones(nbytes, np.uint8))
    reuse = bytearray(nbytes)
    recv = [torch.empty(nbytes + (1 << 20), dtype=torch.uint8,
                        pin_memory=device == "cuda") for _ in range(2)]
    rows = []
    try:
        for c in clients:
            c.pull(-1)
        for loaded in [False, True] * repeats:
            stop = threading.Event()

            def serve(bp):
                while not stop.is_set():
                    bp.predict(ids)

            loops = [threading.Thread(target=serve, args=(bp,))
                     for bp in preds] if loaded else []
            for t in loops:
                t.start()
            try:
                row = {"loaded": loaded}
                server.push_gradients(ones, wait=True)
                version, params = server.slot.read()
                t0 = time.perf_counter()
                host = tree_to_host(params)
                row["render_host_copy_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                binwire.encode(host, version=version)
                row["render_encode_s"] = time.perf_counter() - t0
                del host
                got, secs = [None, None], [None, None]

                def pull(i):
                    t0 = time.perf_counter()
                    got[i] = clients[i].pull(version - 1)
                    secs[i] = time.perf_counter() - t0

                def pull_into(i):
                    t0 = time.perf_counter()
                    got[i] = clients[i].pull(
                        version - 1, into=lambda n, i=i: recv[i][:n].numpy())
                    secs[i] = time.perf_counter() - t0

                pulls = [threading.Thread(target=pull, args=(i,))
                         for i in range(2)]
                for t in pulls:
                    t.start()
                for t in pulls:
                    t.join()
                row["two_pulls_s"] = list(secs)
                plain = got[:]
                # Again, each client's body into its reused pinned buffer.
                server.push_gradients(ones, wait=True)
                version, _ = server.slot.read()
                pulls = [threading.Thread(target=pull_into, args=(i,))
                         for i in range(2)]
                for t in pulls:
                    t.start()
                for t in pulls:
                    t.join()
                row["two_pulls_into_s"] = list(secs)
                into, got = got, plain
                conn = http_client(http.url)
                t0 = time.perf_counter()
                conn.request("GET", "/parameters.bin",
                             headers={"X-Have-Version": str(version - 1)})
                resp = conn.getresponse()
                body = resp.read()
                row["one_read_s"] = time.perf_counter() - t0
                conn.close()
                t0 = time.perf_counter()
                binwire.decode(body)
                row["decode_s"] = time.perf_counter() - t0
                del body
                bp = preds[0]
                state = state_dict_for(bp.module, got[0][1])
                t0 = time.perf_counter()
                fresh = copy.deepcopy(bp.module)
                row["install_module_copy_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                with copy_stream(bp.device):
                    fresh.load_state_dict(state)
                row["install_load_s"] = time.perf_counter() - t0
                del fresh, state
                t0 = time.perf_counter()
                preds[1].update_params(state_dict_for(preds[1].module,
                                                      got[1][1]))
                row["update_params_s"] = time.perf_counter() - t0
                t0 = time.perf_counter()
                preds[1].update_params(state_dict_for(preds[1].module,
                                                      into[1][1]))
                row["update_params_pinned_s"] = time.perf_counter() - t0
                del got, into, plain
                for mode, buf in (("loop", None), ("loop", reuse),
                                  ("waitall", None)):
                    key = f"loopback_{mode}_{'reused' if buf else 'fresh'}_s"
                    row[key] = loopback_s(payload, mode, buf)
                rows.append(row)
            finally:
                stop.set()
                for t in loops:
                    t.join()
    finally:
        for c in clients:
            c.close()
        http.stop()
        server.stop()
    return rows


def http_client(url: str) -> http.client.HTTPConnection:
    host, port = url.split("//", 1)[-1].rsplit(":", 1)
    return http.client.HTTPConnection(host, int(port), timeout=180)


if __name__ == "__main__":
    sys.exit(main())
