"""The port's trace analyzer (``obs/xprof.py``) against the JAX package's.

The JAX package's golden captures (``tests/fixtures/xprof/``) are
translated into ``torch.profiler``'s shape: each event the JAX analyzer
counts as a device op becomes a ``kernel`` on a device lane (a
collective named as an NCCL kernel), each ``train_step`` marker a host
``user_annotation`` range plus its ``gpu_user_annotation`` projection,
everything else host work (``cpu_op``). The port's analysis of the
translation must equal the JAX analysis of the original, and both
packages' ``merge_analyses`` must fold the same documents alike. A real
CPU capture of a port fit is analysed too.
"""

import gzip
import json
import os

import numpy as np
import pytest

from sparktorch_tpu.obs import xprof as jax_xprof
from sparktorch_tpu_torch.obs import Telemetry, xprof

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "xprof")
NCCL = "ncclDevKernel_"


def _load(name):
    with gzip.open(os.path.join(FIXTURES, name + ".trace.json.gz"), "rt") as f:
        return json.load(f)


def _device_keys(events):
    """The X events the JAX analyzer takes as device ops (its lane and
    name rules), by index."""
    names = {(e.get("pid"), e.get("tid")): str((e.get("args") or {})
                                                .get("name", ""))
             for e in events if isinstance(e, dict) and e.get("ph") == "M"
             and e.get("name") == "thread_name"}
    op_lanes = {k for k, v in names.items() if "xla ops" in v.lower()}
    out = set()
    for i, e in enumerate(events):
        if not isinstance(e, dict) or e.get("ph") != "X" \
                or e.get("name") == "train_step":
            continue
        key = (e.get("pid"), e.get("tid"))
        name = str(e.get("name", ""))
        if op_lanes:
            if key in op_lanes:
                out.add(i)
        elif not (jax_xprof._is_host_name(name) or names.get(key) == "python"):
            out.add(i)
    return out


def to_torch_shape(data):
    """A JAX capture in ``torch.profiler``'s shape; returns the trace and
    the number of device projections added."""
    events = data["traceEvents"]
    device = _device_keys(events)
    out, added = [], 0
    for i, e in enumerate(events):
        if not isinstance(e, dict) or e.get("ph") != "X":
            continue
        base = {k: e[k] for k in ("ts", "dur") if k in e}
        name = str(e.get("name", ""))
        if name == "train_step":
            args = dict(e.get("args") or {}, **{"External id": i})
            out.append(dict(base, ph="X", cat="user_annotation",
                            name=name, pid=1, tid=1, args=args))
            out.append(dict(base, ph="X", cat="gpu_user_annotation",
                            name=name, pid=0, tid=7, args=args))
            added += 1
        elif i in device:
            family = jax_xprof.classify_op(name)
            out.append(dict(base, ph="X", cat="kernel",
                            name=NCCL + name if family else name,
                            pid=0, tid=e.get("tid")))
        else:
            out.append(dict(base, ph="X", cat="cpu_op", name=name, pid=1,
                            tid=1))
    return {"traceEvents": out}, added


def _port_doc(doc, added):
    doc = dict(doc)
    doc["n_events"] -= added
    doc["top_ops"] = [dict(op, name=op["name"][len(NCCL):]
                           if op["name"].startswith(NCCL) else op["name"])
                      for op in doc["top_ops"]]
    return doc


@pytest.mark.parametrize("fixture", ["synthetic_overlap", "cpu_allreduce",
                                     "cpu_moe_a2a"])
def test_translated_fixture_analysis_equals_jax(fixture):
    data = _load(fixture)
    want = jax_xprof.analyze_trace(data).to_dict()
    trace, added = to_torch_shape(data)
    got = _port_doc(xprof.analyze_trace(trace).to_dict(), added)
    assert got == want
    assert want["n_steps"] >= 1


def test_merge_analyses_folds_alike():
    docs = []
    for fixture in ("synthetic_overlap", "cpu_allreduce"):
        docs.append(jax_xprof.analyze_trace(_load(fixture)).to_dict())
    docs.append(dict(docs[0], steps=[dict(s, wall_s=s["wall_s"] * 1.5)
                                     for s in docs[0]["steps"]]))
    for ranks in (None, ["a", "b", "c"]):
        got = xprof.merge_analyses(docs, ranks=ranks, run_id="r").to_dict()
        want = jax_xprof.merge_analyses(docs, ranks=ranks,
                                        run_id="r").to_dict()
        assert got == want
    assert xprof.wall_stats([3.0, 1.0, 2.0]) == jax_xprof.wall_stats(
        [3.0, 1.0, 2.0])


@pytest.mark.parametrize("name,family", [
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "all_reduce"),
    ("ncclKernel_AllGather_RING_LL_Sum_int8_t", "all_gather"),
    ("ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL", "reduce_scatter"),
    ("ncclDevKernel_SendRecv", "send_recv"),
    ("ncclDevKernel_Broadcast_RING_LL", "send_recv"),
    ("c10d::allreduce_", "all_reduce"),
    ("c10d::_allgather_base_", "all_gather"),
    ("c10d::_reduce_scatter_base_", "reduce_scatter"),
    ("c10d::alltoall_base_", "all_to_all"),
    ("c10d::broadcast_", "send_recv"),
    ("gloo:all_reduce", "all_reduce"),
    ("nccl:all_reduce", "all_reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, SendOp>", None),
    ("aten::addmm", None),
])
def test_family_of_torch_names(name, family):
    assert xprof._family(name) == family


def _fit_trace(tmp_path, mesh=None):
    from sparktorch_tpu_torch import serialize_torch_obj
    from sparktorch_tpu_torch.models import MnistMLP
    from sparktorch_tpu_torch.train.sync import train_distributed

    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 784)).astype(np.float32)
    y = rng.integers(0, 10, 64)
    tele = Telemetry(run_id="xprof")
    obj = serialize_torch_obj(MnistMLP(hidden=(16,)),
                              criterion="cross_entropy", optimizer="adam",
                              input_shape=(784,))
    train_distributed(obj, x, labels=y, iters=4, steps_per_call=1,
                      telemetry=tele, profile_dir=str(tmp_path),
                      device="cpu", mesh=mesh)
    return tele


def test_cpu_capture_of_a_port_fit(tmp_path):
    tele = _fit_trace(tmp_path)
    doc = tele.get_section("xprof")
    assert doc["n_steps"] == doc["n_markers"] == 4 == \
        tele.counter_value("tracing.annotated_steps")
    assert doc["comm_s"] == 0 and doc["compute_s"] > 0
    assert all(s["compute_s"] <= s["window_s"] for s in doc["steps"])
    assert tele.counter_value("xprof.analyses_total") == 1
    assert tele.counter_value("xprof.capture_truncated_total") == 0
    hist = tele.histogram("xprof.step_wall_s")
    assert hist["count"] == 4


def test_gloo_world_of_one_shows_its_all_reduce(tmp_path):
    import torch.distributed as dist

    from sparktorch_tpu_torch.parallel.mesh import build_mesh

    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:0",
                            rank=0, world_size=1)
    try:
        tele = _fit_trace(tmp_path, mesh=build_mesh())
    finally:
        dist.destroy_process_group()
    doc = tele.get_section("xprof")
    assert doc["n_steps"] == 4
    assert doc["collective_s"].get("all_reduce", 0) > 0
    assert doc["collective_counts"]["all_reduce"] >= 4


def test_torn_and_truncated_captures(tmp_path):
    torn = tmp_path / "torn"
    torn.mkdir()
    (torn / "host.pt.trace.json").write_text('{"traceEvents": [')
    tele = Telemetry()
    assert xprof.analyze_and_publish(str(torn), telemetry=tele) is None
    assert tele.counter_value("xprof.analyze_failures") == 1
    trace, _ = to_torch_shape(_load("synthetic_overlap"))
    ok = tmp_path / "ok"
    ok.mkdir()
    (ok / "host.pt.trace.json").write_text(json.dumps(trace))
    assert xprof.analyze_and_publish(str(ok), telemetry=tele,
                                     expected_steps=5) is not None
    assert tele.counter_value("xprof.capture_truncated_total") == 1
