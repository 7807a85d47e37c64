"""sparktorch_tpu_torch.obs — the core of the telemetry bus.

One bus (:class:`Telemetry`) shared by the serving tier and
``BatchPredictor``: nestable timed spans, monotonic counters,
histogram metrics with p50/p95/p99 roll-ups, gauges. Sinks stream
JSONL events; per-rank heartbeats give the router and the gang their
liveness signal; the Prometheus renderer serves the same snapshot as
exposition text (the parameter server's ``GET /metrics``); the library
logger carries the trainers' progress lines. All of it is a copy of the
JAX package's ``obs/telemetry.py``, ``obs/sinks.py``,
``obs/heartbeat.py``, ``obs/prom.py`` and ``obs/log.py``.

The trainers, the parameter server and the hogwild workers record into
this bus (the process-global one unless a run-scoped ``telemetry=`` is
passed), under the JAX package's names. The rest of the JAX ``obs/``
(history, alerts, the flight recorder, goodput, health, replay, xprof,
the fleet collector, rpctrace, the stack profiler, timeline, skew) is
not ported yet (ROADMAP, Queue 1, item 10, step 4).
"""

from sparktorch_tpu_torch.obs.telemetry import (
    Span,
    Telemetry,
    format_key,
    get_telemetry,
    set_telemetry,
    wall_ts,
)
from sparktorch_tpu_torch.obs.sinks import JsonlSink, read_jsonl, write_jsonl
from sparktorch_tpu_torch.obs.log import get_logger
from sparktorch_tpu_torch.obs.prom import (
    CONTENT_TYPE as PROMETHEUS_CONTENT_TYPE,
    parse_prometheus,
    render_prometheus,
)
from sparktorch_tpu_torch.obs.heartbeat import (
    HEARTBEAT_DIR_ENV,
    HeartbeatEmitter,
    gang_report,
    read_heartbeats,
)

__all__ = [
    "Span",
    "Telemetry",
    "format_key",
    "get_telemetry",
    "set_telemetry",
    "wall_ts",
    "JsonlSink",
    "read_jsonl",
    "write_jsonl",
    "get_logger",
    "PROMETHEUS_CONTENT_TYPE",
    "parse_prometheus",
    "render_prometheus",
    "HEARTBEAT_DIR_ENV",
    "HeartbeatEmitter",
    "gang_report",
    "read_heartbeats",
]
