"""sparktorch_tpu_torch.obs — the core of the telemetry bus.

One bus (:class:`Telemetry`) shared by the serving tier and
``BatchPredictor``: nestable timed spans, monotonic counters,
histogram metrics with p50/p95/p99 roll-ups, gauges. Sinks stream
JSONL events; per-rank heartbeats give the router its liveness signal.
All of it is a copy of the JAX package's ``obs/telemetry.py``,
``obs/sinks.py`` and ``obs/heartbeat.py``.

The rest of the JAX ``obs/`` (Prometheus rendering, history, alerts,
the flight recorder, goodput, health, replay, xprof, the fleet
collector, rpctrace, the stack profiler, timeline, skew) is not ported
yet (ROADMAP, Queue 1, item 10).
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
    "HEARTBEAT_DIR_ENV",
    "HeartbeatEmitter",
    "gang_report",
    "read_heartbeats",
]
