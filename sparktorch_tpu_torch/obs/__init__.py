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
passed), under the JAX package's names. Beside it, copies of the JAX
package's retained history (:class:`MetricsHistory`) and alert rules
(:class:`AlertRule`, :class:`AlertManager`), the flight recorder and
postmortem bundles (``obs/blackbox.py``), the goodput ledger and the
cross-rank skew ring (``obs/goodput.py``, ``obs/skew.py``), the stack
profiler (``obs/profile.py``), the trainers' model-health lane and its
bitwise replay (``obs/health.py``, ``obs/replay.py``), the
``torch.profiler`` trace analyzer (``obs/xprof.py``), the fleet
collector (``obs/collector.py``), the per-request RPC tracer
(``obs/rpctrace.py``) and the terminal renderer of all of them
(``python -m sparktorch_tpu_torch.obs.timeline``).
"""

from sparktorch_tpu_torch.obs.telemetry import (
    Span,
    Telemetry,
    format_key,
    get_telemetry,
    set_telemetry,
    wall_ts,
)
from sparktorch_tpu_torch.obs.history import MetricsHistory
from sparktorch_tpu_torch.obs.alerts import AlertManager, AlertRule
from sparktorch_tpu_torch.obs.blackbox import (
    FlightRecorder,
    attach_recorder,
    collect_postmortem,
    read_postmortem,
)
from sparktorch_tpu_torch.obs.goodput import (
    GoodputLedger,
    LedgerSpan,
    mfu_honest,
)
from sparktorch_tpu_torch.obs.health import (
    HealthConfig,
    TrainHealthLedger,
    health_alert_rules,
    tree_checksum,
)
from sparktorch_tpu_torch.obs.replay import load_bundle, replay_bundle
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
from sparktorch_tpu_torch.obs.xprof import (
    GangAnalysis,
    TraceAnalysis,
    TraceParseError,
    analyze_and_publish,
    analyze_trace,
    merge_analyses,
)
from sparktorch_tpu_torch.obs.collector import (
    FleetCollector,
    ScrapeError,
    mint_run_id,
    run_tag,
    scrape_json,
    scrape_text,
    snapshot_histogram,
)
from sparktorch_tpu_torch.obs.rpctrace import (
    RpcTracer,
    SpanContext,
    critical_path,
    critical_summary,
    stitch_spans,
    tracer_for,
    write_chrome_trace,
)

__all__ = [
    "Span",
    "Telemetry",
    "format_key",
    "get_telemetry",
    "set_telemetry",
    "wall_ts",
    "MetricsHistory",
    "AlertManager",
    "AlertRule",
    "FlightRecorder",
    "attach_recorder",
    "collect_postmortem",
    "read_postmortem",
    "GoodputLedger",
    "LedgerSpan",
    "mfu_honest",
    "HealthConfig",
    "TrainHealthLedger",
    "health_alert_rules",
    "tree_checksum",
    "load_bundle",
    "replay_bundle",
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
    "GangAnalysis",
    "TraceAnalysis",
    "TraceParseError",
    "analyze_and_publish",
    "analyze_trace",
    "merge_analyses",
    "FleetCollector",
    "ScrapeError",
    "mint_run_id",
    "run_tag",
    "scrape_json",
    "scrape_text",
    "snapshot_histogram",
    "RpcTracer",
    "SpanContext",
    "critical_path",
    "critical_summary",
    "stitch_spans",
    "tracer_for",
    "write_chrome_trace",
]
