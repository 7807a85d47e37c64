"""Per-request RPC tracing across processes — the port of
``sparktorch_tpu/obs/rpctrace.py``.

The wire-latency histograms say *that* a pull's p99 rose; this module
says *where one slow request spent its time*, across the worker →
transport → shard fan-out → writer-thread boundary:

- **Span contexts** (:class:`SpanContext`): a 128-bit ``trace_id``, a
  64-bit ``span_id`` and a sampled bit. A client push or pull mints one
  (head sampling, :class:`RpcTracer`); every hop the request touches
  adds a CHILD span under it.
- **Propagation**: the context rides the binary wire as the optional
  ``FLAG_TRACE`` header extension (:mod:`sparktorch_tpu_torch.net.wire`;
  an untraced frame stays byte-identical) and as the
  ``X-Trace-Context`` HTTP header elsewhere, so ``BinaryTransport``,
  ``ShardedTransport``'s scatter/gather, the gateway, the parameter
  server's handler threads, the fleet's single-writer apply queues and
  the serving tier (router → replica → queue wait → execute) each
  attribute their share.
- **Sampling**: head-based at the root (``SPARKTORCH_TPU_RPC_SAMPLE``,
  default 0.01), plus an escape hatch: a root that takes longer than
  ``SPARKTORCH_TPU_RPC_SLO_S`` (default 1.0 s) is recorded even when
  the head said no (``forced=True``). Its downstream hops were told not
  to record, so a forced tree is the root alone.
- **Export**: completed spans land in a bounded ring
  (``SPARKTORCH_TPU_RPC_BUFFER``, default 512) on the owning
  :class:`~sparktorch_tpu_torch.obs.telemetry.Telemetry` bus as the
  ``rpc_spans`` section (so ``/telemetry`` scrapes, JSONL dumps and
  pickles carry them), as ``rpctrace.*`` counters, and as Chrome-trace
  JSON (:func:`write_chrome_trace`). :func:`stitch_spans` joins spans
  of several processes by ``trace_id`` into whole-request trees;
  :func:`critical_path` names the hop that bounded the latency;
  ``python -m sparktorch_tpu_torch.obs.timeline --rpc`` renders the
  waterfall, and the :class:`~sparktorch_tpu_torch.obs.collector.
  FleetCollector` stitches across every scraped rank.

Span contexts are minted only here: call sites go through
:meth:`RpcTracer.root_span`, :meth:`RpcTracer.child_span` and
:meth:`SpanContext.child`, which keeps sampling, SLO forcing and id
entropy in one place.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import threading
import time
import weakref
from collections import deque
from typing import Any, Dict, Iterable, List, Mapping, Optional

from sparktorch_tpu_torch.obs.telemetry import Telemetry, get_telemetry

SAMPLE_ENV = "SPARKTORCH_TPU_RPC_SAMPLE"
SLO_ENV = "SPARKTORCH_TPU_RPC_SLO_S"
BUFFER_ENV = "SPARKTORCH_TPU_RPC_BUFFER"

DEFAULT_SAMPLE_RATE = 0.01
DEFAULT_SLO_S = 1.0
DEFAULT_BUFFER = 512

TRACE_HEADER = "X-Trace-Context"

SECTION = "rpc_spans"           # per-process span ring, on the bus
TRACES_SECTION = "rpc_traces"   # collector-stitched whole-request trees


def _rand_hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class SpanContext:
    """The propagated identity of one request: ``trace_id`` (128-bit
    hex), ``span_id`` (64-bit hex — the CURRENT span, i.e. the parent
    of whatever the receiving hop starts), and the head-sampling
    decision. Immutable by convention; :meth:`child` derives the next
    hop's context."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id: str, span_id: str, sampled: bool):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    # -- factories (the wire's parse path; minting lives on the tracer)

    @classmethod
    def from_parts(cls, trace_id: str, span_id: str,
                   sampled: bool) -> "SpanContext":
        """Rebuild a context parsed OFF a wire (frame extension /
        header) — not a mint: the ids already exist upstream."""
        return cls(str(trace_id), str(span_id), bool(sampled))

    def child(self) -> "SpanContext":
        """The context a child span propagates: same trace, fresh
        span_id, same sampling decision."""
        return SpanContext(self.trace_id, _rand_hex(8), self.sampled)

    # -- HTTP header form ---------------------------------------------------

    def to_header(self) -> str:
        return f"{self.trace_id}-{self.span_id}-" \
               f"{'01' if self.sampled else '00'}"

    @classmethod
    def from_header(cls, value: Optional[str]) -> Optional["SpanContext"]:
        """Parse ``X-Trace-Context``; None on anything malformed — a
        garbled header must degrade to 'untraced', never 500 a
        handler."""
        if not value:
            return None
        parts = str(value).strip().split("-")
        if len(parts) != 3 or len(parts[0]) != 32 or len(parts[1]) != 16:
            return None
        try:
            int(parts[0], 16)
            int(parts[1], 16)
            flags = int(parts[2], 16)
        except ValueError:
            return None
        return cls(parts[0], parts[1], bool(flags & 1))

    def __repr__(self) -> str:  # debugging aid only
        return (f"SpanContext({self.trace_id[:8]}…/{self.span_id}, "
                f"sampled={self.sampled})")


class RpcSpan:
    """One hop's timed contribution, yielded by the tracer's span
    context managers. ``ctx`` is the context CHILD hops should
    propagate (``None`` on a disabled span — every downstream helper
    treats that as 'don't record')."""

    __slots__ = ("name", "kind", "ctx", "parent_id", "ann", "ts", "t0",
                 "t_end", "dur_s", "status", "error", "forced")

    def __init__(self, name: str, kind: str, ctx: Optional[SpanContext],
                 parent_id: Optional[str], ann: Dict[str, Any]):
        self.name = name
        self.kind = kind
        self.ctx = ctx
        self.parent_id = parent_id
        self.ann = ann
        self.ts = time.time()          # wall clock: cross-process joinable
        self.t0 = time.perf_counter()  # monotonic: the honest duration
        self.t_end: Optional[float] = None
        self.dur_s: Optional[float] = None
        self.status = "ok"
        self.error: Optional[str] = None
        self.forced = False

    def annotate(self, **kv: Any) -> None:
        self.ann.update(kv)

    def end_at(self, t: Optional[float]) -> None:
        """End the span at ``t`` (a ``time.perf_counter()`` reading)
        rather than at its block's exit; None keeps the exit."""
        self.t_end = t

    def set_error(self, exc: BaseException) -> None:
        self.status = "error"
        self.error = f"{type(exc).__name__}: {exc}"

    def to_dict(self) -> Dict[str, Any]:
        return {
            "trace_id": self.ctx.trace_id if self.ctx else None,
            "span_id": self.ctx.span_id if self.ctx else None,
            "parent_id": self.parent_id,
            "name": self.name,
            "kind": self.kind,
            "ts": self.ts,
            "dur_s": self.dur_s,
            "status": self.status,
            "error": self.error,
            "forced": self.forced,
            "ann": dict(self.ann),
        }


class _DisabledSpan:
    """The no-op span an unsampled request flows through: annotations
    vanish, ``ctx`` is None so child hops no-op too. One shared
    instance — it holds no state."""

    __slots__ = ()
    ctx = None
    name = kind = status = error = None
    dur_s = None

    def annotate(self, **kv: Any) -> None:
        pass

    def end_at(self, t: Optional[float]) -> None:
        pass

    def set_error(self, exc: BaseException) -> None:
        pass


_DISABLED = _DisabledSpan()

# The shared context every UNSAMPLED root flows through: children
# check ``sampled`` and never touch the ids, and the SLO escape hatch
# mints real ids only at force-commit time — so the per-request fast
# path pays no ``os.urandom`` syscalls (two getrandom calls per op
# were measurable against sub-millisecond 304 pulls).
_UNSAMPLED = SpanContext("", "", False)


class RpcTracer:
    """Per-bus span recorder: head sampling, the SLO escape hatch, and
    the bounded completed-span ring published as the bus's
    ``rpc_spans`` section (scrape == dump, like every other obs
    surface). Cheap when idle: an unsampled root costs one RNG draw
    and two ``perf_counter`` calls; children of unsampled requests
    cost a None check.

    Use :func:`tracer_for` rather than constructing directly — one
    tracer per Telemetry bus, so client and server spans of an
    in-process topology land in one ring.
    """

    def __init__(self, telemetry: Optional[Telemetry] = None,
                 sample_rate: Optional[float] = None,
                 slo_s: Optional[float] = None,
                 buffer_size: Optional[int] = None,
                 seed: Optional[int] = None):
        self.telemetry = telemetry or get_telemetry()
        if sample_rate is None:
            sample_rate = float(os.environ.get(SAMPLE_ENV,
                                               DEFAULT_SAMPLE_RATE))
        if slo_s is None:
            slo_s = float(os.environ.get(SLO_ENV, DEFAULT_SLO_S))
        if buffer_size is None:
            buffer_size = int(os.environ.get(BUFFER_ENV, DEFAULT_BUFFER))
        # sample_rate < 0 turns the tracer fully OFF (no root spans at
        # all — the bench's untraced control leg); 0.0 keeps the SLO
        # escape hatch armed.
        self.sample_rate = float(sample_rate)
        self.slo_s = float(slo_s)
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=max(1,
                                                               buffer_size))
        self.dropped = 0

    @property
    def enabled(self) -> bool:
        return self.sample_rate >= 0.0

    def _sample(self) -> bool:
        if self.sample_rate <= 0.0:
            return False
        if self.sample_rate >= 1.0:
            return True
        with self._lock:
            return self._rng.random() < self.sample_rate

    # -- recording ----------------------------------------------------------

    def _commit(self, span: RpcSpan) -> None:
        doc = span.to_dict()
        tele = self.telemetry
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(doc)
            section = {
                "n": len(self._ring),
                "dropped": self.dropped,
                "spans": list(self._ring),
            }
        tele.set_section(SECTION, section)
        tele.counter("rpctrace.spans_total", labels={"kind": span.kind})
        if span.status == "error":
            tele.counter("rpctrace.span_errors_total",
                         labels={"kind": span.kind})
        if span.forced:
            tele.counter("rpctrace.slo_forced_total")

    @property
    def spans(self) -> List[Dict[str, Any]]:
        """The completed-span ring (oldest first)."""
        with self._lock:
            return list(self._ring)

    def resize(self, buffer_size: int) -> None:
        """Grow/shrink the completed-span ring in place (a bench or a
        soak that must hold every span of a bounded run resizes up
        front instead of racing eviction)."""
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(buffer_size)))

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self.dropped = 0
        self.telemetry.set_section(SECTION, None)

    # -- the span API -------------------------------------------------------

    @contextlib.contextmanager
    def root_span(self, name: str, kind: str = "client", **ann: Any):
        """Mint a request: the ONE place new trace_ids come from. The
        head sampling decision is taken here and propagated via the
        yielded span's ``ctx``; an unsampled root is still timed so
        the SLO escape hatch can force-record it (root only — its
        children were told not to record)."""
        if not self.enabled:
            yield _DISABLED
            return
        sampled = self._sample()
        ctx = (SpanContext(_rand_hex(16), _rand_hex(8), True)
               if sampled else _UNSAMPLED)
        span = RpcSpan(name, kind, ctx, None, dict(ann))
        try:
            yield span
        except BaseException as e:
            span.set_error(e)
            raise
        finally:
            span.dur_s = time.perf_counter() - span.t0
            if sampled:
                self._commit(span)
            elif self.slo_s > 0 and span.dur_s >= self.slo_s:
                # Ids minted only now: the escape hatch is rare by
                # definition, the fast path stays syscall-free.
                span.ctx = SpanContext(_rand_hex(16), _rand_hex(8),
                                       False)
                span.forced = True
                self._commit(span)

    @contextlib.contextmanager
    def child_span(self, name: str, parent: Optional[SpanContext],
                   kind: str = "internal", **ann: Any):
        """One hop under ``parent`` (a SpanContext from a sibling span
        or off the wire). No-ops — yielding the shared disabled
        span — when the parent is absent or unsampled, so untraced
        requests pay a None check per hop."""
        if parent is None or not parent.sampled or not self.enabled:
            yield _DISABLED
            return
        ctx = parent.child()
        span = RpcSpan(name, kind, ctx, parent.span_id, dict(ann))
        try:
            yield span
        except BaseException as e:
            span.set_error(e)
            raise
        finally:
            end = span.t_end if span.t_end is not None else time.perf_counter()
            span.dur_s = end - span.t0
            self._commit(span)

    def record(self, name: str, parent: Optional[SpanContext],
               start_ts: float, dur_s: float, kind: str = "internal",
               status: str = "ok", **ann: Any) -> None:
        """Record an after-the-fact span — a region whose boundaries
        were observed as timestamps rather than lived in a with-block
        (the writer thread's QUEUE-WAIT: enqueue happened on a handler
        thread, the pop on the writer; nobody 'was inside' the wait).
        """
        if parent is None or not parent.sampled or not self.enabled:
            return
        ctx = parent.child()
        span = RpcSpan(name, kind, ctx, parent.span_id, dict(ann))
        span.ts = float(start_ts)
        span.dur_s = float(dur_s)
        span.status = status
        self._commit(span)


# ---------------------------------------------------------------------------
# One tracer per Telemetry bus
# ---------------------------------------------------------------------------

_TRACERS: "weakref.WeakKeyDictionary[Telemetry, RpcTracer]" = (
    weakref.WeakKeyDictionary()
)
_TRACERS_LOCK = threading.Lock()


def tracer_for(telemetry: Optional[Telemetry] = None) -> RpcTracer:
    """The tracer bound to ``telemetry`` (the process-global bus when
    None), created on first use. Client and server components sharing
    a bus share one span ring — which is what makes an in-process
    fleet's whole-request tree assemble from a single scrape."""
    tele = telemetry or get_telemetry()
    with _TRACERS_LOCK:
        tracer = _TRACERS.get(tele)
        if tracer is None:
            tracer = _TRACERS[tele] = RpcTracer(tele)
        return tracer


# ---------------------------------------------------------------------------
# Stitching: spans -> whole-request trees
# ---------------------------------------------------------------------------


def stitch_spans(spans: Iterable[Mapping[str, Any]],
                 max_traces: Optional[int] = None) -> List[Dict[str, Any]]:
    """Join completed spans (possibly scraped from SEVERAL process
    buses) into per-request trees, newest root first.

    Each tree document: ``trace_id``, ``n_spans``, ``wall_s`` (the
    root's duration), ``root`` (the span dict with nested
    ``children``, each child list in start order), ``orphans`` (spans
    whose parent never arrived — a hop whose recorder was scraped but
    whose parent's ring already evicted, kept visible rather than
    dropped), and ``critical`` (:func:`critical_summary` of the
    root). Spans are deduplicated by span_id — the same process
    scraped under two collector targets must not double its hops."""
    by_trace: Dict[str, Dict[str, Dict[str, Any]]] = {}
    for s in spans:
        tid, sid = s.get("trace_id"), s.get("span_id")
        if not tid or not sid:
            continue
        by_trace.setdefault(tid, {}).setdefault(sid, dict(s))
    trees: List[Dict[str, Any]] = []
    for tid, nodes in by_trace.items():
        for n in nodes.values():
            n["children"] = []
        roots: List[Dict[str, Any]] = []
        orphans: List[Dict[str, Any]] = []
        for n in nodes.values():
            pid = n.get("parent_id")
            if pid and pid in nodes:
                nodes[pid]["children"].append(n)
            elif pid:
                orphans.append(n)
            else:
                roots.append(n)
        for n in nodes.values():
            n["children"].sort(key=lambda c: float(c.get("ts", 0.0)))
        if not roots:
            if not orphans:
                continue
            # No true root scraped (evicted or unsampled-forced
            # elsewhere): promote the earliest orphan so the partial
            # tree still renders.
            orphans.sort(key=lambda n: float(n.get("ts", 0.0)))
            roots = [orphans.pop(0)]
            roots[0]["orphan_root"] = True
        roots.sort(key=lambda n: float(n.get("ts", 0.0)))
        root = roots[0]
        trees.append({
            "trace_id": tid,
            "n_spans": len(nodes),
            "wall_s": float(root.get("dur_s") or 0.0),
            "root": root,
            "extra_roots": roots[1:],
            "orphans": orphans,
            "critical": critical_summary(root),
        })
    trees.sort(key=lambda t: float(t["root"].get("ts", 0.0)), reverse=True)
    if max_traces is not None:
        trees = trees[:max_traces]
    return trees


def critical_path(root: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """The chain of spans that actually bounded the root's latency.

    Walk from each span's END backwards: repeatedly pick the child
    whose interval is live at the cursor (latest end first), jump the
    cursor to that child's start, and recurse into every picked child.
    Time not covered by picked children is the span's SELF time on
    the path — the quantity that names the bounding hop. Robust to
    small cross-process clock skew: no child-inside-parent assumption.

    Returns path entries root-first: ``{name, span_id, kind, shard,
    dur_s, self_s}``.
    """
    path: List[Dict[str, Any]] = []

    def _walk(node: Mapping[str, Any]) -> None:
        start = float(node.get("ts", 0.0))
        dur = float(node.get("dur_s") or 0.0)
        end = start + dur
        kids = list(node.get("children") or [])
        kids.sort(key=lambda c: float(c.get("ts", 0.0))
                  + float(c.get("dur_s") or 0.0), reverse=True)
        cursor = end
        picked: List[Mapping[str, Any]] = []
        for c in kids:
            c_start = float(c.get("ts", 0.0))
            if c_start >= cursor:
                continue  # entirely after the cursor: off the path
            picked.append(c)
            cursor = c_start
            if cursor <= start:
                break
        covered = sum(min(float(c.get("dur_s") or 0.0), dur)
                      for c in picked)
        path.append({
            "name": node.get("name"),
            "span_id": node.get("span_id"),
            "kind": node.get("kind"),
            "shard": (node.get("ann") or {}).get("shard"),
            "dur_s": dur,
            "self_s": max(dur - covered, 0.0),
        })
        for c in sorted(picked, key=lambda c: float(c.get("ts", 0.0))):
            _walk(c)

    _walk(root)
    return path


def critical_summary(root: Mapping[str, Any]) -> Dict[str, Any]:
    """Condense :func:`critical_path` to the answer an operator wants:
    WHICH hop bounded this request (largest self time on the path),
    what fraction of the root wall it owns, and the shard it ran on
    (the entry's own ``shard`` annotation, else the nearest path
    ancestor's — an ``apply`` span inherits its shard from the serving
    hop above it)."""
    path = critical_path(root)
    wall = float(root.get("dur_s") or 0.0)
    shard = None
    best: Optional[Dict[str, Any]] = None
    best_shard = None
    for entry in path:
        if entry.get("shard") is not None:
            shard = entry["shard"]
        if best is None or entry["self_s"] > best["self_s"]:
            best = entry
            best_shard = entry.get("shard", shard) or shard
    if best is None:
        return {"name": None, "shard": None, "self_s": 0.0,
                "fraction": 0.0, "path": []}
    return {
        "name": best["name"],
        "kind": best.get("kind"),
        "shard": best_shard,
        "self_s": round(best["self_s"], 6),
        "fraction": round(best["self_s"] / wall, 4) if wall > 0 else 0.0,
        # span_id included so renderers can star the path's spans in
        # the tree (the waterfall's `*` column keys on it).
        "path": [{k: e[k] for k in ("name", "shard", "self_s",
                                    "span_id")}
                 for e in path],
    }


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------


def to_chrome_trace(spans: Iterable[Mapping[str, Any]],
                    service: str = "rpc") -> Dict[str, Any]:
    """Spans -> the Chrome trace-event JSON shape
    (``chrome://tracing`` / Perfetto loads it; the same format
    ``obs.xprof`` reads from ``torch.profiler``). One 'X' complete
    event per span; pid groups by kind (client vs server lanes), tid
    by trace so concurrent requests stack as separate rows."""
    events = []
    for s in spans:
        if not s.get("trace_id"):
            continue
        args = {k: v for k, v in (s.get("ann") or {}).items()}
        args.update({
            "trace_id": s.get("trace_id"),
            "span_id": s.get("span_id"),
            "status": s.get("status"),
        })
        if s.get("error"):
            args["error"] = s["error"]
        events.append({
            "ph": "X",
            "name": str(s.get("name")),
            "cat": str(s.get("kind") or "rpc"),
            "pid": f"{service}:{s.get('kind') or 'rpc'}",
            "tid": str(s.get("trace_id"))[:8],
            "ts": float(s.get("ts", 0.0)) * 1e6,
            "dur": float(s.get("dur_s") or 0.0) * 1e6,
            "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: Iterable[Mapping[str, Any]],
                       service: str = "rpc") -> str:
    """Write the Chrome-trace export (tmp + rename, like every other
    obs artifact: a killed exporter must not leave a torn file)."""
    doc = to_chrome_trace(spans, service=service)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# Section readers (timeline / collector input)
# ---------------------------------------------------------------------------


def spans_from_snapshot(snapshot: Mapping[str, Any]) -> List[Dict[str, Any]]:
    """The ``rpc_spans`` ring out of one telemetry snapshot dict (a
    ``/telemetry`` scrape or a JSONL dump record); [] when absent."""
    section = (snapshot.get("sections") or {}).get(SECTION)
    if not isinstance(section, Mapping):
        return []
    spans = section.get("spans")
    return [dict(s) for s in spans] if isinstance(spans, list) else []
