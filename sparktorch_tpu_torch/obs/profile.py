"""Continuous ledger-keyed stack profiler — a copy of ``sparktorch_tpu/obs/profile.py``.

:class:`StackProfiler` is a wall-clock sampler: a daemon thread walks
``sys._current_frames()`` at a configurable rate (default ~67 Hz) and
tags every sample with the goodput bucket open on that thread, through
:func:`~sparktorch_tpu_torch.obs.goodput.open_span_buckets`. Samples
fold into bounded per-bucket tries (root first, so they render as
top-down trees) published as the throttled ``profile`` telemetry
section. A thread with no open span lands in ``unattributed``; a
``step`` span reads as ``compute``.

An :mod:`~sparktorch_tpu_torch.obs.alerts` firing
(:meth:`StackProfiler.attach_alerts`) opens a high-rate burst window
and drops a ``profile_trace`` event into the flight recorder's ring;
:func:`merge_sections` folds per-rank sections and :func:`diff_docs`
names the frames that moved between two profiles. Postmortem bundles
carry the profile beside the event ring.

Installation is ambient like the ledger's: servers and trainers call
:func:`ensure` (gated by the environment: ``SPARKTORCH_TPU_PROFILE=0``
disables, ``SPARKTORCH_TPU_PROFILE_HZ`` sets the rate); processes that
own their lifecycle (``ctl/worker``) build a :class:`StackProfiler`
directly and stop it when they exit.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

from sparktorch_tpu_torch.obs import goodput as _goodput
from sparktorch_tpu_torch.obs.telemetry import Telemetry, wall_ts

SECTION = "profile"
RUN_SECTION = "profile_run"

#: Bucket a sample lands in when its thread has no open LedgerSpan.
UNATTRIBUTED = "unattributed"

DEFAULT_HZ = 67.0
DEFAULT_BURST_HZ = 400.0
DEFAULT_BURST_S = 2.0

ENV_GATE = "SPARKTORCH_TPU_PROFILE"
ENV_HZ = "SPARKTORCH_TPU_PROFILE_HZ"


def _new_node() -> Dict[str, Any]:
    return {"samples": 0, "self": 0, "children": {}}


class StackProfiler:
    """One process's continuous sampler. ``start()`` spawns the daemon
    thread; ``stop()`` joins it and publishes the final section.
    Thread-safe: the trie is mutated only under ``_lock`` (held for
    one fold at a time — microseconds, never across a sleep).

    The trie is bounded three ways so a long run cannot grow it
    without limit: stacks deeper than ``max_depth`` truncate (counted
    in ``truncated``), a node's children cap at ``max_children`` and a
    bucket's total nodes at ``max_nodes`` — overflow folds into an
    ``(other)`` child so samples are never dropped, only coarsened."""

    def __init__(self, telemetry: Optional[Telemetry] = None,
                 rank: Optional[Any] = None,
                 hz: float = DEFAULT_HZ,
                 publish_interval_s: float = 1.0,
                 max_depth: int = 64,
                 max_children: int = 32,
                 max_nodes: int = 512):
        self.telemetry = telemetry
        self.rank = rank
        self.hz = max(float(hz), 0.1)
        self.publish_interval_s = float(publish_interval_s)
        self.max_depth = int(max_depth)
        self.max_children = int(max_children)
        self.max_nodes = int(max_nodes)
        self.started_ts = wall_ts()
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._buckets: Dict[str, Dict[str, Any]] = {}
        self._node_counts: Dict[str, int] = {}
        self._samples_total = 0
        self._ticks = 0
        self._truncated = 0
        self._sample_time_s = 0.0
        self._burst_until = 0.0
        self._burst_hz = DEFAULT_BURST_HZ
        self._bursts = 0
        self._last_publish = 0.0
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None
        self._alert_cb = None
        self._alert_mgr = None

    # -- sampling ------------------------------------------------------------

    @staticmethod
    def _frame_key(frame) -> str:
        code = frame.f_code
        return (f"{code.co_name} "
                f"({os.path.basename(code.co_filename)}"
                f":{code.co_firstlineno})")

    def _child(self, bucket: str, parent: Dict[str, Any],
               key: str) -> Dict[str, Any]:
        children = parent["children"]
        node = children.get(key)
        if node is not None:
            return node
        # Budget check: per-parent fanout and per-bucket total. The
        # "(other)" catch-all coarsens instead of dropping.
        if (len(children) >= self.max_children
                or self._node_counts.get(bucket, 0) >= self.max_nodes):
            node = children.get("(other)")
            if node is None:
                node = children["(other)"] = _new_node()
                self._node_counts[bucket] = (
                    self._node_counts.get(bucket, 0) + 1)
            return node
        node = children[key] = _new_node()
        self._node_counts[bucket] = self._node_counts.get(bucket, 0) + 1
        return node

    def _fold(self, bucket: str, keys: List[str]) -> None:
        """Insert one root-first frame path; 'samples' on every node
        along it, 'self' on the leaf."""
        root = self._buckets.get(bucket)
        if root is None:
            root = self._buckets[bucket] = _new_node()
        root["samples"] += 1
        node = root
        for key in keys:
            node = self._child(bucket, node, key)
            node["samples"] += 1
        node["self"] += 1

    def sample_once(self) -> int:
        """One sweep over every live thread's current frame; returns
        the number of samples folded. The sampler loop calls this, and
        tests may drive it directly (deterministic, no thread)."""
        t0 = time.perf_counter()
        me = threading.get_ident()
        frames = sys._current_frames()
        span_buckets = _goodput.open_span_buckets()
        n = 0
        with self._lock:
            for ident, frame in frames.items():
                if ident == me:
                    continue
                keys: List[str] = []
                f = frame
                while f is not None:
                    keys.append(self._frame_key(f))
                    f = f.f_back
                keys.reverse()  # root first
                if len(keys) > self.max_depth:
                    # Keep the LEAF side: self-time attribution (the
                    # bench/diff signal) must survive truncation, so
                    # the sacrificed frames are the root boilerplate.
                    keys = keys[-self.max_depth:]
                    self._truncated += 1
                self._fold(span_buckets.get(ident, UNATTRIBUTED), keys)
                n += 1
            self._samples_total += n
            self._ticks += 1
            self._sample_time_s += time.perf_counter() - t0
        return n

    def _loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            tick0 = time.perf_counter()
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 - sampler must never die
                pass
            if (self.telemetry is not None
                    and tick0 - self._last_publish
                    >= self.publish_interval_s):
                # Published from the sampler thread itself, throttled:
                # a SIGKILLed process's last throttled publish is what
                # the collector's last-good snapshot (and therefore
                # its postmortem bundle) holds.
                try:
                    self.publish()
                except Exception:  # noqa: BLE001
                    pass
            hz = (self._burst_hz
                  if time.perf_counter() < self._burst_until else self.hz)
            elapsed = time.perf_counter() - tick0
            stop.wait(max(1.0 / hz - elapsed, 0.0005))

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "StackProfiler":
        if self._thread is not None:
            return self
        stop = self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, args=(stop,), daemon=True,
            name="stack-profiler")
        self._thread.start()
        return self

    def stop(self) -> Dict[str, Any]:
        """Join the sampler and publish the final section."""
        if self._stop is not None:
            self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
            self._stop = None
        if self._alert_mgr is not None and self._alert_cb is not None:
            try:
                self._alert_mgr.unsubscribe(self._alert_cb)
            except Exception:  # noqa: BLE001
                pass
            self._alert_mgr = self._alert_cb = None
        return self.publish()

    def burst(self, duration_s: float = DEFAULT_BURST_S,
              hz: float = DEFAULT_BURST_HZ) -> None:
        """Open a high-rate capture window: the sampler runs at ``hz``
        until the window closes (extends, never shortens, an open
        one). The alert path into stack evidence."""
        with self._lock:
            self._burst_hz = max(float(hz), self.hz)
            self._burst_until = max(self._burst_until,
                                    time.perf_counter()
                                    + float(duration_s))
            self._bursts += 1

    def attach_alerts(self, manager,
                      duration_s: float = DEFAULT_BURST_S,
                      hz: float = DEFAULT_BURST_HZ) -> "StackProfiler":
        """Subscribe to an :class:`~sparktorch_tpu_torch.obs.alerts.
        AlertManager`: every latched firing opens a burst window and
        drops a ``profile_trace`` event (a blackbox-retained kind)
        naming the alert — the same reflex that triggers a postmortem,
        aimed at stack evidence instead."""

        def on_alert(ev: Mapping[str, Any]) -> None:
            if ev.get("event") != "fired":
                return
            self.burst(duration_s=duration_s, hz=hz)
            if self.telemetry is not None:
                self.telemetry.event(
                    "profile_trace", alert=ev.get("alert"),
                    rule_kind=ev.get("rule_kind"),
                    metric=ev.get("metric"),
                    burst_hz=float(hz), burst_s=float(duration_s))

        manager.subscribe(on_alert)
        self._alert_mgr = manager
        self._alert_cb = on_alert
        return self

    # -- reading / publication -----------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            buckets = {b: _copy_node(root)
                       for b, root in self._buckets.items()}
            ticks = self._ticks
            sample_time_s = self._sample_time_s
            doc: Dict[str, Any] = {
                "rank": self.rank,
                "started_ts": self.started_ts,
                "wall_s": round(time.perf_counter() - self._t0, 6),
                "hz": self.hz,
                "ticks": ticks,
                "samples_total": self._samples_total,
                "truncated": self._truncated,
                "bursts": self._bursts,
                "buckets": buckets,
            }
        doc["sample_tick_us"] = round(
            sample_time_s / ticks * 1e6, 3) if ticks else 0.0
        return doc

    def publish(self) -> Dict[str, Any]:
        doc = self.snapshot()
        self._last_publish = time.perf_counter()
        tele = self.telemetry
        if tele is None:
            return doc
        tele.set_section(SECTION, doc)
        labels = ({"rank": str(self.rank)}
                  if self.rank is not None else None)
        tele.gauge("profile.samples_total", doc["samples_total"],
                   labels=labels)
        tele.gauge("profile.sample_tick_us", doc["sample_tick_us"],
                   labels=labels)
        return doc


def _copy_node(node: Mapping[str, Any]) -> Dict[str, Any]:
    return {"samples": int(node.get("samples", 0)),
            "self": int(node.get("self", 0)),
            "children": {k: _copy_node(c)
                         for k, c in (node.get("children") or {}).items()}}


def _merge_node(dst: Dict[str, Any], src: Mapping[str, Any]) -> None:
    dst["samples"] += int(src.get("samples", 0))
    dst["self"] += int(src.get("self", 0))
    for key, child in (src.get("children") or {}).items():
        mine = dst["children"].get(key)
        if mine is None:
            dst["children"][key] = _copy_node(child)
        else:
            _merge_node(mine, child)


# ---------------------------------------------------------------------------
# Run-level merge (the collector's /profile) + analysis helpers
# ---------------------------------------------------------------------------


def merge_sections(rank_docs: Mapping[Any, Mapping[str, Any]]
                   ) -> Dict[str, Any]:
    """Fold per-rank ``profile`` sections into one run-level doc —
    what ``GET /profile`` serves. Tries merge node-wise (samples sum;
    a sample is a sample whichever rank took it); the per-rank docs
    ride along so the timeline can drill into one rank."""
    per_rank: Dict[str, Dict[str, Any]] = {}
    buckets: Dict[str, Dict[str, Any]] = {}
    samples_total = 0
    ticks = 0
    truncated = 0
    bursts = 0
    for rank, doc in sorted(rank_docs.items(), key=lambda kv: str(kv[0])):
        if not isinstance(doc, Mapping) or "buckets" not in doc:
            continue
        per_rank[str(rank)] = dict(doc)
        samples_total += int(doc.get("samples_total") or 0)
        ticks += int(doc.get("ticks") or 0)
        truncated += int(doc.get("truncated") or 0)
        bursts += int(doc.get("bursts") or 0)
        for b, root in (doc.get("buckets") or {}).items():
            if not isinstance(root, Mapping):
                continue
            mine = buckets.get(b)
            if mine is None:
                buckets[b] = _copy_node(root)
            else:
                _merge_node(mine, root)
    return {
        "kind": "profile_run",
        "ts": wall_ts(),
        "n_ranks": len(per_rank),
        "samples_total": samples_total,
        "ticks": ticks,
        "truncated": truncated,
        "bursts": bursts,
        "buckets": buckets,
        "per_rank": per_rank,
    }


def sections_from_snapshots(snapshots: Mapping[Any, Optional[Mapping]]
                            ) -> Dict[Any, Mapping[str, Any]]:
    """Pull each rank's ``profile`` section out of its (last-good)
    telemetry snapshot; ranks without one are skipped."""
    out: Dict[Any, Mapping[str, Any]] = {}
    for rank, snap in snapshots.items():
        section = ((snap or {}).get("sections") or {}).get(SECTION)
        if isinstance(section, Mapping):
            out[rank] = section
    return out


def flatten_self(root: Mapping[str, Any]) -> Dict[str, int]:
    """Aggregate a trie into {frame key: self samples} — the flat
    ranking the bench gate and the diff mode judge on."""
    out: Dict[str, int] = {}

    def walk(node: Mapping[str, Any]) -> None:
        for key, child in (node.get("children") or {}).items():
            own = int(child.get("self", 0))
            if own:
                out[key] = out.get(key, 0) + own
            walk(child)

    walk(root)
    return out


def top_frames(doc: Mapping[str, Any], bucket: str, n: int = 10
               ) -> List[Tuple[str, int]]:
    """The top-self-time frames of one bucket of a profile doc,
    ``[(frame key, self samples), ...]`` descending."""
    root = (doc.get("buckets") or {}).get(bucket) or {}
    flat = flatten_self(root)
    return sorted(flat.items(), key=lambda kv: (-kv[1], kv[0]))[:n]


def diff_docs(current: Mapping[str, Any], prior: Mapping[str, Any]
              ) -> Dict[str, Any]:
    """Per-bucket movement between two profile docs, each frame's
    SELF-sample share of its bucket compared (shares, not raw counts:
    the two docs rarely hold the same number of samples). The output
    feeds ``timeline --profile --diff`` — positive delta means the
    frame grew."""
    out: Dict[str, Any] = {"kind": "profile_diff",
                           "current_samples": int(
                               current.get("samples_total") or 0),
                           "prior_samples": int(
                               prior.get("samples_total") or 0),
                           "buckets": {}}
    names = (set((current.get("buckets") or {}))
             | set((prior.get("buckets") or {})))
    for b in sorted(names):
        cur_root = (current.get("buckets") or {}).get(b) or {}
        pri_root = (prior.get("buckets") or {}).get(b) or {}
        cur_flat = flatten_self(cur_root)
        pri_flat = flatten_self(pri_root)
        cur_total = max(sum(cur_flat.values()), 1)
        pri_total = max(sum(pri_flat.values()), 1)
        frames = []
        for key in set(cur_flat) | set(pri_flat):
            cur_share = cur_flat.get(key, 0) / cur_total
            pri_share = pri_flat.get(key, 0) / pri_total
            delta = cur_share - pri_share
            if abs(delta) < 1e-9:
                continue
            frames.append({"frame": key,
                           "current_share": round(cur_share, 6),
                           "prior_share": round(pri_share, 6),
                           "delta": round(delta, 6)})
        frames.sort(key=lambda f: (-abs(f["delta"]), f["frame"]))
        out["buckets"][b] = {
            "current_samples": int(cur_root.get("samples", 0)),
            "prior_samples": int(pri_root.get("samples", 0)),
            "frames": frames,
        }
    return out


# ---------------------------------------------------------------------------
# Ambient (process-global) profiler
# ---------------------------------------------------------------------------

_ACTIVE: Optional[StackProfiler] = None
_ACTIVE_LOCK = threading.Lock()


def enabled() -> bool:
    return os.environ.get(ENV_GATE, "1").lower() not in (
        "0", "false", "no", "off")


def ensure(telemetry: Optional[Telemetry] = None,
           rank: Optional[Any] = None) -> Optional[StackProfiler]:
    """The trainers'/servers' install point, called next to wherever
    they install their ledger: start (once per process) the ambient
    sampler, or rebind the running one to the caller's bus — the most
    recent trainer in a process owns the published section, matching
    the ambient ledger's install-wins semantics. Returns None (and
    starts nothing) when ``SPARKTORCH_TPU_PROFILE=0``."""
    global _ACTIVE
    if not enabled():
        return None
    hz = DEFAULT_HZ
    try:
        hz = float(os.environ.get(ENV_HZ, hz))
    except ValueError:
        pass
    with _ACTIVE_LOCK:
        prof = _ACTIVE
        if prof is None:
            prof = _ACTIVE = StackProfiler(telemetry=telemetry,
                                           rank=rank, hz=hz)
            prof.start()
        else:
            if telemetry is not None:
                prof.telemetry = telemetry
            if rank is not None:
                prof.rank = rank
    return prof


def active() -> Optional[StackProfiler]:
    return _ACTIVE


def install(profiler: Optional[StackProfiler]
            ) -> Optional[StackProfiler]:
    """Swap the ambient profiler (tests; explicit owners); returns the
    previous one. Does not start or stop either."""
    global _ACTIVE
    with _ACTIVE_LOCK:
        prev, _ACTIVE = _ACTIVE, profiler
    return prev
