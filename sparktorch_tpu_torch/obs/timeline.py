"""Human-readable step timelines, budgets and run reports — the port of
``sparktorch_tpu/obs/timeline.py``.

The CLI twin of :mod:`sparktorch_tpu_torch.obs.xprof`: render a
``torch.profiler`` Chrome trace (or a telemetry JSONL dump that already
carries published ``xprof.*`` metrics) as a per-step timeline and
budget report a human can read in a terminal:

    python -m sparktorch_tpu_torch.obs.timeline /tmp/trace_dir
    python -m sparktorch_tpu_torch.obs.timeline run_telemetry.jsonl
    python -m sparktorch_tpu_torch.obs.timeline trace.json --json

``--gang`` renders the whole-gang view (per-rank lanes and cross-rank
skew annotations) from N per-host traces merged on the spot, or from a
fleet collector's JSONL sink or ``/gang`` document that already carries
the merged budget:

    python -m sparktorch_tpu_torch.obs.timeline --gang host0_trace host1_trace
    python -m sparktorch_tpu_torch.obs.timeline --gang collector_sink.jsonl

``--rpc`` renders per-request waterfalls from RPC traces
(:mod:`sparktorch_tpu_torch.obs.rpctrace`): a telemetry JSONL dump whose
snapshots carry the ``rpc_spans`` ring, or a fleet collector sink whose
records carry the stitched ``rpc_traces`` section. One tree per sampled
request, each hop offset on the root's clock, the critical path
starred, the bounding hop (straggler shard included) named in the
header:

    python -m sparktorch_tpu_torch.obs.timeline --rpc run_telemetry.jsonl
    python -m sparktorch_tpu_torch.obs.timeline --rpc collector_sink.jsonl

``--goodput``, ``--health``, ``--skew``, ``--profile [--diff PRIOR]``,
``--postmortem``, ``--tune`` and ``--follow`` render the other
documents the obs stack writes; the output is string for string the
JAX package's on the same documents. Rendering is pure string-building
(testable offline); only the CLI entry prints.
"""

from __future__ import annotations

import argparse
import json
from typing import Any, Dict, List, Optional, Tuple

from sparktorch_tpu_torch.obs.xprof import (
    GangAnalysis,
    TraceAnalysis,
    TraceParseError,
    analyze_trace,
    merge_analyses,
)

_BAR_W = 40


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:.2f}ms"


def _budget_bar(window_s: float, compute_s: float, comm_s: float,
                overlap_s: float, width: int = _BAR_W) -> str:
    """Budget bar (not a temporal strip): ``#`` compute-only, ``=``
    comm overlapped with compute, ``~`` comm-only (exposed), ``.``
    idle/unattributed — each sized by its share of the step window."""
    if window_s <= 0:
        return "." * width
    comp_only = max(compute_s - overlap_s, 0.0)
    comm_only = max(comm_s - overlap_s, 0.0)
    cells = []
    for sym, val in (("#", comp_only), ("=", overlap_s), ("~", comm_only)):
        cells.append((sym, int(round(width * min(val / window_s, 1.0)))))
    used = sum(n for _, n in cells)
    if used > width:  # rounding spill: trim the largest segment
        sym, n = max(cells, key=lambda c: c[1])
        cells[cells.index((sym, n))] = (sym, n - (used - width))
        used = width
    return "".join(sym * n for sym, n in cells) + "." * (width - used)


def render_report(analysis: TraceAnalysis, top: int = 10) -> str:
    """Per-step timeline + whole-run budget for one analyzed trace."""
    d = analysis.to_dict()
    lines = [
        f"trace: {d['source']}",
        f"steps: {d['n_steps']}   device events: {d['n_device_events']}"
        f"   collective events: {d['n_collective_events']}"
        f"   unattributed: {d['n_unattributed']}",
        "",
        f"{'step':>6} {'wall':>10} {'window':>10} {'compute':>10}"
        f" {'comm':>10} {'comm%':>7} {'ovl%':>6}  budget"
        f" [#=compute ==hidden-comm ~=exposed-comm]",
    ]
    for s in d["steps"]:
        step = "-" if s["step"] is None else str(s["step"])
        lines.append(
            f"{step:>6} {_fmt_ms(s['wall_s']):>10}"
            f" {_fmt_ms(s['window_s']):>10}"
            f" {_fmt_ms(s['compute_s']):>10} {_fmt_ms(s['comm_s']):>10}"
            f" {100 * s['comm_fraction']:>6.1f} {100 * s['overlap_fraction']:>5.1f}"
            f"  {_budget_bar(s['window_s'], s['compute_s'], s['comm_s'], s['overlap_s'])}"
        )
        for fam, sec in sorted(s["families"].items()):
            lines.append(
                f"{'':>6}   {fam:<16} {_fmt_ms(sec):>10}"
                f"  x{s['counts'].get(fam, 0)}"
            )
    lines += [
        "",
        f"budget: wall {_fmt_ms(d['wall_s'])} | compute "
        f"{_fmt_ms(d['compute_s'])} | comm {_fmt_ms(d['comm_s'])} "
        f"({100 * d['comm_fraction']:.1f}% of windows, "
        f"{100 * d['overlap_fraction']:.1f}% hidden under compute)",
    ]
    if d["collective_s"]:
        lines.append("collectives:")
        for fam, sec in sorted(d["collective_s"].items(),
                               key=lambda kv: -kv[1]):
            lines.append(f"  {fam:<16} {_fmt_ms(sec):>10}"
                         f"  x{d['collective_counts'].get(fam, 0)}")
    else:
        lines.append("collectives: none found in this capture")
    if d["top_ops"]:
        # Device-seconds (summed across lanes), so concurrent lanes
        # add up here — unlike the union walls above.
        lines.append(f"top {min(top, len(d['top_ops']))} ops by total "
                     f"device time:")
        for i, op in enumerate(d["top_ops"][:top]):
            lines.append(
                f"  {i + 1:>2}. {op['name']:<32} {op['family']:<12}"
                f" {_fmt_ms(op['total_s']):>10}  x{op['count']}"
            )
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Gang rendering (per-rank lanes, skew annotations)
# ---------------------------------------------------------------------------


def render_gang_report(gang: Any) -> str:
    """Whole-gang timeline from a :class:`GangAnalysis` (or its
    ``to_dict()`` form — what a collector's ``/gang`` route or JSONL
    sink carries): one line per step with the gang wall (the slowest
    rank's pace) and the cross-rank skew annotation, then one LANE per
    rank showing where that rank's copy of the step went."""
    d = gang.to_dict() if isinstance(gang, GangAnalysis) else dict(gang)
    lines = [
        f"gang: {d.get('n_ranks', '?')} ranks"
        + (f"   run: {d['run_id']}" if d.get("run_id") else ""),
        f"steps: {d.get('n_steps', len(d.get('steps', [])))}"
        f"   worst step skew: {_fmt_ms(d.get('step_skew_s', 0.0))}",
        "",
        f"{'step':>6} {'gang wall':>10} {'skew':>10} {'comm':>10}"
        f" {'comm%':>7} {'ovl%':>6}"
        f"  [walls max'd across ranks; seconds summed]",
    ]
    for s in d.get("steps", []):
        step = "-" if s.get("step") is None else str(s["step"])
        lines.append(
            f"{step:>6} {_fmt_ms(s['wall_s']):>10}"
            f" {_fmt_ms(s.get('skew_s', 0.0)):>10}"
            f" {_fmt_ms(s['comm_s']):>10}"
            f" {100 * s.get('comm_fraction', 0.0):>6.1f}"
            f" {100 * s.get('overlap_fraction', 0.0):>5.1f}"
        )
        ranks = s.get("ranks") or {}
        walls = [lane.get("wall_s", 0.0) for lane in ranks.values()]
        slowest = max(walls) if walls else 0.0

        def _rank_key(item):
            try:
                return (0, int(item[0]))
            except ValueError:
                return (1, item[0])

        for rank, lane in sorted(ranks.items(), key=_rank_key):
            bar = _budget_bar(lane.get("window_s", 0.0),
                              lane.get("compute_s", 0.0),
                              lane.get("comm_s", 0.0),
                              lane.get("overlap_s", 0.0))
            straggler = (" <- straggler"
                         if walls and lane.get("wall_s", 0.0) == slowest
                         and s.get("skew_s", 0.0) > 0 else "")
            lines.append(
                f"{'':>6}   rank {rank:<4} {_fmt_ms(lane.get('wall_s', 0.0)):>10}"
                f"  {bar}{straggler}"
            )
    lines += [
        "",
        f"gang budget: wall {_fmt_ms(d.get('wall_s', 0.0))} | compute "
        f"{_fmt_ms(d.get('compute_s', 0.0))} | comm "
        f"{_fmt_ms(d.get('comm_s', 0.0))} "
        f"({100 * d.get('comm_fraction', 0.0):.1f}% of gang device-time, "
        f"{100 * d.get('overlap_fraction', 0.0):.1f}% hidden under compute)",
    ]
    fams = d.get("collective_s") or {}
    if fams:
        lines.append("collectives (summed across ranks):")
        counts = d.get("collective_counts") or {}
        for fam, sec in sorted(fams.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {fam:<16} {_fmt_ms(sec):>10}"
                         f"  x{counts.get(fam, 0)}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# RPC request-trace rendering (per-request waterfalls)
# ---------------------------------------------------------------------------


def render_rpc_report(traces: List[Dict[str, Any]], top: int = 10,
                      width: int = 44) -> str:
    """Per-request waterfalls from stitched RPC trace trees (the
    :func:`sparktorch_tpu_torch.obs.rpctrace.stitch_spans` output). Each
    span renders at its offset on the ROOT's clock with a bar scaled
    to the root wall; spans on the computed critical path are starred,
    errored spans flagged, and the header names the hop (and shard)
    that actually bounded the request."""
    if not traces:
        return "no rpc traces found\n"
    lines = [f"rpc traces: {len(traces)}"
             f" (showing {min(top, len(traces))}, newest first)", ""]
    for t in traces[:top]:
        root = t.get("root") or {}
        wall = float(t.get("wall_s") or root.get("dur_s") or 0.0)
        crit = t.get("critical") or {}
        # Condensed /gang docs strip the path; those render unstarred.
        crit_ids = {e.get("span_id") for e in (crit.get("path") or [])
                    if e.get("span_id")}
        head = (f"trace {str(t.get('trace_id'))[:16]}"
                f"  {root.get('name')}  {_fmt_ms(wall)}"
                f"  {t.get('n_spans')} spans")
        if root.get("status") == "error":
            head += "  [ERROR]"
        if root.get("forced"):
            head += "  [slo-forced]"
        if crit.get("name"):
            shard = (f", shard {crit['shard']}"
                     if crit.get("shard") is not None else "")
            head += (f"   bound by: {crit['name']}{shard}"
                     f" ({100 * float(crit.get('fraction') or 0):.0f}%"
                     f" of wall)")
        lines.append(head)
        t0 = float(root.get("ts", 0.0))

        def _bar(off_s: float, dur_s: float) -> str:
            if wall <= 0:
                return "." * width
            pos = min(int(round(width * max(off_s, 0.0) / wall)),
                      width - 1)
            n = max(1, int(round(width * dur_s / wall)))
            n = min(n, width - pos)
            return "." * pos + "#" * n + "." * (width - pos - n)

        def _walk(node: Dict[str, Any], depth: int) -> None:
            off = float(node.get("ts", 0.0)) - t0
            name = str(node.get("name"))
            ann = node.get("ann") or {}
            if ann.get("shard") is not None:
                name += f" shard={ann['shard']}"
            mark = "*" if node.get("span_id") in crit_ids else " "
            err = "!" if node.get("status") == "error" else " "
            dur = float(node.get("dur_s") or 0.0)
            pad = max(30 - 2 * depth, 1)
            lines.append(
                f" {mark}{err}{'  ' * depth}{name:<{pad}}"
                f" {_fmt_ms(off):>9} +{_fmt_ms(dur):>9}"
                f" |{_bar(off, dur)}|"
            )
            for child in node.get("children") or []:
                _walk(child, depth + 1)

        _walk(root, 0)
        for extra in t.get("extra_roots") or []:
            _walk(extra, 0)
        for orphan in t.get("orphans") or []:
            lines.append(f"  ~ orphan hop: {orphan.get('name')}"
                         f" +{_fmt_ms(float(orphan.get('dur_s') or 0))}"
                         f" (parent span not scraped)")
        lines.append("")
    return "\n".join(lines)


def _rpc_from_jsonl(records: List[Dict[str, Any]]
                    ) -> Optional[List[Dict[str, Any]]]:
    """Stitched request trees out of a JSONL file: the newest record
    carrying an already-stitched ``rpc_traces`` section (a collector
    sink) wins; otherwise every record's raw ``rpc_spans`` rings are
    pooled and stitched here (a per-process telemetry dump — possibly
    several processes' snapshots appended to one file)."""
    from sparktorch_tpu_torch.obs import rpctrace

    for rec in reversed(records):
        section = (rec.get("sections") or {}).get(rpctrace.TRACES_SECTION)
        if isinstance(section, dict) and section.get("traces"):
            return list(section["traces"])
    spans: List[Dict[str, Any]] = []
    for rec in records:
        spans.extend(rpctrace.spans_from_snapshot(rec))
    if not spans:
        return None
    return rpctrace.stitch_spans(spans)


# ---------------------------------------------------------------------------
# Goodput ledger rendering (stacked run-attribution bars)
# ---------------------------------------------------------------------------

# One glyph per bucket, in render order (compute first so the
# productive share reads left-to-right as "the good part").
_GOODPUT_GLYPHS = (
    ("compute", "#"),
    ("exposed_comm", "~"),
    ("compile", "C"),
    ("checkpoint", "K"),
    ("data_wait", "D"),
    ("restart_downtime", "R"),
    ("resize_downtime", "Z"),
    ("idle", "."),
)


def _goodput_bar(buckets: Dict[str, Any], wall_s: float,
                 width: int = _BAR_W) -> str:
    """Stacked attribution strip: each bucket sized by its share of
    the wall. Rounding spill trims the largest segment (the same
    discipline as the xprof budget bar)."""
    if wall_s <= 0:
        return "." * width
    cells = [(glyph, int(round(width * min(
        float(buckets.get(b, 0.0)) / wall_s, 1.0))))
        for b, glyph in _GOODPUT_GLYPHS]
    used = sum(n for _, n in cells)
    while used > width:
        glyph, n = max(cells, key=lambda c: c[1])
        cells[cells.index((glyph, n))] = (glyph, n - 1)
        used -= 1
    return "".join(glyph * n for glyph, n in cells) + "." * (width - used)


def render_goodput_report(doc: Dict[str, Any]) -> str:
    """One terminal page from a run-level goodput report (the
    collector's ``GET /goodput`` document, or a single rank's
    ``goodput`` section): the run summary with the goodput fraction
    and the biggest thief named, one stacked attribution bar per
    rank, then the bucket table. The ``comm_source`` label says
    whether exposed comm was measured (xprof) or modeled."""
    per_rank = doc.get("per_rank")
    if not isinstance(per_rank, dict) or not per_rank:
        # A bare rank section renders as a one-rank run.
        per_rank = {str(doc.get("rank", "?")): doc}
    wall = float(doc.get("wall_s") or 0.0)
    goodput = float(doc.get("goodput") or 0.0)
    lines = [
        f"goodput: {100 * goodput:.1f}% of {wall:.2f}s rank-seconds "
        f"productive ({doc.get('n_ranks', len(per_rank))} ranks, "
        f"{doc.get('n_steps', 0)} steps, {doc.get('compiles', 0)} "
        f"compiles)"
        + (f"   run: {doc['run_id']}" if doc.get("run_id") else ""),
        f"exposed comm: {doc.get('comm_source', 'none')}"
        + (f"   mfu: {100 * float(doc['mfu']):.2f}%"
           if doc.get("mfu") is not None else ""),
    ]
    thief = doc.get("biggest_thief")
    if not thief:
        from sparktorch_tpu_torch.obs.goodput import biggest_thief as _bt

        ranked = _bt(doc)
        if ranked:
            thief = {"bucket": ranked[0], "seconds": ranked[1],
                     "fraction": ranked[1] / max(wall, 1e-9)}
    if thief:
        lines.append(
            f"biggest thief: {thief['bucket']} "
            f"{float(thief['seconds']):.2f}s "
            f"({100 * float(thief.get('fraction') or 0):.1f}% of wall)")
    over = float(doc.get("overattributed_s") or 0.0)
    if over > 0:
        lines.append(f"WARNING: {over:.3f}s over-attributed "
                     f"(double-counted regions)")
    legend = " ".join(f"{g}={b}" for b, g in _GOODPUT_GLYPHS)
    lines += ["", f"{'rank':>10} {'wall':>9} {'goodput':>8}  [{legend}]"]

    def _rank_key(item):
        try:
            return (0, int(item[0]))
        except (TypeError, ValueError):
            return (1, str(item[0]))

    for rank, rdoc in sorted(per_rank.items(), key=_rank_key):
        rwall = float(rdoc.get("wall_s") or 0.0)
        bar = _goodput_bar(rdoc.get("buckets") or {}, rwall)
        lines.append(
            f"{str(rank):>10} {rwall:>8.2f}s"
            f" {100 * float(rdoc.get('goodput') or 0.0):>7.1f}%"
            f"  {bar}"
            + (f"  [{rdoc.get('comm_source')}]"
               if rdoc.get("comm_source") not in (None, "none",
                                                  doc.get("comm_source"))
               else ""))
    buckets = doc.get("buckets") or {}
    fractions = doc.get("fractions") or {}
    lines += ["", "buckets (rank-seconds summed):"]
    for b, _ in _GOODPUT_GLYPHS:
        sec = float(buckets.get(b, 0.0))
        if sec <= 0:
            continue
        lines.append(f"  {b:<18} {sec:>9.3f}s"
                     f"  {100 * float(fractions.get(b, 0.0)):>5.1f}%"
                     + (f"  x{doc.get('counts', {}).get(b)}"
                        if (doc.get("counts") or {}).get(b) else ""))
    return "\n".join(lines) + "\n"


def _goodput_from_jsonl(records: List[Dict[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    """The newest goodput accounting in a JSONL file: a collector
    sink/dump record carrying the merged ``goodput_run`` section wins;
    a bare rank dump's ``goodput`` section renders as one lane."""
    for rec in reversed(records):
        sections = rec.get("sections") or {}
        doc = sections.get("goodput_run")
        if isinstance(doc, dict) and doc.get("buckets"):
            return doc
    for rec in reversed(records):
        sections = rec.get("sections") or {}
        doc = sections.get("goodput")
        if isinstance(doc, dict) and doc.get("buckets"):
            return doc
    return None


# ---------------------------------------------------------------------------
# Model-health rendering (per-rank sparklines + anomaly log)
# ---------------------------------------------------------------------------


_SPARK_GLYPHS = "▁▂▃▄▅▆▇█"


def _sparkline(values: List[Any], width: int = _BAR_W) -> str:
    """A unicode sparkline over the last ``width`` values; non-finite
    points render as ``!`` — the whole point of the health view is
    that a NaN must be VISIBLE, not interpolated away."""
    import math

    vals = []
    for v in values[-width:]:
        try:
            vals.append(float(v))
        except (TypeError, ValueError):
            vals.append(float("nan"))
    if not vals:
        return ""
    finite = [v for v in vals if math.isfinite(v)]
    lo = min(finite) if finite else 0.0
    hi = max(finite) if finite else 0.0
    span = (hi - lo) or 1.0
    out = []
    for v in vals:
        if not math.isfinite(v):
            out.append("!")
        else:
            idx = int((v - lo) / span * (len(_SPARK_GLYPHS) - 1))
            out.append(_SPARK_GLYPHS[max(0, min(idx,
                                                len(_SPARK_GLYPHS) - 1))])
    return "".join(out)


def render_health_report(doc: Dict[str, Any], top: int = 10) -> str:
    """One terminal page from a run-level model-health report (the
    collector's ``GET /health`` document, or a single rank's
    ``health`` section merged to the same shape): the run summary
    with per-kind anomaly counts, one loss + grad-norm sparkline pair
    per rank (NaNs render as ``!``), then the recent anomaly log —
    every line rank-tagged, never a fleet average."""
    per_rank = doc.get("per_rank")
    if not isinstance(per_rank, dict) or not per_rank:
        per_rank = {str(doc.get("rank", "?")): doc}
    counts = doc.get("counts") or {}
    total = int(doc.get("anomalies_total") or 0)
    lines = [
        f"model health: {doc.get('n_ranks', len(per_rank))} ranks, "
        f"{doc.get('steps_total', 0)} steps ingested, "
        f"last step {doc.get('last_step', -1)}"
        + (f"   run: {doc['run_id']}" if doc.get("run_id") else ""),
        "anomalies: "
        + (", ".join(f"{k}={counts[k]}" for k in sorted(counts)
                     if counts[k]) or "none")
        + (f"  (total {total})" if total else ""),
    ]
    worst = doc.get("worst")
    if isinstance(worst, dict):
        lines.append(
            f"worst: {worst.get('akind')} @ step {worst.get('step')} "
            f"rank {worst.get('rank')} value={worst.get('value')}")
    lines += ["", f"{'rank':>10} {'step':>7} {'last loss':>12}  "
                  f"loss / grad-norm (! = non-finite)"]

    def _rank_key(item):
        try:
            return (0, int(item[0]))
        except (TypeError, ValueError):
            return (1, str(item[0]))

    for rank, rdoc in sorted(per_rank.items(), key=_rank_key):
        series = rdoc.get("series") or {}
        last = rdoc.get("last") or {}
        loss = last.get("loss")
        loss_s = (f"{float(loss):.5g}"
                  if isinstance(loss, (int, float)) else "?")
        lines.append(
            f"{str(rank):>10} {rdoc.get('last_step', -1):>7}"
            f" {loss_s:>12}  {_sparkline(series.get('loss') or [])}")
        gn = series.get("grad_norm") or []
        if gn:
            lines.append(f"{'':>10} {'':>7} {'':>12}  {_sparkline(gn)}")
        leaves = rdoc.get("top_grad_leaves") or []
        if leaves:
            lines.append(
                f"{'':>10} {'':>7} {'':>12}  top grad leaves: "
                + ", ".join(f"{k}={float(v):.3g}"
                            for k, v in leaves[:3]))
    anomalies = doc.get("anomalies") or []
    if anomalies:
        lines += ["", f"recent anomalies (last {min(len(anomalies), top)}):"]
        for a in anomalies[-top:]:
            lines.append(
                f"  step {a.get('step'):>6}  rank {a.get('rank')!s:<6}"
                f" {a.get('akind'):<14} value={a.get('value')}"
                f" threshold={a.get('threshold')}"
                f" lag={a.get('detect_lag')}")
    return "\n".join(lines) + "\n"


def _health_from_jsonl(records: List[Dict[str, Any]]
                       ) -> Optional[Dict[str, Any]]:
    """The newest model-health doc in a JSONL file: a collector
    sink/dump record carrying the merged ``health_run`` section wins;
    a bare rank dump's composite ``health`` section is merged to the
    same shape so one renderer serves both."""
    for rec in reversed(records):
        sections = rec.get("sections") or {}
        doc = sections.get("health_run")
        if isinstance(doc, dict) and doc.get("per_rank"):
            return doc
    from sparktorch_tpu_torch.obs import health as _health

    for rec in reversed(records):
        sections = rec.get("sections") or {}
        sec = sections.get("health")
        if isinstance(sec, dict) and (sec.get("ranks") or sec.get("rank")):
            return _health.merge_sections({"dump": sec})
    return None


# ---------------------------------------------------------------------------
# Cross-rank step-skew rendering (arrival bars + straggler verdict)
# ---------------------------------------------------------------------------


def render_skew_report(doc: Dict[str, Any], top: int = 10) -> str:
    """One terminal page from a run-level skew verdict (the
    collector's ``GET /skew`` document): the wire vs straggler-wait
    decomposition of exposed_comm, per-rank arrival bars (median
    arrival lag, wait caused/suffered), the named persistent laggard
    with its cause hypothesis, and a per-step arrival detail table."""
    n_ranks = int(doc.get("n_ranks") or 0)
    aligned = int(doc.get("steps_aligned") or 0)
    lines = [
        f"step skew: {n_ranks} ranks, {aligned} aligned steps"
        + (f"   run: {doc['run_id']}" if doc.get("run_id") else ""),
    ]
    exposed = doc.get("exposed_comm_s")
    wait = float(doc.get("straggler_wait_s") or 0.0)
    if exposed is not None:
        frac = float(doc.get("straggler_fraction") or 0.0)
        lines.append(
            f"exposed comm {float(exposed):.3f}s = "
            f"wire {float(doc.get('wire_s') or 0.0):.3f}s + "
            f"straggler wait {wait:.3f}s ({100 * frac:.1f}% straggler)")
    else:
        lines.append(
            f"arrival wait {wait:.3f}s (no goodput budget scraped — "
            f"wire split unavailable)")
    lag = doc.get("laggard")
    if isinstance(lag, dict) and lag.get("persistent"):
        cause = lag.get("cause") or "unknown"
        ev = "; ".join(lag.get("evidence") or [])
        lines.append(
            f"verdict: rank {lag.get('rank')} is a persistent "
            f"straggler — caused {100 * float(lag.get('share') or 0):.1f}%"
            f" of the wait over {lag.get('steps')} steps; "
            f"cause hypothesis: {cause}" + (f" ({ev})" if ev else ""))
    elif isinstance(lag, dict):
        lines.append(
            f"verdict: no persistent straggler (top laggard rank "
            f"{lag.get('rank')} at {100 * float(lag.get('share') or 0):.1f}%"
            f" of wait over {lag.get('steps')} step(s))")
    elif aligned:
        lines.append("verdict: no straggler wait observed")
    else:
        lines.append("verdict: no cross-rank alignment "
                     "(need the same step stamped on >= 2 ranks)")
    per_rank = doc.get("per_rank") or {}
    if per_rank:
        total_caused = sum(float((r or {}).get("wait_caused_s") or 0.0)
                           for r in per_rank.values()) or 1.0
        lines += ["", f"{'rank':>10} {'steps':>6} {'lag p50':>9} "
                      f"{'lag max':>9} {'caused':>9} {'suffered':>9}"
                      f"  wait share"]

        def _rank_key(item):
            try:
                return (0, int(item[0]))
            except (TypeError, ValueError):
                return (1, str(item[0]))

        for rank, rdoc in sorted(per_rank.items(), key=_rank_key):
            caused = float(rdoc.get("wait_caused_s") or 0.0)
            bar = "#" * int(round(_BAR_W / 2 * caused / total_caused))
            lines.append(
                f"{str(rank):>10} {rdoc.get('steps', 0):>6}"
                f" {_fmt_ms(float(rdoc.get('arrival_lag_p50_s') or 0)):>9}"
                f" {_fmt_ms(float(rdoc.get('arrival_lag_max_s') or 0)):>9}"
                f" {caused:>8.3f}s"
                f" {float(rdoc.get('wait_suffered_s') or 0.0):>8.3f}s"
                f"  {bar}")
    per_step = doc.get("per_step") or []
    if per_step:
        shown = per_step[-top:]
        lines += ["", f"per-step arrivals (last {len(shown)}; "
                      f"offset from first arrival):"]
        for entry in shown:
            arrivals = entry.get("arrivals") or {}
            arr = "  ".join(
                f"{r}+{_fmt_ms(float(arrivals[r]))}"
                for r in sorted(arrivals, key=str))
            lines.append(
                f"  step {entry.get('step'):>6}"
                f"  skew {_fmt_ms(float(entry.get('skew_s') or 0)):>9}"
                f"  laggard {str(entry.get('laggard')):<6} {arr}")
    return "\n".join(lines) + "\n"


def _skew_from_jsonl(records: List[Dict[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    """The newest skew verdict in a JSONL file: a collector sink/dump
    record carrying the merged ``skew_run`` section wins; a bare rank
    dump's ``skew`` section is merged to the same shape (no alignment
    from one rank, but the stamp accounting renders)."""
    for rec in reversed(records):
        sections = rec.get("sections") or {}
        doc = sections.get("skew_run")
        if isinstance(doc, dict) and doc.get("per_rank"):
            return doc
    from sparktorch_tpu_torch.obs import skew as _skew

    for rec in reversed(records):
        sections = rec.get("sections") or {}
        sec = sections.get("skew")
        if isinstance(sec, dict) and sec.get("stamps"):
            return _skew.merge_sections({"dump": sec})
    return None


# ---------------------------------------------------------------------------
# Stack-profile rendering (per-bucket top-down trees)
# ---------------------------------------------------------------------------


def render_profile_report(doc: Dict[str, Any], top: int = 10) -> str:
    """One terminal page from a stack-profile doc (the collector's
    ``GET /profile`` document, or a single rank's ``profile``
    section): per ledger bucket, the hottest self-time frame and a
    flamegraph-style top-down tree. ``top`` caps the tree lines per
    bucket; children below 2%% of their bucket are pruned (they are
    noise at sampling resolution)."""
    from sparktorch_tpu_torch.obs.profile import top_frames

    total = int(doc.get("samples_total") or 0)
    lines = [
        f"profile: {total} samples over "
        f"{float(doc.get('wall_s') or 0.0):.2f}s"
        + (f" ({doc.get('n_ranks')} ranks)"
           if doc.get("n_ranks") is not None else
           (f" (rank {doc['rank']})"
            if doc.get("rank") is not None else ""))
        + (f" @ {float(doc['hz']):g}Hz" if doc.get("hz") else "")
        + (f"   run: {doc['run_id']}" if doc.get("run_id") else ""),
    ]
    if doc.get("bursts"):
        lines.append(f"burst windows: {doc['bursts']} "
                     f"(alert-triggered high-rate captures)")
    if doc.get("truncated"):
        lines.append(f"note: {doc['truncated']} stacks truncated at "
                     f"max depth (leaf side kept)")
    buckets = doc.get("buckets") or {}
    ranked = sorted(buckets.items(),
                    key=lambda kv: -int((kv[1] or {}).get("samples", 0)))
    for bucket, root in ranked:
        n = int((root or {}).get("samples", 0))
        if n <= 0:
            continue
        share = n / max(total, 1)
        lines.append("")
        lines.append(f"[{bucket}] {n} samples "
                     f"({100 * share:.1f}% of run)")
        hot = top_frames(doc, bucket, 1)
        if hot:
            lines.append(f"  hot: {hot[0][0]}  self={hot[0][1]} "
                         f"({100 * hot[0][1] / max(n, 1):.1f}% of bucket)")
        budget = [max(int(top), 1)]
        floor = max(n * 0.02, 0.5)

        def walk(node, depth):
            kids = sorted((node.get("children") or {}).items(),
                          key=lambda kv: (-kv[1].get("samples", 0),
                                          kv[0]))
            for name, child in kids:
                cn = int(child.get("samples", 0))
                if cn < floor:
                    continue
                if budget[0] <= 0:
                    lines.append("    " + "  " * depth + "...")
                    return
                budget[0] -= 1
                own = int(child.get("self", 0))
                lines.append(
                    "    " + "  " * depth
                    + f"{name}  {cn} ({100 * cn / max(n, 1):.1f}%)"
                    + (f" [self {own}]" if own else ""))
                walk(child, depth + 1)

        walk(root, 0)
    return "\n".join(lines) + "\n"


def render_profile_diff(diff: Dict[str, Any], top: int = 10) -> str:
    """Render a :func:`~sparktorch_tpu_torch.obs.profile.diff_docs` output:
    per bucket, the frames whose self-time SHARE of the bucket moved
    most (positive delta = the frame grew since the prior profile)."""
    lines = [
        f"profile diff: {diff.get('current_samples', 0)} samples now "
        f"vs {diff.get('prior_samples', 0)} prior",
    ]
    buckets = diff.get("buckets") or {}
    ranked = sorted(buckets.items(),
                    key=lambda kv: -int((kv[1] or {}).get(
                        "current_samples", 0)))
    moved = False
    for bucket, bdoc in ranked:
        frames = (bdoc or {}).get("frames") or []
        if not frames:
            continue
        moved = True
        lines.append("")
        lines.append(
            f"[{bucket}] {bdoc.get('current_samples', 0)} samples now "
            f"vs {bdoc.get('prior_samples', 0)} prior")
        for f in frames[:max(int(top), 1)]:
            delta = float(f.get("delta") or 0.0)
            lines.append(
                f"  {delta:>+7.1%}  {f.get('frame')}"
                f"  ({float(f.get('current_share') or 0):.1%}"
                f" <- {float(f.get('prior_share') or 0):.1%})")
    if not moved:
        lines.append("no frame moved (identical shares)")
    return "\n".join(lines) + "\n"


def _profile_from_jsonl(records: List[Dict[str, Any]]
                        ) -> Optional[Dict[str, Any]]:
    """The newest stack profile in a JSONL file: a collector sink/dump
    record carrying the merged ``profile_run`` section wins; a bare
    rank dump's ``profile`` section renders as one rank."""
    for rec in reversed(records):
        sections = rec.get("sections") or {}
        doc = sections.get("profile_run")
        if isinstance(doc, dict) and doc.get("buckets"):
            return doc
    for rec in reversed(records):
        sections = rec.get("sections") or {}
        doc = sections.get("profile")
        if isinstance(doc, dict) and doc.get("buckets"):
            return doc
    return None


# ---------------------------------------------------------------------------
# Postmortem rendering (flight-recorder bundles)
# ---------------------------------------------------------------------------


def render_postmortem_report(doc: Dict[str, Any], top: int = 40) -> str:
    """One terminal page from a postmortem bundle (``obs.blackbox.
    collect_postmortem`` output): the header (reason, rank, world),
    the causal event window offset on the trigger's clock (negative =
    before the death), the biggest metric deltas of the last good
    interval, and the stitched request traces' verdicts."""
    trigger = float(doc.get("ts") or 0.0)
    lines = [
        f"postmortem: {doc.get('reason', '?')}"
        + (f"   rank {doc['rank']}" if doc.get("rank") is not None else ""),
        f"trigger ts: {trigger:.3f}   window: {doc.get('window_s')}s"
        f"   events: {doc.get('n_events', 0)}"
        + (f"   run: {doc['run_id']}" if doc.get("run_id") else ""),
    ]
    world = doc.get("world")
    if isinstance(world, dict):
        members = world.get("members") or {}
        states = ",".join(f"{r}:{m.get('state')}"
                          for r, m in sorted(members.items()))
        lines.append(
            f"world: generation {world.get('generation')}, "
            f"size {world.get('world_size')}"
            + (f"   members [{states}]" if states else ""))
    hb = doc.get("heartbeats")
    if isinstance(hb, dict) and hb.get("ranks"):
        lines.append(
            f"heartbeats: {len(hb.get('alive') or [])}/"
            f"{hb.get('n_ranks')} alive"
            + (f", step skew {hb['step_skew']}"
               if hb.get("step_skew") is not None else ""))
    events = list(doc.get("events") or [])
    lines.append("")
    lines.append(f"event window (offsets on the trigger's clock, "
                 f"showing last {min(top, len(events))}):")
    for e in events[-top:]:
        off = float(e.get("ts", trigger)) - trigger
        kind = str(e.get("kind", "?"))
        who = ""
        if e.get("rank") is not None:
            who = f" rank={e['rank']}"
        elif e.get("worker") is not None:
            who = f" worker={e['worker']}"
        detail = ""
        if kind == "span":
            detail = (f" {e.get('name')}"
                      f" +{_fmt_ms(float(e.get('dur_s') or 0.0))}")
        elif kind.startswith("alert."):
            detail = (f" {e.get('alert')} value={e.get('value')}"
                      f" episode={e.get('episode')}")
        else:
            extras = {k: v for k, v in e.items()
                      if k not in ("ts", "kind", "rank", "worker",
                                   "run_id", "generation", "world_size")
                      and not isinstance(v, (dict, list))}
            if e.get("generation") is not None:
                detail = f" gen={e['generation']}"
            detail += "".join(f" {k}={v}" for k, v in
                              sorted(extras.items())[:4])
        lines.append(f"  {off:>+9.3f}s  {kind:<24}{who}{detail}")
    deltas = doc.get("metric_deltas") or {}
    if deltas:
        lines.append("")
        lines.append("metric deltas over the last good window:")
        for name, delta in list(deltas.items())[:12]:
            lines.append(f"  {name:<56} +{delta:g}")
    gp = doc.get("goodput")
    if isinstance(gp, dict) and gp.get("buckets"):
        from sparktorch_tpu_torch.obs.goodput import biggest_thief as _bt

        thief = _bt(gp)
        lines.append("")
        lines.append(
            f"goodput at death: {100 * float(gp.get('goodput') or 0):.1f}%"
            f" of {float(gp.get('wall_s') or 0):.2f}s rank-seconds"
            + (f", biggest thief {thief[0]} {thief[1]:.2f}s"
               if thief else "")
            + f" (comm: {gp.get('comm_source', 'none')})")
    prof = doc.get("profile")
    if isinstance(prof, dict) and prof.get("buckets"):
        from sparktorch_tpu_torch.obs.profile import top_frames

        lines.append("")
        lines.append(
            f"stack profile at death: "
            f"{prof.get('samples_total', 0)} samples")
        pbuckets = sorted(
            (prof.get("buckets") or {}).items(),
            key=lambda kv: -int((kv[1] or {}).get("samples", 0)))
        for bucket, root in pbuckets[:4]:
            n = int((root or {}).get("samples", 0))
            hot = top_frames(prof, bucket, 1)
            if n <= 0 or not hot:
                continue
            lines.append(f"  {bucket:<18} {n:>6} samples"
                         f"  hot: {hot[0][0]} [self {hot[0][1]}]")
    hdoc = doc.get("health")
    if isinstance(hdoc, dict) and (hdoc.get("per_rank")
                                   or hdoc.get("anomalies")):
        counts = hdoc.get("counts") or {}
        lines.append("")
        lines.append(
            f"model health at death: "
            + (", ".join(f"{k}={counts[k]}" for k in sorted(counts)
                         if counts[k]) or "no anomalies")
            + f" over {hdoc.get('n_ranks', '?')} rank(s), last step "
            f"{hdoc.get('last_step', -1)}")
        worst = hdoc.get("worst")
        if isinstance(worst, dict):
            lines.append(
                f"  worst: {worst.get('akind')} @ step "
                f"{worst.get('step')} rank {worst.get('rank')} "
                f"value={worst.get('value')}")
        for a in (hdoc.get("anomalies") or [])[-4:]:
            lines.append(
                f"  step {a.get('step'):>6}  rank {a.get('rank')!s:<6}"
                f" {a.get('akind')} value={a.get('value')}")
    sdoc = doc.get("skew")
    if isinstance(sdoc, dict) and (sdoc.get("steps_aligned")
                                   or sdoc.get("per_rank")):
        wait = float(sdoc.get("straggler_wait_s") or 0.0)
        exposed = sdoc.get("exposed_comm_s")
        lines.append("")
        lines.append(
            f"step skew at death: "
            f"{sdoc.get('steps_aligned', 0)} aligned steps, "
            f"straggler wait {wait:.3f}s"
            + (f" of {float(exposed):.3f}s exposed comm "
               f"(wire {float(sdoc.get('wire_s') or 0.0):.3f}s)"
               if exposed is not None else ""))
        lag = sdoc.get("laggard")
        if isinstance(lag, dict):
            lines.append(
                f"  laggard: rank {lag.get('rank')} "
                f"({100 * float(lag.get('share') or 0):.1f}% of wait, "
                f"{lag.get('steps')} steps"
                + (f", cause: {lag.get('cause')}"
                   if lag.get("persistent") else ", not persistent")
                + ")")
    traces = doc.get("rpc_traces") or []
    if traces:
        lines.append("")
        lines.append(f"stitched request traces ({len(traces)}):")
        for t in traces[:5]:
            crit = t.get("critical") or {}
            root = t.get("root") or {}
            shard = (f", shard {crit['shard']}"
                     if crit.get("shard") is not None else "")
            lines.append(
                f"  {str(t.get('trace_id'))[:16]}  {root.get('name')}"
                f"  {_fmt_ms(float(t.get('wall_s') or 0.0))}"
                f"  bound by {crit.get('name')}{shard}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# Follow mode (live JSONL tail)
# ---------------------------------------------------------------------------


class FollowReader:
    """Incremental JSONL reader for ``--follow``: each :meth:`poll`
    returns the records appended since the last one. Survives a file
    that does not exist yet, keeps a torn (still-being-written) final
    line buffered until its newline lands, and resets cleanly when the
    file is truncated/rotated under it."""

    def __init__(self, path: str):
        self.path = path
        self._pos = 0
        self._tail = b""

    def poll(self) -> List[Dict[str, Any]]:
        import os

        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._pos:  # truncated/rotated: start over
            self._pos = 0
            self._tail = b""
        if size == self._pos:
            return []
        # Binary read: getsize/seek offsets are BYTES, and a writer's
        # flush boundary can land mid-UTF-8-character — torn bytes stay
        # buffered with the torn line until the rest lands, instead of
        # a UnicodeDecodeError killing the live tail.
        with open(self.path, "rb") as f:
            f.seek(self._pos)
            chunk = f.read()
            self._pos = f.tell()
        data = self._tail + chunk
        lines = data.split(b"\n")
        self._tail = lines.pop()  # torn final line: wait for newline
        out: List[Dict[str, Any]] = []
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line.decode("utf-8")))
            except (ValueError, UnicodeDecodeError):
                continue
        return out


# Record kinds --follow renders (everything else is metric volume the
# tail mode exists to cut through). "span" is deliberately absent.
_FOLLOW_PREFIXES = ("alert.", "ctl.", "ft_", "chaos", "gang_snapshot",
                    "goodput", "profile", "health", "skew")


def render_follow_line(rec: Dict[str, Any]) -> Optional[str]:
    """One tail line for a sink record — alerts and control-plane
    transitions as they land, collector snapshots condensed to a
    liveness one-liner. None = not a record the tail shows."""
    kind = str(rec.get("kind") or "")
    if not kind.startswith(_FOLLOW_PREFIXES):
        return None
    ts = float(rec.get("ts") or 0.0)
    stamp = f"{ts:.3f}"
    if kind == "gang_snapshot":
        ranks = rec.get("ranks") or {}
        ok = sum(1 for s in ranks.values() if s.get("ok"))
        hb = rec.get("heartbeats") or {}
        skew = hb.get("step_skew")
        return (f"{stamp}  gang_snapshot       ranks {ok}/{len(ranks)} ok"
                + (f", step skew {skew}" if skew is not None else ""))
    if kind.startswith("alert."):
        return (f"{stamp}  {kind:<18}  {rec.get('alert')}"
                f"  value={rec.get('value')}"
                f"  threshold={rec.get('threshold')}"
                f"  episode={rec.get('episode')}")
    if kind.startswith("goodput"):
        # The ledger's condensed record (goodput.ledger events, or a
        # sink-dumped run doc): one line says how productive the run
        # is NOW and who is stealing the rest.
        who = (f" rank={rec['rank']}"
               if rec.get("rank") is not None else "")
        frac = rec.get("goodput")
        thief = rec.get("thief")
        if thief is None:
            bt = rec.get("biggest_thief") or {}
            thief, thief_s = bt.get("bucket"), bt.get("seconds")
        else:
            thief_s = rec.get("thief_s")
        return (f"{stamp}  {kind:<18} {who}"
                + (f" goodput={100 * float(frac):.1f}%"
                   if frac is not None else "")
                + f" wall={float(rec.get('wall_s') or 0.0):.2f}s"
                + (f" thief={thief}:{float(thief_s or 0.0):.2f}s"
                   if thief else "")
                + (f" comm={rec['comm_source']}"
                   if rec.get("comm_source") else ""))
    if kind == "health.run":
        # The collector's condensed model-health record: one line says
        # whether the numerics are clean NOW and, if not, names the
        # worst anomaly with its source rank.
        worst = rec.get("worst") or {}
        n_anom = int(rec.get("anomalies_total") or 0)
        return (f"{stamp}  {kind:<18} "
                f" ranks={rec.get('n_ranks')}"
                f" step={rec.get('last_step')}"
                f" anomalies={n_anom}"
                + (f" worst={worst.get('akind')}"
                   f"@step{worst.get('step')}"
                   f" rank={worst.get('rank')}"
                   if worst else ""))
    if kind == "skew.run":
        # The collector's condensed straggler record: one line says
        # whether exposed comm is wire or waiting, and for whom.
        lag = rec.get("laggard") or {}
        frac = rec.get("straggler_fraction")
        return (f"{stamp}  {kind:<18} "
                f" ranks={rec.get('n_ranks')}"
                f" steps={rec.get('steps_aligned')}"
                + (f" wire={float(rec.get('wire_s') or 0.0):.2f}s"
                   if rec.get("wire_s") is not None else "")
                + f" straggler={float(rec.get('straggler_wait_s') or 0.0):.2f}s"
                + (f" ({100 * float(frac):.0f}%)"
                   if frac is not None else "")
                + (f" laggard=rank {lag.get('rank')}"
                   + (f" cause={lag.get('cause')}"
                      if lag.get("cause") else "")
                   if lag else ""))
    who = ""
    if rec.get("rank") is not None:
        who = f" rank={rec['rank']}"
    elif rec.get("worker") is not None:
        who = f" worker={rec['worker']}"
    gen = (f" gen={rec['generation']}"
           if rec.get("generation") is not None else "")
    extras = {k: v for k, v in rec.items()
              if k not in ("ts", "kind", "rank", "worker", "run_id",
                           "generation", "world_size")
              and not isinstance(v, (dict, list))}
    detail = "".join(f" {k}={v}" for k, v in sorted(extras.items())[:4])
    return f"{stamp}  {kind:<18} {who}{gen}{detail}"


def follow(path: str, poll_s: float = 0.2, stop=None,
           max_records: Optional[int] = None):
    """Generator of renderable tail lines from a growing JSONL sink —
    the engine under ``timeline --follow`` (the CLI prints; tests
    consume with ``max_records``/``stop``). Existing records render
    first, then new ones as they land."""
    import time as _time

    reader = FollowReader(path)
    emitted = 0
    while True:
        for rec in reader.poll():
            line = render_follow_line(rec)
            if line is None:
                continue
            yield line
            emitted += 1
            if max_records is not None and emitted >= max_records:
                return
        if stop is not None and stop.is_set():
            return
        _time.sleep(poll_s)


# ---------------------------------------------------------------------------
# Auto-tune rendering (the search's ranking + prune decisions)
# ---------------------------------------------------------------------------


def render_tune_report(doc: Dict[str, Any]) -> str:
    """Render a tune artifact (``tune_result.json`` or the
    ``xprof_tune`` snapshot section): the measured ranking as wall
    bars, then the prune/skip decisions — so "why did the tuner pick
    this mesh, and what did it refuse to run" is one terminal page."""
    cands = [dict(c) for c in doc.get("candidates", [])]
    measured = [c for c in cands if c.get("status") == "measured"
                and c.get("measured")]
    measured.sort(key=lambda c: c.get("score") or 0.0)
    best = doc.get("best_label", "?")
    lines = [
        f"mesh auto-tune: {doc.get('n_devices', '?')} devices, "
        f"global batch {doc.get('global_batch', '?')}"
        + (f"   run: {doc['run_id']}" if doc.get("run_id") else ""),
        f"chosen: {best}   candidates: {len(cands)}"
        f" ({len(measured)} measured,"
        f" {sum(c.get('status') == 'pruned' for c in cands)} pruned,"
        f" {sum(c.get('status') == 'failed' for c in cands)} failed)"
        + ("   [early stop]" if doc.get("early_stopped") else ""),
        f"noise floor: {_fmt_ms(doc.get('noise_floor_s', 0.0))}"
        f"   search wall: {doc.get('wall_s', 0.0):.1f}s",
        "",
    ]
    if measured:
        worst = max(float(c["measured"].get("step_wall_s", 0.0))
                    for c in measured) or 1.0
        lines.append(
            f"{'mesh':>18} {'step wall':>10} {'exposed%':>9}"
            f" {'ovl%':>6} {'score':>10}  wall (vs slowest measured)"
        )
        for c in measured:
            m = c["measured"]
            wall = float(m.get("step_wall_s", 0.0))
            bar = "#" * max(int(round(_BAR_W * wall / worst)), 1)
            mark = " <- chosen" if c.get("label") == best else ""
            lines.append(
                f"{c.get('label', '?'):>18} {_fmt_ms(wall):>10}"
                f" {100 * float(m.get('exposed_comm_fraction', 0.0)):>8.1f}"
                f" {100 * float(m.get('overlap_fraction', 0.0)):>5.1f}"
                f" {_fmt_ms(float(c.get('score') or 0.0)):>10}"
                f"  {bar}{mark}"
            )
    not_run = [c for c in cands
               if c.get("status") not in ("measured", None)]
    if not_run:
        lines.append("")
        lines.append("not measured:")
        for c in not_run:
            pred = (c.get("predicted") or {})
            cost = pred.get("total_cost", pred.get("total_bytes", 0.0))
            lines.append(
                f"  {c.get('label', '?'):<18} {c.get('status'):<8}"
                f" pred {float(cost) / 1e6:>8.2f}MB-eq  {c.get('reason', '')}"
            )
    return "\n".join(lines) + "\n"


def _tune_from_jsonl(records: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The last tune search in a telemetry dump (the ``xprof_tune``
    snapshot section a ``TuneResult.publish`` leaves behind)."""
    for rec in reversed(records):
        section = (rec.get("sections") or {}).get("xprof_tune")
        if isinstance(section, dict) and section.get("candidates"):
            return section
    return None


def _gang_from_jsonl(records: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The last merged gang budget in a collector sink (or a dumped
    collector snapshot): ``sections.xprof_gang`` on snapshot-shaped
    records, ``xprof`` on ``/gang``-document records."""
    for rec in reversed(records):
        section = (rec.get("sections") or {}).get("xprof_gang")
        if isinstance(section, dict) and section.get("steps"):
            return section
        xprof = rec.get("xprof")
        if isinstance(xprof, dict) and xprof.get("kind") == "gang" \
                and xprof.get("steps"):
            return xprof
    return None


# ---------------------------------------------------------------------------
# Snapshot (JSONL dump) rendering
# ---------------------------------------------------------------------------


def _xprof_snapshot(records: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The last snapshot record that carries published xprof metrics."""
    for rec in reversed(records):
        hists = rec.get("histograms") or {}
        if any(k.startswith("xprof.") for k in hists):
            return rec
    return None


def render_snapshot_report(snap: Dict[str, Any]) -> str:
    """Budget report from a telemetry snapshot (``--telemetry-dump``
    JSONL or a ``/telemetry`` read) — the roll-up view of the same
    numbers :meth:`TraceAnalysis.publish` put on the bus, so a dump
    and a trace render the same budget."""
    hists = snap.get("histograms", {})
    counters = snap.get("counters", {})
    gauges = snap.get("gauges", {})

    def roll(name: str) -> Dict[str, Any]:
        return hists.get(name) or {"count": 0, "sum": 0.0, "p50": None,
                                   "p99": None}

    wall, comm = roll("xprof.step_wall_s"), roll("xprof.comm_s")
    compute = roll("xprof.compute_s")
    lines = [
        f"run: {snap.get('run_id', '?')} (telemetry snapshot)",
        f"steps analyzed: {wall['count']}",
        f"step wall: sum {_fmt_ms(wall['sum'])}"
        + (f", p50 {_fmt_ms(wall['p50'])}, p99 {_fmt_ms(wall['p99'])}"
           if wall["p50"] is not None else ""),
        f"compute:   sum {_fmt_ms(compute['sum'])}",
        f"comm:      sum {_fmt_ms(comm['sum'])}",
    ]
    cf = gauges.get("xprof.comm_fraction_run")
    of = gauges.get("xprof.overlap_fraction_run")
    if cf is not None:
        lines.append(f"comm fraction: {100 * cf:.1f}%"
                     + (f" ({100 * of:.1f}% hidden under compute)"
                        if of is not None else ""))
    fams = [(k, v) for k, v in hists.items()
            if k.startswith("xprof.collective_time_s{")]
    if fams:
        lines.append("collectives (per-step seconds, rolled up):")
        for key, r in sorted(fams, key=lambda kv: -kv[1].get("sum", 0.0)):
            fam = key.split("op=", 1)[-1].rstrip("}")
            n = counters.get(f"xprof.collectives_total{{op={fam}}}", 0)
            lines.append(
                f"  {fam:<16} sum {_fmt_ms(r.get('sum', 0.0)):>10}"
                + (f"  p50 {_fmt_ms(r['p50'])}" if r.get("p50") is not None
                   else "")
                + f"  events {int(n)}"
            )
    else:
        lines.append("collectives: none published")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _looks_like_jsonl(path: str) -> bool:
    return path.endswith((".jsonl", ".ndjson"))


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m sparktorch_tpu_torch.obs.timeline",
        description="Per-step timeline and comm/compute budget from a "
                    "torch.profiler trace or a telemetry JSONL dump; "
                    "--gang merges N per-host traces (or reads a fleet "
                    "collector sink) into one whole-gang view.",
    )
    parser.add_argument("paths", nargs="+", metavar="path",
                        help="trace.json(.gz), a profile log dir, or a "
                             "telemetry/collector .jsonl; --gang "
                             "accepts several traces (one per host)")
    parser.add_argument("--gang", action="store_true",
                        help="render the whole-gang view: per-rank "
                             "lanes, cross-rank skew annotations")
    parser.add_argument("--tune", action="store_true",
                        help="render a mesh auto-tune artifact "
                             "(tune_result.json, or a telemetry JSONL "
                             "carrying the xprof_tune section): "
                             "measured ranking + prune decisions")
    parser.add_argument("--rpc", action="store_true",
                        help="render per-request RPC trace waterfalls "
                             "from a telemetry JSONL dump (rpc_spans) "
                             "or a collector sink (stitched "
                             "rpc_traces): one tree per sampled "
                             "request, critical path starred")
    parser.add_argument("--postmortem", action="store_true",
                        help="render a flight-recorder postmortem "
                             "bundle (postmortem_<ts>.json): causal "
                             "event window, metric deltas, world doc, "
                             "stitched traces")
    parser.add_argument("--follow", action="store_true",
                        help="tail a growing JSONL sink live: render "
                             "alert firings, control-plane transitions "
                             "and goodput ledger records as they land "
                             "(Ctrl-C stops)")
    parser.add_argument("--goodput", action="store_true",
                        help="render a run-level goodput ledger "
                             "(a saved GET /goodput document, or a "
                             "collector/telemetry .jsonl carrying the "
                             "goodput_run/goodput section): stacked "
                             "attribution bar per rank, biggest thief "
                             "named")
    parser.add_argument("--profile", action="store_true",
                        help="render a ledger-keyed stack profile "
                             "(a saved GET /profile document, or a "
                             "collector/telemetry .jsonl carrying the "
                             "profile_run/profile section): per-bucket "
                             "top-down trees, hottest frame named")
    parser.add_argument("--health", action="store_true",
                        help="render a run-level model-health report "
                             "(a saved GET /health document, or a "
                             "collector/telemetry .jsonl carrying the "
                             "health_run/health section): per-rank "
                             "loss/grad-norm sparklines, rank-tagged "
                             "anomaly log, worst anomaly named")
    parser.add_argument("--skew", action="store_true",
                        help="render the cross-rank step-skew verdict "
                             "(a saved GET /skew document, or a "
                             "collector/telemetry .jsonl carrying the "
                             "skew_run/skew section): wire vs "
                             "straggler-wait split, per-rank arrival "
                             "bars, persistent laggard named with a "
                             "cause hypothesis")
    parser.add_argument("--diff", metavar="PRIOR", default=None,
                        help="with --profile: compare against a prior "
                             "profile document/JSONL and render the "
                             "frames whose bucket share moved")
    parser.add_argument("--json", action="store_true",
                        help="emit the raw analysis dict as JSON")
    parser.add_argument("--top", type=int, default=None,
                        help="top-K entries to list (default 10; "
                             "postmortem event window defaults to 40)")
    parser.add_argument("--step-name", default="train_step",
                        help="step annotation event name")
    args = parser.parse_args(argv)
    args.path = args.paths[0]
    # Per-mode defaults: an EXPLICIT --top always wins (a postmortem's
    # wider 40-event window is a default, not a floor).
    if args.top is None:
        args.top = 40 if args.postmortem else 10

    if sum((args.gang, args.tune, args.rpc, args.postmortem,
            args.follow, args.goodput, args.profile, args.health,
            args.skew)) > 1:
        print("error: --gang, --tune, --rpc, --postmortem, --follow, "
              "--goodput, --profile, --health and --skew are different "
              "reports; pick one")
        return 2
    if args.diff is not None and not args.profile:
        print("error: --diff goes with --profile")
        return 2
    if args.profile:
        return _main_profile(args)
    if args.health:
        return _main_health(args)
    if args.skew:
        return _main_skew(args)
    if args.goodput:
        return _main_goodput(args)
    if args.tune:
        return _main_tune(args)
    if args.rpc:
        return _main_rpc(args)
    if args.postmortem:
        return _main_postmortem(args)
    if args.follow:
        return _main_follow(args)
    if args.gang:
        return _main_gang(args)
    if len(args.paths) > 1:
        print("error: multiple paths need --gang (per-host traces "
              "merge into one gang view)")
        return 2

    if _looks_like_jsonl(args.path):
        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        try:
            records = read_jsonl(args.path)
        except OSError as e:
            print(f"error: {e}")
            return 1
        snap = _xprof_snapshot(records)
        if snap is None:
            print(f"no snapshot with xprof.* metrics in {args.path}")
            return 1
        print(json.dumps(snap) if args.json else render_snapshot_report(snap),
              end="" if not args.json else "\n")
        return 0

    try:
        analysis = analyze_trace(args.path, step_name=args.step_name,
                                 top_k=max(args.top, 15))
    except TraceParseError as e:
        print(f"error: {e}")
        return 1
    if args.json:
        print(json.dumps(analysis.to_dict()))
    else:
        print(render_report(analysis, top=args.top), end="")
    return 0


def _main_tune(args) -> int:
    """--tune: a tune_result.json artifact, or a telemetry JSONL dump
    whose last snapshot carries the xprof_tune section."""
    if len(args.paths) > 1:
        print("error: --tune renders one artifact at a time")
        return 2
    path = args.paths[0]
    if _looks_like_jsonl(path):
        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        try:
            records = read_jsonl(path)
        except OSError as e:
            print(f"error: {e}")
            return 1
        doc = _tune_from_jsonl(records)
        if doc is None:
            print(f"no tune search (sections.xprof_tune) in {path}")
            return 1
    else:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: {e}")
            return 1
        if not isinstance(doc, dict) or doc.get("kind") != "tune":
            print(f"error: {path} is not a tune artifact "
                  f"(kind != 'tune')")
            return 1
    print(json.dumps(doc) if args.json else render_tune_report(doc),
          end="" if not args.json else "\n")
    return 0


def _main_goodput(args) -> int:
    """--goodput: a saved /goodput JSON document, or a JSONL whose
    newest record carries the goodput_run (collector) / goodput
    (single rank) section."""
    if len(args.paths) > 1:
        print("error: --goodput renders one file at a time")
        return 2
    path = args.paths[0]
    if _looks_like_jsonl(path):
        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        try:
            records = read_jsonl(path)
        except OSError as e:
            print(f"error: {e}")
            return 1
        doc = _goodput_from_jsonl(records)
        if doc is None:
            print(f"no goodput ledger (sections.goodput_run / "
                  f"sections.goodput) in {path}")
            return 1
    else:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: {e}")
            return 1
        if not isinstance(doc, dict) or not doc.get("buckets"):
            print(f"error: {path} is not a goodput document "
                  f"(no buckets)")
            return 1
    print(json.dumps(doc) if args.json else render_goodput_report(doc),
          end="" if not args.json else "\n")
    return 0


def _main_health(args) -> int:
    """--health: a saved /health JSON document, or a JSONL whose
    newest record carries the health_run (collector) / health
    (single rank) section."""
    if len(args.paths) > 1:
        print("error: --health renders one file at a time")
        return 2
    path = args.paths[0]
    if _looks_like_jsonl(path):
        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        try:
            records = read_jsonl(path)
        except OSError as e:
            print(f"error: {e}")
            return 1
        doc = _health_from_jsonl(records)
        if doc is None:
            print(f"no model-health ledger (sections.health_run / "
                  f"sections.health) in {path}")
            return 1
    else:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: {e}")
            return 1
        if not isinstance(doc, dict) or doc.get("kind") != "health_run":
            print(f"error: {path} is not a health document "
                  f"(kind != 'health_run')")
            return 1
    print(json.dumps(doc) if args.json
          else render_health_report(doc, top=args.top),
          end="" if not args.json else "\n")
    return 0


def _main_skew(args) -> int:
    """--skew: a saved /skew JSON document, or a JSONL whose newest
    record carries the skew_run (collector) / skew (single rank)
    section."""
    if len(args.paths) > 1:
        print("error: --skew renders one file at a time")
        return 2
    path = args.paths[0]
    if _looks_like_jsonl(path):
        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        try:
            records = read_jsonl(path)
        except OSError as e:
            print(f"error: {e}")
            return 1
        doc = _skew_from_jsonl(records)
        if doc is None:
            print(f"no step-skew verdict (sections.skew_run / "
                  f"sections.skew) in {path}")
            return 1
    else:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"error: {e}")
            return 1
        if not isinstance(doc, dict) or doc.get("kind") != "skew_run":
            print(f"error: {path} is not a skew document "
                  f"(kind != 'skew_run')")
            return 1
    print(json.dumps(doc) if args.json
          else render_skew_report(doc, top=args.top),
          end="" if not args.json else "\n")
    return 0


def _load_profile_doc(path: str) -> Tuple[Optional[Dict[str, Any]], int]:
    """A stack-profile doc from a saved /profile JSON document or a
    JSONL carrying the profile_run/profile section; (None, rc) on
    failure, with the error already printed."""
    if _looks_like_jsonl(path):
        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        try:
            records = read_jsonl(path)
        except OSError as e:
            print(f"error: {e}")
            return None, 1
        doc = _profile_from_jsonl(records)
        if doc is None:
            print(f"no stack profile (sections.profile_run / "
                  f"sections.profile) in {path}")
            return None, 1
        return doc, 0
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: {e}")
        return None, 1
    buckets = doc.get("buckets") if isinstance(doc, dict) else None
    if not (isinstance(buckets, dict)
            and all(isinstance(v, dict) and "children" in v
                    for v in buckets.values())):
        print(f"error: {path} is not a stack-profile document "
              f"(no per-bucket tries)")
        return None, 1
    return doc, 0


def _main_profile(args) -> int:
    """--profile: render a profile doc; with --diff, the movement
    against a prior one."""
    if len(args.paths) > 1:
        print("error: --profile renders one file at a time")
        return 2
    doc, rc = _load_profile_doc(args.paths[0])
    if doc is None:
        return rc
    if args.diff is not None:
        prior, rc = _load_profile_doc(args.diff)
        if prior is None:
            return rc
        from sparktorch_tpu_torch.obs.profile import diff_docs

        diff = diff_docs(doc, prior)
        print(json.dumps(diff) if args.json
              else render_profile_diff(diff, top=args.top),
              end="" if not args.json else "\n")
        return 0
    print(json.dumps(doc) if args.json
          else render_profile_report(doc, top=args.top),
          end="" if not args.json else "\n")
    return 0


def _main_rpc(args) -> int:
    """--rpc: request waterfalls from a telemetry dump or a collector
    sink."""
    if len(args.paths) > 1:
        print("error: --rpc renders one JSONL file at a time")
        return 2
    path = args.paths[0]
    if not _looks_like_jsonl(path):
        print("error: --rpc reads a telemetry/collector .jsonl "
              "(rpc_spans or rpc_traces)")
        return 2
    from sparktorch_tpu_torch.obs.sinks import read_jsonl

    try:
        records = read_jsonl(path)
    except OSError as e:
        print(f"error: {e}")
        return 1
    traces = _rpc_from_jsonl(records)
    if not traces:
        print(f"no rpc spans (sections.rpc_spans / rpc_traces) in {path}")
        return 1
    print(json.dumps(traces) if args.json
          else render_rpc_report(traces, top=args.top), end="")
    if args.json:
        print()
    return 0


def _main_postmortem(args) -> int:
    """--postmortem: render one flight-recorder bundle."""
    if len(args.paths) > 1:
        print("error: --postmortem renders one bundle at a time")
        return 2
    from sparktorch_tpu_torch.obs.blackbox import read_postmortem

    try:
        doc = read_postmortem(args.paths[0])
    except (OSError, ValueError) as e:
        print(f"error: {e}")
        return 1
    print(json.dumps(doc) if args.json
          else render_postmortem_report(doc, top=args.top),
          end="" if not args.json else "\n")
    return 0


def _main_follow(args) -> int:
    """--follow: live-tail a JSONL sink until interrupted."""
    if len(args.paths) > 1:
        print("error: --follow tails one JSONL file at a time")
        return 2
    if not _looks_like_jsonl(args.paths[0]):
        print("error: --follow tails a telemetry/collector .jsonl")
        return 2
    try:
        for line in follow(args.paths[0]):
            print(line, flush=True)
    except KeyboardInterrupt:
        pass
    return 0


def _main_gang(args) -> int:
    """--gang: one collector JSONL (already-merged budget) or N
    per-host traces merged here."""
    if len(args.paths) == 1 and _looks_like_jsonl(args.paths[0]):
        from sparktorch_tpu_torch.obs.sinks import read_jsonl

        try:
            records = read_jsonl(args.paths[0])
        except OSError as e:
            print(f"error: {e}")
            return 1
        gang = _gang_from_jsonl(records)
        if gang is None:
            print(f"no merged gang budget (sections.xprof_gang) in "
                  f"{args.paths[0]}")
            return 1
    else:
        analyses = []
        for p in args.paths:
            try:
                analyses.append(analyze_trace(p, step_name=args.step_name))
            except TraceParseError as e:
                print(f"error: {e}")
                return 1
        gang = merge_analyses(analyses).to_dict()
    print(json.dumps(gang) if args.json
          else render_gang_report(gang), end="" if not args.json else "\n")
    return 0


if __name__ == "__main__":
    try:
        raise SystemExit(main())
    except BrokenPipeError:  # e.g. piped into `head`
        raise SystemExit(0)
