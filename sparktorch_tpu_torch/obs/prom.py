"""Prometheus text-format exporter for :class:`Telemetry` state — a copy of ``sparktorch_tpu/obs/prom.py``.

Renders a telemetry snapshot as Prometheus exposition text
(text/plain; version 0.0.4): counters and gauges as-is, histograms
and spans as summaries (quantile series + ``_sum``/``_count``). The
parameter server serves this from ``GET /metrics``
(:mod:`sparktorch_tpu_torch.serve.param_server`); the bench CLI dumps
the same snapshot as JSONL (``--telemetry-dump``) — both views come
from ONE ``Telemetry.snapshot()`` call, so they cannot disagree. The
text is the JAX package's for the same snapshot, so a dashboard
written against the reference reads the port unchanged.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_RE = re.compile(r"[^a-zA-Z0-9_]")

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def sanitize_name(name: str) -> str:
    """Metric name to the Prometheus charset: dots/slashes/dashes
    become underscores; a leading digit gets a ``_`` prefix."""
    out = _NAME_RE.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _parse_flat_key(flat: str) -> Tuple[str, Dict[str, str]]:
    """Invert :func:`telemetry.format_key`: ``name{k=v,...}`` ->
    (name, labels)."""
    if not flat.endswith("}") or "{" not in flat:
        return flat, {}
    name, _, inner = flat.partition("{")
    labels: Dict[str, str] = {}
    for pair in inner[:-1].split(","):
        if not pair:
            continue
        k, _, v = pair.partition("=")
        labels[k] = v
    return name, labels


def _escape_label_value(value: str) -> str:
    return value.replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")


def _labels_text(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_LABEL_RE.sub("_", k)}="{_escape_label_value(str(v))}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _merge_labels(labels: Dict[str, str], extra: Dict[str, str]) -> Dict[str, str]:
    out = dict(labels)
    out.update(extra)
    return out


def render_prometheus(snapshot: Dict[str, Any],
                      namespace: Optional[str] = "sparktorch") -> str:
    """Render a ``Telemetry.snapshot()`` dict as exposition text."""
    prefix = f"{sanitize_name(namespace)}_" if namespace else ""
    lines = []
    typed = set()

    def emit(name: str, mtype: str, labels: Dict[str, str], value: Any,
             suffix: str = "") -> None:
        if value is None:
            return
        full = prefix + sanitize_name(name)
        if full not in typed:
            lines.append(f"# TYPE {full} {mtype}")
            typed.add(full)
        lines.append(f"{full}{suffix}{_labels_text(labels)} {float(value)}")

    for flat, value in snapshot.get("counters", {}).items():
        name, labels = _parse_flat_key(flat)
        emit(name, "counter", labels, value)
    for flat, value in snapshot.get("gauges", {}).items():
        name, labels = _parse_flat_key(flat)
        emit(name, "gauge", labels, value)
    for flat, text in snapshot.get("info", {}).items():
        # build_info convention: the string rides as a label on a
        # constant-1 gauge, so scrapers keep it without a text type.
        name, labels = _parse_flat_key(flat)
        emit(name, "gauge", _merge_labels(labels, {"value": str(text)}), 1.0)
    for section in ("histograms", "spans"):
        for flat, roll in snapshot.get(section, {}).items():
            name, labels = _parse_flat_key(flat)
            full = prefix + sanitize_name(name)
            if full not in typed:
                lines.append(f"# TYPE {full} summary")
                typed.add(full)
            for q in ("0.5", "0.95", "0.99"):
                key = "p" + str(int(float(q) * 100))
                if roll.get(key) is None:
                    continue
                ql = _merge_labels(labels, {"quantile": q})
                lines.append(f"{full}{_labels_text(ql)} {float(roll[key])}")
            lines.append(
                f"{full}_sum{_labels_text(labels)} {float(roll.get('sum', 0.0))}"
            )
            lines.append(
                f"{full}_count{_labels_text(labels)} "
                f"{float(roll.get('count', 0))}"
            )
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, float]:
    """Minimal exposition-text parser (tests + scrape round-trips):
    ``name{labels}`` -> value, comments skipped. Later samples of a
    duplicated series win, like a real scraper's last-value read."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        series, _, value = line.rpartition(" ")
        try:
            out[series] = float(value)
        except ValueError:
            continue
    return out
