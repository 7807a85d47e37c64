"""The fleet collector's module-level helpers — a copy of ``sparktorch_tpu/obs/collector.py:71-197``.

Run ids (:func:`mint_run_id`) and their 16-bit wire tag
(:func:`run_tag`); the one sanctioned way to read an exporter's routes
(:func:`scrape_text`, :func:`scrape_json`) and to post a control verb
(:func:`post_json`), all failing as :class:`ScrapeError`; and
:func:`snapshot_histogram`, a histogram's roll-up in a snapshot matched
by name and a label subset. The :class:`FleetCollector` itself (the
gang-level scrape, merge and re-serve) is not ported yet (ROADMAP,
Queue 1, item 10).
"""

from __future__ import annotations

import json
import os
import time
import urllib.error
import urllib.request
import zlib
from typing import Any, Dict, Mapping, Optional

from sparktorch_tpu_torch.obs.prom import _parse_flat_key  # shared key grammar

_SCRAPE_TIMEOUT = 2.0


def mint_run_id(prefix: str = "gang") -> str:
    """A gang-unique run id: sortable timestamp + random suffix, no
    protocol-reserved characters (spaces, commas, '=' — it travels on
    the gang REG line and as a metric-adjacent token)."""
    return f"{prefix}-{time.strftime('%Y%m%dT%H%M%S')}-{os.urandom(3).hex()}"


def run_tag(run_id: Optional[str]) -> int:
    """16-bit correlation tag for the binary wire header's reserved
    bytes (frames predate string payloads there; two bytes is room for
    a join key, not a name). 0 is reserved for "untagged" — the value
    every pre-tag encoder wrote — so a real run id always maps to a
    nonzero tag."""
    if not run_id:
        return 0
    tag = zlib.crc32(str(run_id).encode()) & 0xFFFF
    return tag or 1


# ---------------------------------------------------------------------------
# Sanctioned scrape helpers
# ---------------------------------------------------------------------------


class ScrapeError(OSError):
    """The exporter was unreachable or answered garbage."""


def scrape_text(url: str, timeout: float = _SCRAPE_TIMEOUT) -> str:
    """GET a text route (e.g. ``/metrics``). Raises ScrapeError on any
    network failure or non-200 status."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            if resp.status != 200:
                raise ScrapeError(f"{url}: HTTP {resp.status}")
            return resp.read().decode("utf-8", errors="replace")
    except ScrapeError:
        raise
    except (OSError, ValueError) as e:
        raise ScrapeError(f"{url}: {type(e).__name__}: {e}") from e


def scrape_json(url: str, timeout: float = _SCRAPE_TIMEOUT) -> Any:
    """GET + parse a JSON route (``/telemetry``, ``/heartbeats``,
    ``/gang``). Raises ScrapeError on network failure, non-200, or a
    body that is not valid JSON (the torn-response case readers must
    survive)."""
    body = scrape_text(url, timeout=timeout)
    try:
        return json.loads(body)
    except ValueError as e:
        raise ScrapeError(f"{url}: torn/invalid JSON: {e}") from e


def post_json(url: str, payload: Mapping[str, Any],
              timeout: float = _SCRAPE_TIMEOUT,
              headers: Optional[Mapping[str, str]] = None) -> Any:
    """POST a JSON document to a control route (``/ctl``) and parse
    the JSON reply — the write-side twin of :func:`scrape_json`, kept
    in obs/ so control traffic shares the same timeout/error taxonomy
    the lint-obs scrape discipline enforces on readers. Raises
    :class:`ScrapeError` on network failure or a non-JSON reply;
    non-2xx statuses raise with the server's body in the message (a
    403 bad-token or 400 unknown-verb reply is the diagnostic)."""
    req = urllib.request.Request(
        url, data=json.dumps(dict(payload)).encode(), method="POST",
        headers={"Content-Type": "application/json",
                 **(dict(headers) if headers else {})},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read().decode("utf-8", errors="replace")
            if resp.status < 200 or resp.status >= 300:
                raise ScrapeError(f"{url}: HTTP {resp.status}: {body}")
    except ScrapeError:
        raise
    except urllib.error.HTTPError as e:
        detail = e.read().decode("utf-8", errors="replace")
        raise ScrapeError(f"{url}: HTTP {e.code}: {detail}") from e
    except (OSError, ValueError) as e:
        raise ScrapeError(f"{url}: {type(e).__name__}: {e}") from e
    try:
        return json.loads(body)
    except ValueError as e:
        raise ScrapeError(f"{url}: torn/invalid JSON reply: {e}") from e


def snapshot_histogram(snapshot: Mapping[str, Any], name: str,
                       labels: Optional[Mapping[str, Any]] = None
                       ) -> Optional[Dict[str, Any]]:
    """The roll-up of histogram ``name`` in a telemetry snapshot dict
    (a ``/telemetry`` scrape, a collector's merged snapshot, or a
    JSONL dump record), matched by name + a label SUBSET: every given
    label must match, EXTRA labels on the series are ignored — a
    collector re-keys scraped series with rank/host labels, and a
    consumer asking for ``serve.request_latency_s{replica=2}`` must
    find it regardless of which target it was scraped from. When
    several series match (the same replica scraped under two targets)
    the one with the largest sample count wins. None when nothing
    matches — readers must treat that as "no signal", never as zero.

    This is the sanctioned read path for routing/consuming decisions
    off scraped snapshots (the lint-obs scrape discipline's read-side
    twin): the ``name{k=v}`` key grammar stays parsed in obs/."""
    hists = snapshot.get("histograms")
    if not isinstance(hists, Mapping):
        return None
    want = {str(k): str(v) for k, v in (labels or {}).items()}
    best: Optional[Dict[str, Any]] = None
    for flat, rollup in hists.items():
        series_name, series_labels = _parse_flat_key(str(flat))
        if series_name != name or not isinstance(rollup, Mapping):
            continue
        have = dict(series_labels)
        if any(have.get(k) != v for k, v in want.items()):
            continue
        if best is None or (rollup.get("count") or 0) > \
                (best.get("count") or 0):
            best = dict(rollup)
    return best


# ---------------------------------------------------------------------------
# The collector
# ---------------------------------------------------------------------------
