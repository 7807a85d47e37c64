"""Observability-discipline rules (SPK101-108).

SPK101-105 are the AST migrations of the Makefile's historical
``lint-obs`` grep stanzas (print / bare span / json.dump / urllib
scraping / span-context minting); SPK106 encodes the
``Telemetry.event(kind=...)`` envelope-key collision the alerts WATCH
documented (the sink record envelope is ``{"ts", "kind", "run_id"}``
plus the collector's rank tag — a payload field with one of those
names silently overwrites the envelope); SPK107 fences the
interpreter's profiling hooks to ``obs/profile.py`` (the continuous
stack sampler owns them); SPK108 keeps device->host readbacks in the
trainers inside an attributed ledger span (the async-dispatch
discipline the health ledger's delayed read exists to preserve). These
are the JAX package's rules with the port's paths; SPK108 is re-aimed
at torch's readbacks (``.item()``, ``.cpu()``, ``.tolist()``,
``.numpy()``, ``synchronize``).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from sparktorch_tpu_torch.lint.core import FileContext, Finding, Rule


def _outside_obs(rel: Optional[str]) -> bool:
    return rel is None or not rel.startswith("obs/")


class ObsPrintRule(Rule):
    id = "SPK101"
    slug = "obs-print"
    summary = "raw print() in library code (use obs.log.get_logger)"
    why = ("the reference's print-based story (distributed.py:201-204) "
           "must not creep back in; structured telemetry goes through "
           "sparktorch_tpu_torch.obs, human lines through obs.log.get_logger")

    # CLIs whose stdout is their contract (same set the grep excluded,
    # plus the analyzer's own CLI).
    EXEMPT = ("bench.py", "net/bench_wire.py", "obs/timeline.py",
              "obs/replay.py", "parallel/tune.py", "lint/cli.py")

    def applies(self, rel: Optional[str]) -> bool:
        return rel not in self.EXEMPT

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.index.calls:
            if (isinstance(node.func, ast.Name)
                    and node.func.id == "print"):
                yield self.finding(
                    ctx, node,
                    "raw print() in library code: structured telemetry "
                    "goes through sparktorch_tpu_torch.obs, human lines "
                    "through obs.log.get_logger")


class BareSpanRule(Rule):
    id = "SPK102"
    slug = "obs-bare-span"
    summary = "bare .span(...) call outside a with-block"
    why = ("a span only records when its with-block closes; a bare call "
           "leaks an un-timed region onto the thread-local stack and "
           "re-paths every nested span under it")

    def applies(self, rel: Optional[str]) -> bool:
        return _outside_obs(rel)

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        idx = ctx.index
        for node in idx.calls:
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "span"):
                continue
            if id(node) in idx.with_ctx or id(node) in idx.enter_ctx:
                continue
            yield self.finding(
                ctx, node,
                "bare .span(...) call: a span only records when its "
                "with-block closes — use `with ...span(...):` (or "
                "ExitStack.enter_context)")


class JsonDumpRule(Rule):
    id = "SPK103"
    slug = "obs-json-dump"
    summary = "raw json.dump outside obs/ (telemetry goes through sinks)"
    why = ("timeline data must flow through the obs sinks (atomicity, "
           "append semantics, scrape==dump parity); genuine "
           "non-telemetry persistence is annotated")

    def applies(self, rel: Optional[str]) -> bool:
        return _outside_obs(rel)

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.index.calls:
            if ctx.index.resolve(node.func) == "json.dump":
                yield self.finding(
                    ctx, node,
                    "raw json.dump outside obs/: telemetry/trace events "
                    "go through the obs sinks; annotate genuine "
                    "non-telemetry persistence with "
                    "`# lint-obs: ok (<why>)`")


class UrllibScrapeRule(Rule):
    id = "SPK104"
    slug = "obs-urllib-scrape"
    summary = "ad-hoc urllib scraping outside obs/"
    why = ("readers of /metrics, /telemetry, /heartbeats, /gang go "
           "through obs.collector.scrape_json/scrape_text (shared "
           "timeout, error taxonomy, degradation discipline)")

    def applies(self, rel: Optional[str]) -> bool:
        return _outside_obs(rel)

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.index.calls:
            if (ctx.index.resolve(node.func)
                    == "urllib.request.urlopen"):
                yield self.finding(
                    ctx, node,
                    "ad-hoc urllib.request.urlopen outside obs/: scrape "
                    "readers go through obs.collector.scrape_json/"
                    "scrape_text; annotate a non-scrape data wire with "
                    "`# lint-obs: ok (<why>)`")


class SpanContextMintRule(Rule):
    id = "SPK105"
    slug = "obs-span-context"
    summary = "RPC span context minted outside obs/"
    why = ("SpanContext construction belongs to obs/rpctrace.py's "
           "helpers (root_span/child_span/SpanContext.child/from_*), "
           "where sampling decisions, SLO forcing, and id entropy stay "
           "audited")

    def applies(self, rel: Optional[str]) -> bool:
        return _outside_obs(rel)

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.index.calls:
            name = ctx.index.resolve(node.func)
            if name is not None and (name == "SpanContext"
                                     or name.endswith(".SpanContext")):
                yield self.finding(
                    ctx, node,
                    "span context minted outside obs/: go through the "
                    "obs.rpctrace tracer helpers (root_span/child_span/"
                    "SpanContext.child), or annotate "
                    "`# lint-obs: ok (<why>)`")


class ProfilerApiRule(Rule):
    id = "SPK107"
    slug = "profiler-api"
    summary = "interpreter profiling hook used outside obs/profile.py"
    why = ("sys.settrace/setprofile slow every Python call in the whole "
           "process and a second sys._current_frames() walker "
           "double-pays the <1%-overhead budget bench-profile gates; "
           "stack sampling goes through obs.profile.StackProfiler, "
           "where rate, bounds, and bucket tagging stay audited")

    HOOKS = ("sys._current_frames", "sys.settrace", "sys.setprofile")

    def applies(self, rel: Optional[str]) -> bool:
        return rel != "obs/profile.py"

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.index.calls:
            name = ctx.index.resolve(node.func)
            if name in self.HOOKS:
                yield self.finding(
                    ctx, node,
                    f"{name}() outside obs/profile.py: interpreter "
                    f"profiling hooks belong to the continuous stack "
                    f"sampler (obs.profile.StackProfiler) — sample "
                    f"through it, or annotate a genuine debug dump "
                    f"with `# lint-obs: ok (<why>)`")


class AsyncFetchRule(Rule):
    id = "SPK108"
    slug = "obs-async-fetch"
    summary = ("unattributed device sync (.item()/.cpu()/.tolist()/"
               ".numpy()/synchronize) in train/")
    why = ("a raw readback in a trainer stalls the async dispatch "
           "pipeline AND hides the stall from the goodput ledger — the "
           "health ledger's delayed read exists so numerics readbacks "
           "land K steps late under data_wait{site=health}; any sync "
           "the trainers do must sit inside a ledger span so the time "
           "is attributed, not silently lost")

    # Tensor methods that copy to the host (and so wait for the
    # device), plus synchronize() on the device, a stream or an event.
    SYNC_ATTRS = ("item", "cpu", "tolist", "numpy", "synchronize")
    SPAN_ATTRS = ("span", "step_span")
    # obs/skew.py is stamp-scope (see SPK201.STAMP_SCOPES): it merges
    # ledger stamps that were captured asynchronously, so a device sync
    # there would put wall time on the merge path of every scrape.
    EXTRA_SCOPES = ("obs/skew.py",)

    def applies(self, rel: Optional[str]) -> bool:
        return (rel is None or rel.startswith("train/")
                or rel.startswith(self.EXTRA_SCOPES))

    def _in_ledger_span(self, ctx: FileContext, node: ast.AST) -> bool:
        for anc in ctx.index.parent_chain(node):
            if not isinstance(anc, (ast.With, ast.AsyncWith)):
                continue
            for item in anc.items:
                expr = item.context_expr
                if (isinstance(expr, ast.Call)
                        and isinstance(expr.func, ast.Attribute)
                        and expr.func.attr in self.SPAN_ATTRS):
                    return True
        return False

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.index.calls:
            name = ctx.index.resolve(node.func)
            if name == "torch.cuda.synchronize":
                what = name
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in self.SYNC_ATTRS):
                what = f".{node.func.attr}()"
            else:
                continue
            if self._in_ledger_span(ctx, node):
                continue
            yield self.finding(
                ctx, node,
                f"{what} in a trainer outside a ledger span: a raw "
                f"device sync stalls dispatch and the stall is "
                f"invisible to the goodput ledger — wrap it in "
                f"`with ...span(...)`/`step_span(...)` (or feed the "
                f"health ledger, which reads K steps late under "
                f"data_wait{{site=health}}), or annotate "
                f"`# lint-obs: ok (<why>)`")


class EventKindCollisionRule(Rule):
    id = "SPK106"
    slug = "event-kind-collision"
    summary = "reserved envelope key passed as an event payload field"
    why = ("sink records are `{ts, kind, run_id, **fields}` and the "
           "collector rank-tags them: a payload field named kind/ts/"
           "rank silently overwrites the envelope (the alerts "
           "`rule_kind` WATCH — Telemetry.event(kind=...) collides)")

    RESERVED = ("kind", "ts", "rank", "run_id")

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.index.calls:
            if not (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "event"):
                continue
            for kw in node.keywords:
                if kw.arg in self.RESERVED:
                    yield self.finding(
                        ctx, kw.value,
                        f"reserved record key `{kw.arg}=` passed as an "
                        f"event payload field: the sink envelope owns "
                        f"{{ts, kind, run_id}} and the collector owns "
                        f"the rank tag — prefix the field "
                        f"(e.g. rule_kind) instead",
                        line=kw.value.lineno)
