"""Timing-ledger rule (SPK201): raw clock reads outside the sanctioned
idioms.

AST replacement for the Makefile's two clock grep bans, with the two
holes they had closed: import aliasing (``from time import
perf_counter`` / ``import time as t`` were invisible to the grep) and
line-break evasion. The contract (README "Goodput ledger"):

- DURATION math uses ``time.perf_counter()`` — the wall clock steps
  under NTP slew and a negative "latency" has bitten this repo;
  genuine wall-clock TIMESTAMPS go through the named helper
  ``obs.telemetry.wall_ts()`` so the two stay distinguishable.
- In the ledger-covered packages (train/, ctl/, parallel/, serve/)
  even ``perf_counter`` is not free: measured regions go through
  ``obs.goodput`` LedgerSpans (``goodput.span``/``step_span``, read
  ``.duration_s``) so the run-level time ledger stays MECE. Control-
  flow clocks (deadlines, backoff, throttles) annotate
  ``# lint-obs: ok (<why>)``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from sparktorch_tpu_torch.lint.core import FileContext, Finding, Rule


class TimingLedgerRule(Rule):
    id = "SPK201"
    slug = "timing-ledger"
    summary = "raw clock read outside the wall_ts/LedgerSpan idioms"
    why = ("the goodput ledger converted the raw-clock sites so every measured second "
           "lands in exactly one goodput bucket; a raw clock in a "
           "ledger-covered package is either an unattributed measured "
           "region or an NTP-vulnerable duration")

    # perf_counter is banned (outside LedgerSpans) only where the
    # goodput ledger owns time attribution.
    LEDGER_SCOPES = ("train/", "ctl/", "parallel/", "serve/")

    # Stamp scope: modules that derive cross-rank step-boundary stamps
    # from the ledger's span clock. Here BOTH clocks are banned — a
    # local clock read would create a second time base that cannot be
    # aligned across ranks (the skew merge subtracts stamps from
    # different hosts; only ledger-anchored stamps share an epoch).
    STAMP_SCOPES = ("obs/skew.py",)

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        rel = ctx.rel
        in_stamp_scope = rel is not None and rel.startswith(self.STAMP_SCOPES)
        in_obs = (rel is not None and rel.startswith("obs/")
                  and not in_stamp_scope)
        in_ledger_scope = rel is None or rel.startswith(self.LEDGER_SCOPES)
        for node in ctx.index.calls:
            name = ctx.index.resolve(node.func)
            if name == "time.time" and not in_obs:
                if in_stamp_scope:
                    yield self.finding(
                        ctx, node,
                        "raw time.time() in a stamp-scope module: skew "
                        "step-boundary stamps must come from the "
                        "ledger's span clock (GoodputLedger stamps "
                        "inside step_span; obs/skew.py only does "
                        "arithmetic over them), or annotate "
                        "`# lint-obs: ok (<why>)`")
                else:
                    yield self.finding(
                        ctx, node,
                        "raw time.time(): durations must use "
                        "time.perf_counter(); wall-clock timestamps go "
                        "through obs.telemetry.wall_ts(), or annotate "
                        "`# lint-obs: ok (<why>)`")
            elif name == "time.perf_counter" and in_stamp_scope:
                yield self.finding(
                    ctx, node,
                    "raw perf_counter in a stamp-scope module: skew "
                    "step-boundary stamps must come from the ledger's "
                    "span clock (LedgerSpan captures enter/exit once "
                    "inside step_span) — a second clock read here "
                    "cannot be aligned across ranks; annotate "
                    "`# lint-obs: ok (<why>)`")
            elif name == "time.perf_counter" and in_ledger_scope:
                yield self.finding(
                    ctx, node,
                    "raw perf_counter timing in a ledger-covered "
                    "package: measured regions go through obs.goodput "
                    "LedgerSpans (goodput.span/step_span, read "
                    ".duration_s) so the run ledger stays MECE; "
                    "annotate a control-flow clock with "
                    "`# lint-obs: ok (<why>)`")
