"""sparklint — the port's AST-based static-analysis pass.

The port's own copy of the JAX package's ``sparktorch_tpu.lint``: the
same engine, CLI, rule IDs and suppression syntax, scoped to
``sparktorch_tpu_torch/``, with SPK108, SPK401 and SPK402 re-aimed at
torch (readbacks, ``torch.compile`` recompiles, ``torch.distributed``
groups). Every rule encodes a bug class (see each rule's ``why``). CLI::

    python -m sparktorch_tpu_torch.lint [paths] [--json] [--rule ID ...]

Suppression is per-line and shares the historical annotation the greps
established: ``# lint-obs: ok (<why>)`` on the finding's line (or a
pure-comment line directly above it).
"""

from sparktorch_tpu_torch.lint.core import (  # noqa: F401
    FileContext,
    Finding,
    ModuleIndex,
    Rule,
    lint_file,
    run_lint,
)
from sparktorch_tpu_torch.lint.rules_torch import (
    CollectiveContextRule,
    RecompileHazardRule,
)
from sparktorch_tpu_torch.lint.rules_lifecycle import HandleLifecycleRule
from sparktorch_tpu_torch.lint.rules_locks import LockHoldRule
from sparktorch_tpu_torch.lint.rules_obs import (
    AsyncFetchRule,
    BareSpanRule,
    EventKindCollisionRule,
    JsonDumpRule,
    ObsPrintRule,
    ProfilerApiRule,
    SpanContextMintRule,
    UrllibScrapeRule,
)
from sparktorch_tpu_torch.lint.rules_timing import TimingLedgerRule

#: Registry, ordered by rule ID. Adding a rule = subclass
#: :class:`~sparktorch_tpu_torch.lint.core.Rule`, set id/slug/summary/why,
#: implement run(), append here, and give it a true-positive +
#: true-negative fixture pair in tests/fixtures/lint/ (the rules shared
#: with the JAX package) or tests/fixtures/lint_torch/ (the re-aimed ones).
ALL_RULES = (
    ObsPrintRule(),
    BareSpanRule(),
    JsonDumpRule(),
    UrllibScrapeRule(),
    SpanContextMintRule(),
    EventKindCollisionRule(),
    ProfilerApiRule(),
    AsyncFetchRule(),
    TimingLedgerRule(),
    LockHoldRule(),
    RecompileHazardRule(),
    CollectiveContextRule(),
    HandleLifecycleRule(),
)


def rules_by_selector(selectors):
    """Resolve ``--rule`` selectors (rule IDs or slugs, case-
    insensitive) against the registry; raises KeyError naming the
    unknown selector."""
    if not selectors:
        return ALL_RULES
    by_key = {}
    for r in ALL_RULES:
        by_key[r.id.lower()] = r
        by_key[r.slug.lower()] = r
    picked = []
    for sel in selectors:
        rule = by_key.get(sel.lower())
        if rule is None:
            raise KeyError(sel)
        if rule not in picked:
            picked.append(rule)
    return tuple(picked)
