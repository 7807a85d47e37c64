"""Handle-lifecycle rule (SPK501): native-handle access after stop/kill.

The shipped bug: the JAX package's elastic bench read ``coord.generation`` after
the ``finally: coord.stop()`` had freed the native gang state — a
use-after-free that segfaulted the whole bench process. The fix
snapshotted final state *before* the free; the rule keeps the class
out: within one function scope, attribute access on a native handle
(``GangCoordinator``, ``ProcessWorker``, anything from
``spawn_worker``) after ``.stop()``/``.kill()`` on the same name, with
no reassignment in between, is flagged unless the attribute is in the
documented post-stop-safe set (supervisor contract: ``error``,
``is_alive``, ``join``...). Reads of snapshot properties that are
*designed* to survive stop carry ``# lint-obs: ok (<why>)``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Tuple

from sparktorch_tpu_torch.lint.core import FileContext, Finding, Rule

# Constructors whose results hold native/process state that dies with
# stop()/kill().
_HANDLE_CTORS = {"GangCoordinator", "ProcessWorker", "spawn_worker"}

# The supervisor handle contract: these stay valid after stop/kill
# (pure-Python side: exit decoding, liveness polling, idempotent
# re-stop, payload cleanup).
_SAFE_AFTER_STOP = {
    "stop", "kill", "join", "is_alive", "cleanup", "error", "name",
    "returncode", "exitcode", "rank",
}


def _base_name(node: ast.AST) -> Optional[str]:
    """Dotted base of an attribute access, depth <= 2: `coord` or
    `self._coord`."""
    if isinstance(node, ast.Name):
        return node.id
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)):
        return f"{node.value.id}.{node.attr}"
    return None


class _ScopeEvents:
    __slots__ = ("handles", "stops", "reassigns", "accesses")

    def __init__(self) -> None:
        self.handles: Dict[str, int] = {}        # base -> ctor line
        self.stops: Dict[str, int] = {}          # base -> earliest stop
        self.reassigns: Dict[str, List[int]] = {}
        self.accesses: List[Tuple[str, str, ast.Attribute]] = []


class HandleLifecycleRule(Rule):
    id = "SPK501"
    slug = "handle-lifecycle"
    summary = "native handle used after .stop()/.kill() in the same scope"
    why = ("the elastic bench segfaulted reading coord.generation "
           "after the finally-stop freed the native gang state; "
           "snapshot before stop, or reassign the handle")

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        idx = ctx.index
        scopes: Dict[int, _ScopeEvents] = {}

        def events(node: ast.AST) -> _ScopeEvents:
            key = id(idx.scope_of.get(id(node)))
            ev = scopes.get(key)
            if ev is None:
                ev = scopes[key] = _ScopeEvents()
            return ev

        for node in idx.assigns:
            value_ctor = (
                isinstance(node.value, ast.Call)
                and (idx.resolve(node.value.func) or ""
                     ).rsplit(".", 1)[-1] in _HANDLE_CTORS)
            ev = events(node)
            for tgt in node.targets:
                base = _base_name(tgt)
                if base is None:
                    continue
                if value_ctor and base not in ev.handles:
                    ev.handles[base] = node.lineno
                ev.reassigns.setdefault(base, []).append(node.lineno)
        for node in idx.calls:
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("stop", "kill")):
                base = _base_name(node.func.value)
                if base is not None:
                    ev = events(node)
                    line = ev.stops.get(base)
                    if line is None or node.lineno < line:
                        ev.stops[base] = node.lineno
        for node in idx.attributes:
            if isinstance(node.ctx, ast.Load):
                base = _base_name(node.value)
                if base is not None:
                    events(node).accesses.append((base, node.attr, node))

        for ev in scopes.values():
            for base, attr, node in ev.accesses:
                if base not in ev.handles or base not in ev.stops:
                    continue
                stop_line = ev.stops[base]
                if stop_line < ev.handles[base]:
                    continue  # stop of a previous incarnation
                if node.lineno <= stop_line or attr in _SAFE_AFTER_STOP:
                    continue
                if any(stop_line < ln <= node.lineno
                       for ln in ev.reassigns.get(base, [])):
                    continue
                yield self.finding(
                    ctx, node,
                    f"`{base}.{attr}` read after `{base}.stop()/.kill()` "
                    f"(line {stop_line}) with no reassignment — native "
                    f"handle state is freed on stop (the "
                    f"stopped-GangCoordinator segfault); snapshot "
                    f"before stopping, or annotate a documented "
                    f"post-stop-safe property with "
                    f"`# lint-obs: ok (<why>)`")
