"""Lock-hold rule (SPK301): expensive work inside ``with <lock>:``.

The shipped bug class: the JAX package's router computed latency
percentiles while holding the routing lock, and the telemetry bus's
histogram roll-ups did the same under the bus lock — every counter bump on
every thread waited on an O(4096) ``np.percentile``. The fixed idiom
(``obs.telemetry.rollup_from_state``) snapshots cheap state under the
lock and computes outside it. This rule flags calls that are expensive
by construction (percentiles, serialization, file/socket/HTTP IO,
sleeps, compiles, device transfers and syncs) lexically inside a with-block
whose context expression is lock-shaped.

Deliberate exceptions (e.g. a JSONL sink whose lock IS the file's
writer lock) carry ``# lint-obs: ok (<why>)`` on the call line.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, List, Optional

from sparktorch_tpu_torch.lint.core import FileContext, Finding, Rule

# Last dotted component of the with-context expression: self._lock,
# lock, _bus_lock, routing_mutex...
_LOCK_NAME_RE = re.compile(r"(^|_)(lock|mutex)$", re.IGNORECASE)

# Canonical call targets that are expensive by construction.
_EXPENSIVE_EXACT = {
    "numpy.percentile", "numpy.quantile", "numpy.median", "numpy.sort",
    "json.dump", "json.dumps", "json.load", "json.loads",
    "time.sleep",
    "urllib.request.urlopen",
    "subprocess.run", "subprocess.check_output", "subprocess.check_call",
    "subprocess.Popen",
    "requests.get", "requests.post", "requests.request",
    "jax.jit", "jax.device_get", "jax.device_put",
    "torch.compile", "torch.cuda.synchronize", "torch.save", "torch.load",
    "open",
}

# Method names that are IO no matter the receiver (socket/HTTP waits).
_EXPENSIVE_ATTRS = {
    "recv", "recv_into", "sendall", "connect", "accept",
    "getresponse", "urlopen", "block_until_ready",
}


def _lock_like(ctx: FileContext, expr: ast.AST) -> Optional[str]:
    """Dotted name of a lock-shaped with-context expression, else None.
    Only bare Name/Attribute chains count — ``with Lock():`` creates a
    private lock nothing else contends on."""
    if not isinstance(expr, (ast.Name, ast.Attribute)):
        return None
    name = ctx.index.resolve(expr)
    if name is None:
        return None
    if _LOCK_NAME_RE.search(name.rsplit(".", 1)[-1]):
        return name
    return None


def _walk_immediate(body: List[ast.stmt]) -> Iterator[ast.AST]:
    """Walk statements recursively but never descend into nested
    function/lambda bodies — those run later, not under the lock."""
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


class LockHoldRule(Rule):
    id = "SPK301"
    slug = "lock-hold"
    summary = "expensive call while holding a lock"
    why = ("the router/bus regression: percentile roll-ups "
           "computed under the hot-path lock serialized every reader; "
           "snapshot under the lock, compute outside")

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.index.withs:
            lock_name = None
            for item in node.items:
                lock_name = _lock_like(ctx, item.context_expr)
                if lock_name:
                    break
            if not lock_name:
                continue
            for inner in _walk_immediate(node.body):
                if not isinstance(inner, ast.Call):
                    continue
                target = ctx.index.resolve(inner.func)
                expensive = (target in _EXPENSIVE_EXACT
                             if target is not None else False)
                if (not expensive and isinstance(inner.func, ast.Attribute)
                        and inner.func.attr in _EXPENSIVE_ATTRS):
                    expensive = True
                    target = inner.func.attr
                if expensive:
                    yield self.finding(
                        ctx, inner,
                        f"`{target}` called while holding `{lock_name}` "
                        f"— expensive work under a lock serializes "
                        f"every contender (the percentile-"
                        f"under-the-bus-lock regression); snapshot "
                        f"under the lock and compute outside, or "
                        f"annotate `# lint-obs: ok (<why>)`")
