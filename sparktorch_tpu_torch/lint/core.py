"""sparklint core — shared AST machinery for the rule passes (the port's
copy of ``sparktorch_tpu/lint/core.py``, scoped to this package).

The analyzer exists because three regressions that actually shipped
in the JAX package (percentile roll-ups computed while holding the bus lock, the
``Telemetry.event(kind=...)`` envelope collision, the use-after-free on
a stopped ``GangCoordinator`` handle) were all statically detectable,
and the Makefile's grep stanzas could see none of them: grep has no
notion of a with-block body, a call's argument list, or the scope a
name was stopped in. Every rule here is AST-based, carries a stable ID
(``SPK...``), and honors the per-line ``# lint-obs: ok (<why>)``
annotation convention the greps established.

Layout: this module owns ``Finding``, ``Rule``, ``ModuleIndex`` (the
per-file resolution index every rule shares) and ``run_lint`` (the
file walker). The rules themselves live in ``rules_*.py`` siblings and
register through ``sparktorch_tpu_torch.lint.ALL_RULES``. Path scoping
keys on the directory ``sparktorch_tpu_torch``, so the rules scope the
port's own files as the JAX engine scopes its package's.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

# The suppression marker shared with the historical grep lints: a
# finding on a line carrying it (or on a line whose previous line is a
# pure comment carrying it) is accepted as a documented exception.
SUPPRESS_RE = re.compile(r"lint-obs:\s*ok\b")

PARSE_RULE_ID = "SPK000"
PARSE_RULE_SLUG = "parse-error"

PACKAGE_NAME = "sparktorch_tpu_torch"


@dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str
    slug: str
    path: str
    line: int
    col: int
    message: str
    snippet: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {
            "rule": self.rule,
            "slug": self.slug,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "snippet": self.snippet,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule} [{self.slug}] {self.message}")


_SCOPE_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


class ModuleIndex:
    """Per-file resolution index shared by every rule.

    Built in ONE traversal per parsed module (the rules iterate the
    typed node buckets instead of re-walking the tree — the analyzer's
    wall-time gate depends on this): parent links, a scope map
    (innermost enclosing function/lambda per node), an import-alias
    map so ``np.percentile`` and ``from numpy import percentile`` both
    resolve to ``numpy.percentile``, module-level string constants
    (axis names like ``AXIS_EP = "ep"``), and the set of calls
    that are with-block context expressions (what the bare-span grep
    could never see across line breaks).
    """

    def __init__(self, tree: ast.Module) -> None:
        self.tree = tree
        self.parents: Dict[ast.AST, ast.AST] = {}
        self.aliases: Dict[str, str] = {}
        self.str_consts: Dict[str, str] = {}
        self.with_ctx: Set[int] = set()
        self.enter_ctx: Set[int] = set()
        # Typed buckets, filled by the single traversal below.
        self.calls: List[ast.Call] = []
        self.withs: List[ast.AST] = []
        self.funcdefs: List[ast.AST] = []
        self.assigns: List[ast.Assign] = []
        self.attributes: List[ast.Attribute] = []
        self.names: List[ast.Name] = []
        self.fors: List[ast.AST] = []
        self.globals_: List[ast.Global] = []
        self.subscripts: List[ast.Subscript] = []
        # id(node) -> innermost enclosing FunctionDef/Lambda (None at
        # module level); scope_parent chains scopes outward.
        self.scope_of: Dict[int, Optional[ast.AST]] = {}
        self.scope_parent: Dict[int, Optional[ast.AST]] = {}
        self.scope_children: Dict[int, List[ast.AST]] = {}

        stack: List[Tuple[ast.AST, Optional[ast.AST]]] = [(tree, None)]
        while stack:
            node, scope = stack.pop()
            self.scope_of[id(node)] = scope
            child_scope = scope
            if isinstance(node, _SCOPE_TYPES):
                self.funcdefs.append(node)
                self.scope_parent[id(node)] = scope
                self.scope_children.setdefault(id(scope), []).append(node)
                child_scope = node
            elif isinstance(node, ast.Call):
                self.calls.append(node)
                if (isinstance(node.func, ast.Attribute)
                        and node.func.attr == "enter_context"):
                    for arg in node.args:
                        self.enter_ctx.add(id(arg))
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                self.withs.append(node)
                for item in node.items:
                    self.with_ctx.add(id(item.context_expr))
            elif isinstance(node, ast.Assign):
                self.assigns.append(node)
            elif isinstance(node, ast.Attribute):
                self.attributes.append(node)
            elif isinstance(node, ast.Name):
                self.names.append(node)
            elif isinstance(node, (ast.For, ast.AsyncFor)):
                self.fors.append(node)
            elif isinstance(node, ast.Global):
                self.globals_.append(node)
            elif isinstance(node, ast.Subscript):
                self.subscripts.append(node)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.aliases[a.asname] = a.name
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mod = node.module or ""
                for a in node.names:
                    if a.name == "*":
                        continue
                    full = f"{mod}.{a.name}" if mod else a.name
                    self.aliases[a.asname or a.name] = full
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
                stack.append((child, child_scope))
        for stmt in tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and isinstance(stmt.value, ast.Constant)
                    and isinstance(stmt.value.value, str)):
                self.str_consts[stmt.targets[0].id] = stmt.value.value

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted path for a Name/Attribute chain, resolving
        import aliases (``np.percentile`` -> ``numpy.percentile``,
        ``perf_counter`` -> ``time.perf_counter``). ``self._lock``
        resolves literally. Non-name bases (calls, subscripts) resolve
        to None."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))

    def parent_chain(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)

    def enclosing_functions(self, node: ast.AST) -> List[ast.AST]:
        """Innermost-first FunctionDef/Lambda chain around a node."""
        chain: List[ast.AST] = []
        scope = self.scope_of.get(id(node))
        while scope is not None:
            chain.append(scope)
            scope = self.scope_parent.get(id(scope))
        return chain


@dataclass
class FileContext:
    path: str
    rel: Optional[str]  # package-relative path ("obs/telemetry.py"), or
    # None for files outside the sparktorch_tpu_torch package (fixtures): rules
    # then apply with no path scoping so fixture files exercise them all.
    tree: ast.Module
    lines: List[str]
    index: ModuleIndex

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()[:160]
        return ""


class Rule:
    """Base class: subclasses set ``id``/``slug``/``summary``/``why``
    (the shipped bug class that motivated the rule) and implement
    ``run``. ``applies`` scopes by package-relative path — the same
    scoping the grep stanzas encoded with ``grep -v`` path filters."""

    id: str = ""
    slug: str = ""
    summary: str = ""
    why: str = ""

    def applies(self, rel: Optional[str]) -> bool:
        return True

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: FileContext, node: ast.AST,
                message: str, line: Optional[int] = None) -> Finding:
        ln = line if line is not None else getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=self.id, slug=self.slug, path=ctx.path,
                       line=ln, col=col, message=message,
                       snippet=ctx.snippet(ln))


def package_rel(path: str) -> Optional[str]:
    """Path relative to the innermost ``sparktorch_tpu_torch`` package dir,
    or None when the file is outside the package (then no path scoping
    applies — fixture files must exercise every rule)."""
    parts = os.path.normpath(os.path.abspath(path)).split(os.sep)
    if PACKAGE_NAME not in parts:
        return None
    i = len(parts) - 1 - parts[::-1].index(PACKAGE_NAME)
    rel = "/".join(parts[i + 1:])
    return rel or None


def iter_py_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d != "__pycache__"
                                 and not d.startswith("."))
                for f in sorted(files):
                    if f.endswith(".py"):
                        yield os.path.join(root, f)
        elif p.endswith(".py"):
            yield p


def _suppressed(finding: Finding, lines: List[str]) -> bool:
    ln = finding.line
    if 1 <= ln <= len(lines) and SUPPRESS_RE.search(lines[ln - 1]):
        return True
    if ln >= 2:
        prev = lines[ln - 2].lstrip()
        if prev.startswith("#") and SUPPRESS_RE.search(prev):
            return True
    return False


def lint_file(path: str, rules: Sequence[Rule]) -> List[Finding]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            source = f.read()
    except OSError as exc:
        # An unreadable file is a finding, not a crash: the CLI's
        # exit-code/--json/--log contract must survive it.
        return [Finding(rule=PARSE_RULE_ID, slug=PARSE_RULE_SLUG,
                        path=path, line=1, col=0,
                        message=f"could not read: {exc}")]
    lines = source.splitlines()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(rule=PARSE_RULE_ID, slug=PARSE_RULE_SLUG,
                        path=path, line=exc.lineno or 1,
                        col=exc.offset or 0,
                        message=f"could not parse: {exc.msg}")]
    rel = package_rel(path)
    ctx = FileContext(path=path, rel=rel, tree=tree, lines=lines,
                      index=ModuleIndex(tree))
    findings: List[Finding] = []
    for rule in rules:
        if not rule.applies(rel):
            continue
        findings.extend(f for f in rule.run(ctx)
                        if not _suppressed(f, lines))
    return findings


def run_lint(paths: Sequence[str],
             rules: Sequence[Rule]) -> Tuple[List[Finding], int]:
    """Lint every .py file under ``paths``; returns (findings sorted by
    location, files scanned)."""
    findings: List[Finding] = []
    n_files = 0
    for path in iter_py_files(paths):
        n_files += 1
        findings.extend(lint_file(path, rules))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, n_files
