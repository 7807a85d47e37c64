"""Torch hazard rules (SPK401 recompile-hazard, SPK402 collective-context).

The counterparts of the JAX package's ``rules_jax.py``, with the same
IDs so a reader can find the rule each one answers.

SPK401: a ``torch.compile``d callable invoked with Python scalars
derived from values that vary per call (``len(...)``,
``range``/``enumerate`` loop indices). Dynamo guards on the value of a
Python int argument and recompiles for each new one (after the first
recompile it may mark the argument dynamic, at the price of a second
graph), so a per-call-varying scalar at a compile boundary is a
compile-cache decision that must be explicit: ``dynamic=True`` on the
``torch.compile`` call, or fold the value into a tensor. The second
shape: a compiled function that closes over a *mutable module global*
— Dynamo guards on the global and recompiles when it changes, or, for
a container it cannot guard, bakes the value of the first trace.

SPK402: a ``torch.distributed`` collective that passes no ``group=``
(or ``group=None``) runs over the default WORLD group. With mesh axes
beyond data parallelism the same process belongs to several sub-groups
(tp, sp, ep), and a collective that silently spans WORLD deadlocks or
mixes shards. A collective whose group arrives as a *parameter* of the
enclosing function is the caller's obligation and is skipped, as the
JAX rule skips a parameter axis.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set

from sparktorch_tpu_torch.lint.core import FileContext, Finding, Rule

_COMPILE_NAMES = {"torch.compile"}


def _is_compile_call(ctx: FileContext, node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and ctx.index.resolve(node.func) in _COMPILE_NAMES)


def _declares_dynamic(call: ast.AST) -> bool:
    """``torch.compile(..., dynamic=True)``: the call says its scalars
    are symbolic, the counterpart of a JAX static declaration."""
    if not isinstance(call, ast.Call):
        return False
    return any(kw.arg == "dynamic" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


class RecompileHazardRule(Rule):
    id = "SPK401"
    slug = "recompile-hazard"
    summary = "torch.compile'd call keyed on a per-call-varying Python scalar"
    why = ("the recompile-tax class: Dynamo guards on every Python scalar "
           "that reaches a compiled callable, so len()/loop-index "
           "arguments recompile per call unless the call is declared "
           "dynamic")

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        yield from self._varying_scalar_args(ctx)
        yield from self._mutable_global_closures(ctx)

    # -- compiled calls fed len(...) / loop indices --------------------
    def _varying_scalar_args(self, ctx: FileContext) -> Iterator[Finding]:
        idx = ctx.index
        compiled: Set[str] = set()
        for node in idx.assigns:
            if (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and _is_compile_call(ctx, node.value)
                    and not _declares_dynamic(node.value)):
                compiled.add(node.targets[0].id)
        for node in idx.funcdefs:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                if ((idx.resolve(dec) in _COMPILE_NAMES)
                        or (_is_compile_call(ctx, dec)
                            and not _declares_dynamic(dec))):
                    compiled.add(node.name)
        if not compiled:
            return
        # Integer-ish loop variables, keyed by the For node that binds
        # them: an argument counts only when the call site is lexically
        # inside the binding loop.
        loop_vars: Dict[str, List[ast.AST]] = {}
        for node in idx.fors:
            it = node.iter
            src = (idx.resolve(it.func)
                   if isinstance(it, ast.Call) else None)
            if src == "range":
                if isinstance(node.target, ast.Name):
                    loop_vars.setdefault(node.target.id, []).append(node)
            elif src == "enumerate":
                if (isinstance(node.target, ast.Tuple) and node.target.elts
                        and isinstance(node.target.elts[0], ast.Name)):
                    loop_vars.setdefault(
                        node.target.elts[0].id, []).append(node)

        def varying(arg: ast.AST) -> Optional[str]:
            if (isinstance(arg, ast.Call) and isinstance(arg.func, ast.Name)
                    and arg.func.id == "len"):
                return "len(...)"
            if isinstance(arg, ast.Name) and arg.id in loop_vars:
                binders = loop_vars[arg.id]
                if any(p in binders for p in idx.parent_chain(arg)):
                    return f"loop index `{arg.id}`"
            return None

        for node in idx.calls:
            if not (isinstance(node.func, ast.Name)
                    and node.func.id in compiled):
                continue
            args = list(node.args) + [kw.value for kw in node.keywords
                                      if kw.arg]
            for arg in args:
                desc = varying(arg)
                if desc:
                    yield self.finding(
                        ctx, arg,
                        f"{desc} passed to compiled `{node.func.id}`: "
                        f"Dynamo guards on a Python scalar's value, so a "
                        f"per-call-varying one recompiles per call; "
                        f"declare `torch.compile(..., dynamic=True)` or "
                        f"pass it as a tensor")

    # -- compiled closures over mutable module globals ------------------
    def _mutable_global_closures(self, ctx: FileContext) -> Iterator[Finding]:
        idx = ctx.index
        mutable: Set[str] = set()
        for stmt in ctx.tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                v = stmt.value
                if isinstance(v, (ast.List, ast.Dict, ast.Set)):
                    mutable.add(stmt.targets[0].id)
                elif (isinstance(v, ast.Call)
                        and idx.resolve(v.func) in ("dict", "list", "set")):
                    mutable.add(stmt.targets[0].id)
        if not mutable:
            return
        mutated: Set[str] = set()
        mutators = {"append", "update", "pop", "clear", "extend",
                    "setdefault", "add", "remove", "insert"}
        for g in idx.globals_:
            mutated.update(n for n in g.names if n in mutable)
        for node in idx.subscripts:
            if (isinstance(node.ctx, (ast.Store, ast.Del))
                    and isinstance(node.value, ast.Name)
                    and node.value.id in mutable):
                mutated.add(node.value.id)
        for node in idx.calls:
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in mutators
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in mutable):
                mutated.add(node.func.value.id)
        if not mutated:
            return
        for fn in self._compiled_defs(ctx):
            local: Set[str] = {a.arg for a in fn.args.args
                               + fn.args.posonlyargs + fn.args.kwonlyargs}
            for node in ast.walk(fn):
                if (isinstance(node, ast.Name)
                        and isinstance(node.ctx, ast.Store)):
                    local.add(node.id)
            for node in ast.walk(fn):
                if (isinstance(node, ast.Name)
                        and isinstance(node.ctx, ast.Load)
                        and node.id in mutated and node.id not in local):
                    yield self.finding(
                        ctx, node,
                        f"compiled `{fn.name}` closes over mutable module "
                        f"global `{node.id}`: Dynamo guards on it and "
                        f"recompiles when it changes, or bakes the value "
                        f"of the first trace. Pass it as an argument "
                        f"instead")

    def _compiled_defs(self, ctx: FileContext) -> Iterator[ast.FunctionDef]:
        idx = ctx.index
        defs: Dict[str, ast.FunctionDef] = {}
        seen: Set[int] = set()
        for node in idx.funcdefs:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs[node.name] = node
        for node in idx.funcdefs:
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for dec in node.decorator_list:
                if (idx.resolve(dec) in _COMPILE_NAMES
                        or _is_compile_call(ctx, dec)):
                    if id(node) not in seen:
                        seen.add(id(node))
                        yield node
        # `g = torch.compile(f)` over a module-level def.
        for node in idx.calls:
            if (_is_compile_call(ctx, node) and node.args
                    and isinstance(node.args[0], ast.Name)
                    and node.args[0].id in defs):
                fn = defs[node.args[0].id]
                if id(fn) not in seen:
                    seen.add(id(fn))
                    yield fn


# Position of the ``group`` argument when it is passed positionally.
_GROUP_POS = {
    "all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
    "all_gather_object": 2, "all_to_all": 2, "all_to_all_single": 4,
    "reduce_scatter": 3, "reduce_scatter_tensor": 3, "broadcast": 2,
    "broadcast_object_list": 2, "barrier": 0, "send": 2, "recv": 2,
    "isend": 2, "irecv": 2,
}


class CollectiveContextRule(Rule):
    id = "SPK402"
    slug = "collective-context"
    summary = "torch.distributed collective with no group= (spans WORLD)"
    why = ("with mesh axes beyond dp a process sits in several sub-groups; "
           "a collective that names no group silently spans WORLD and "
           "deadlocks or mixes shards — pass the mesh axis's group, or "
           "take it as a parameter")

    def run(self, ctx: FileContext) -> Iterator[Finding]:
        idx = ctx.index
        for node in idx.calls:
            name = idx.resolve(node.func)
            if not name or not name.startswith("torch.distributed."):
                continue
            op = name[len("torch.distributed."):]
            if op not in _GROUP_POS:
                continue
            group = self._group_expr(node, op)
            if group is not None and not (
                    isinstance(group, ast.Constant) and group.value is None):
                continue  # a group is named (a parameter is the caller's)
            yield self.finding(
                ctx, node,
                f"`{op}` with no group (or group=None) runs over the "
                f"default WORLD group — with sub-groups (tp, sp, ep) it "
                f"deadlocks or mixes shards; pass the mesh axis's "
                f"`group=`, or take it as a parameter")

    @staticmethod
    def _group_expr(call: ast.Call, op: str) -> Optional[ast.AST]:
        for kw in call.keywords:
            if kw.arg == "group":
                return kw.value
        pos = _GROUP_POS[op]
        if len(call.args) > pos:
            return call.args[pos]
        return None
