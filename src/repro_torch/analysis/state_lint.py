"""Global-state / thread-safety lint.

The tracer and the metrics registry are thread-safe by hand; this pass
keeps that discipline mechanical.  Two rules, both scoped to *module-level*
mutable state (function locals and instance attributes are out of scope):

- ``state-unlocked-global``: a function declares ``global NAME`` and
  rebinds it outside a lock-held ``with`` block.  Process-wide singletons
  (``obs.trace._TRACER``) must only flip under their lock.
- ``state-unlocked-mutation``: a function mutates a module-level name that
  was bound to a dict/list/set literal (or comprehension) — subscript
  assignment/deletion or a mutator method call — outside a lock.

What does *not* flag: module top-level statements (import-time init is
single-threaded), ``__init__`` methods (objects under construction are
unshared), anything inside ``with <something whose dotted name contains
"lock">``, and module globals bound to *calls* (``REGISTRY =
MetricsRegistry()``, ``threading.local()`` — those objects own their
synchronization).  Suppress intentional cases with ``# state: ignore[why]``
(e.g. single-threaded CLI caches).
"""
from __future__ import annotations

import ast
from typing import List, Set

from .report import Finding

__all__ = ["lint_state"]

_MUTATORS = {"append", "add", "update", "clear", "pop", "popitem",
             "setdefault", "extend", "remove", "discard", "insert",
             "appendleft", "sort"}

_MUTABLE_LITERALS = (ast.Dict, ast.List, ast.Set, ast.ListComp,
                     ast.DictComp, ast.SetComp)


def _module_mutable_names(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for stmt in tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        if isinstance(value, _MUTABLE_LITERALS):
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _is_lock_ctx(item: ast.withitem) -> bool:
    expr = item.context_expr
    if isinstance(expr, ast.Call):
        expr = expr.func
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
    return any("lock" in p.lower() for p in parts)


class _FnChecker(ast.NodeVisitor):
    def __init__(self, path: str, fn: ast.FunctionDef,
                 mutable_globals: Set[str], findings: List[Finding]):
        self.path = path
        self.fn = fn
        self.mutable_globals = mutable_globals
        self.findings = findings
        self.global_names: Set[str] = set()
        self.lock_depth = 0

    def _flag(self, node: ast.AST, rule: str, msg: str) -> None:
        self.findings.append(Finding(
            self.path, node.lineno, node.col_offset + 1, rule, "state", msg))

    # -- scope/lock bookkeeping ------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        if node is not self.fn:
            return  # nested defs are checked independently
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        return

    def visit_With(self, node: ast.With) -> None:
        locked = any(_is_lock_ctx(i) for i in node.items)
        if locked:
            self.lock_depth += 1
        self.generic_visit(node)
        if locked:
            self.lock_depth -= 1

    visit_AsyncWith = visit_With

    def visit_Global(self, node: ast.Global) -> None:
        self.global_names.update(node.names)

    # -- rule 1: unlocked rebinds of `global` names ----------------------------

    def _check_rebind(self, node: ast.AST, name: str) -> None:
        if name in self.global_names and self.lock_depth == 0:
            self._flag(node, "state-unlocked-global",
                       f"{self.fn.name}() rebinds module global '{name}' "
                       f"without holding a lock")

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            self._check_target(t, node)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_target(node.target, node)
        self.generic_visit(node)

    def _check_target(self, target: ast.expr, node: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self._check_rebind(node, target.id)
        elif isinstance(target, ast.Tuple):
            for e in target.elts:
                self._check_target(e, node)
        elif isinstance(target, ast.Subscript) and \
                isinstance(target.value, ast.Name):
            self._check_mutation(node, target.value.id, "item assignment")

    # -- rule 2: unlocked mutation of module mutable literals ------------------

    def _check_mutation(self, node: ast.AST, name: str, how: str) -> None:
        if name in self.mutable_globals and self.lock_depth == 0:
            self._flag(node, "state-unlocked-mutation",
                       f"{self.fn.name}() mutates module-level mutable "
                       f"'{name}' ({how}) without holding a lock")

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript) and \
                    isinstance(t.value, ast.Name):
                self._check_mutation(node, t.value.id, "item deletion")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS and \
                isinstance(f.value, ast.Name):
            self._check_mutation(node, f.value.id, f".{f.attr}()")
        self.generic_visit(node)


def lint_state(path: str, tree: ast.Module) -> List[Finding]:
    findings: List[Finding] = []
    mutable_globals = _module_mutable_names(tree)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name != "__init__":
            _FnChecker(path, node, mutable_globals, findings).visit(node)
    return findings
