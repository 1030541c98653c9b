"""The units lint: dimensional analysis over the `repro_torch` AST.

Inference semantics (deliberately conservative — silence over noise):

- Every expression infers to a :class:`~repro_torch.analysis.units.Unit`, the
  sentinel :data:`ANY` (numeric literals — unit-polymorphic, a ``2`` can
  scale bytes or seconds alike), or ``None`` (unknown — poisons silently,
  never flags).
- Declarations seed concrete units: attribute access via
  ``registry.ATTR_UNITS``, call returns via ``RETURN_UNITS``, local and
  parameter names via exact-name/suffix conventions (``name_unit``), and
  an optional module-level ``__repro_units__ = {"name": "spec"}`` dict.
- ``+``/``-``/comparisons/``np.where`` branches/ternaries flag only when
  *both* sides are concrete and incommensurable.  ``*``/``/`` combine
  dimension vectors, so ``bytes ÷ bytes/s → seconds`` and
  ``flops ÷ flops/s → seconds`` fall out of the algebra; ANY on either
  side of ``*``/``/`` makes the result ANY (a literal may carry hidden
  scale, e.g. bytes-per-param constants).
- Assigning a concrete unit to a name whose suffix declares a different
  dimension (``t_bytes = seconds_expr``) is a finding; scale suffixes
  (``_gb``, ``_ms``) exclude the name from inference entirely.
- Call sites of functions in ``PARAM_UNITS`` have their arguments checked
  positionally and by keyword.

Each finding carries file:line:col; suppress with ``# unit: ignore[why]``.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Union

from . import registry
from .units import Unit
from .report import Finding

__all__ = ["ANY", "lint_units", "UnitLinter"]


class _Any:
    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<any-unit>"


#: numeric literals and zeros-like constructors: compatible with everything
ANY = _Any()

UnitLike = Union[Unit, _Any, None]

# calls that return their (first) argument's unit unchanged
_PASSTHROUGH_CALLS = {
    "asarray", "ascontiguousarray", "array", "abs", "float", "broadcast_to",
    "full_like", "squeeze", "ravel", "reshape", "copy", "ascontiguousarray",
    "nan_to_num", "atleast_1d",
}
# methods that preserve the receiver's unit
_PASSTHROUGH_METHODS = {
    "sum", "max", "min", "mean", "reshape", "ravel", "astype", "copy",
    "item", "take", "squeeze", "flatten", "clip", "cumsum",
}
# calls whose arguments must be mutually commensurable; result = common unit
_UNIFY_CALLS = {"maximum", "minimum", "fmax", "fmin", "hypot"}
# dimensionless-returning predicates/reductions
_DIMENSIONLESS_CALLS = {
    "len", "argmax", "argmin", "isfinite", "isnan", "isinf", "sign",
    "count_nonzero", "searchsorted", "nonzero",
}


def _callee_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class UnitLinter:
    """Per-file units lint; one instance per source file."""

    def __init__(self, path: str, tree: ast.Module):
        self.path = path
        self.findings: List[Finding] = []
        self.module_units: Dict[str, Unit] = {}
        self._load_module_decls(tree)

    # -- declarations ----------------------------------------------------------

    def _load_module_decls(self, tree: ast.Module) -> None:
        """Pick up ``__repro_units__ = {"name": "unit-spec"}`` if present."""
        for stmt in tree.body:
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and stmt.targets[0].id == "__repro_units__"
                    and isinstance(stmt.value, ast.Dict)):
                for k, v in zip(stmt.value.keys, stmt.value.values):
                    if (isinstance(k, ast.Constant) and isinstance(k.value, str)
                            and isinstance(v, ast.Constant)
                            and isinstance(v.value, str)):
                        try:
                            from .units import parse_unit
                            self.module_units[k.value] = parse_unit(v.value)
                        except Exception:
                            self._flag(v, "bad-declaration",
                                       f"unparseable unit {v.value!r} in "
                                       f"__repro_units__")

    def _declared(self, name: str) -> object:
        if name in self.module_units:
            return self.module_units[name]
        return registry.name_unit(name)

    # -- findings --------------------------------------------------------------

    def _flag(self, node: ast.AST, rule: str, message: str) -> None:
        self.findings.append(Finding(
            self.path, getattr(node, "lineno", 0),
            getattr(node, "col_offset", -1) + 1, rule, "unit", message))

    # -- inference -------------------------------------------------------------

    def infer(self, node: ast.expr, env: Dict[str, UnitLike]) -> UnitLike:
        if isinstance(node, ast.Constant):
            if isinstance(node.value, bool) or node.value is None:
                return ANY
            if isinstance(node.value, (int, float)):
                return ANY
            return None
        if isinstance(node, ast.Name):
            if node.id in env:
                return env[node.id]
            decl = self._declared(node.id)
            if isinstance(decl, Unit):
                return decl
            if decl is registry.EXCLUDED:
                return None
            # np.inf / math spellings via bare names
            if node.id in ("inf", "nan"):
                return ANY
            return None
        if isinstance(node, ast.Attribute):
            if node.attr in ("inf", "nan", "newaxis", "e", "pi"):
                return ANY
            u = registry.ATTR_UNITS.get(node.attr)
            if u is not None:
                return u
            decl = registry.suffix_unit(node.attr)
            if isinstance(decl, Unit):
                return decl
            return None
        if isinstance(node, ast.UnaryOp):
            return self.infer(node.operand, env)
        if isinstance(node, ast.BinOp):
            return self._infer_binop(node, env)
        if isinstance(node, ast.Compare):
            self._check_compare(node, env)
            return ANY  # booleans scale anything (masks)
        if isinstance(node, ast.IfExp):
            a = self.infer(node.body, env)
            b = self.infer(node.orelse, env)
            return self._unify(node, a, b, "ternary branches")
        if isinstance(node, ast.Call):
            return self._infer_call(node, env)
        if isinstance(node, ast.Subscript):
            return self.infer(node.value, env)
        if isinstance(node, ast.Starred):
            return self.infer(node.value, env)
        if isinstance(node, (ast.Tuple, ast.List)):
            return None  # element units live in tuple-unpack handling
        if isinstance(node, ast.BoolOp):
            return ANY
        return None

    def _infer_binop(self, node: ast.BinOp, env: Dict[str, UnitLike]
                     ) -> UnitLike:
        left = self.infer(node.left, env)
        right = self.infer(node.right, env)
        op = node.op
        if isinstance(op, (ast.Add, ast.Sub)):
            if isinstance(left, Unit) and isinstance(right, Unit):
                if not left.commensurable(right):
                    self._flag(node, "unit-mismatch",
                               f"cannot {'add' if isinstance(op, ast.Add) else 'subtract'} "
                               f"{left} and {right}")
                    return None
                return left
            if isinstance(left, Unit) and right is ANY:
                return left
            if isinstance(right, Unit) and left is ANY:
                return right
            if left is ANY and right is ANY:
                return ANY
            return None
        if isinstance(op, (ast.Mult, ast.Div, ast.FloorDiv)):
            if left is ANY or right is ANY:
                return ANY
            if isinstance(left, Unit) and isinstance(right, Unit):
                return left * right if isinstance(op, ast.Mult) else left / right
            return None
        if isinstance(op, ast.Mod):
            return left if isinstance(left, Unit) else None
        if isinstance(op, ast.Pow):
            if isinstance(left, Unit) and left.is_dimensionless:
                return left
            if left is ANY:
                return ANY
            return None
        if isinstance(op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return ANY  # boolean-mask algebra
        return None

    def _check_compare(self, node: ast.Compare,
                       env: Dict[str, UnitLike]) -> None:
        parts = [node.left] + list(node.comparators)
        units = [self.infer(p, env) for p in parts]
        concrete = [(p, u) for p, u in zip(parts, units) if isinstance(u, Unit)]
        for i in range(1, len(concrete)):
            a, b = concrete[i - 1][1], concrete[i][1]
            if not a.commensurable(b):
                self._flag(node, "unit-mismatch",
                           f"comparison between {a} and {b}")
                return

    def _unify(self, node: ast.AST, a: UnitLike, b: UnitLike,
               what: str) -> UnitLike:
        if isinstance(a, Unit) and isinstance(b, Unit):
            if not a.commensurable(b):
                self._flag(node, "unit-mismatch",
                           f"{what} have incommensurable units {a} and {b}")
                return None
            return a
        if isinstance(a, Unit) and b is ANY:
            return a
        if isinstance(b, Unit) and a is ANY:
            return b
        if a is ANY and b is ANY:
            return ANY
        return None

    def _infer_call(self, node: ast.Call, env: Dict[str, UnitLike]
                    ) -> UnitLike:
        name = _callee_name(node.func)
        # argument checks against per-function declarations
        if name in registry.PARAM_UNITS:
            self._check_call_args(node, name, env)
        if name is None:
            return None
        if name in ("where",):  # np.where(cond, a, b): unify branches
            if len(node.args) == 3:
                a = self.infer(node.args[1], env)
                b = self.infer(node.args[2], env)
                return self._unify(node, a, b, "np.where branches")
            return None
        if name in _UNIFY_CALLS:
            out: UnitLike = ANY
            for arg in node.args:
                out = self._unify(node, out, self.infer(arg, env),
                                  f"{name}() arguments")
            return out
        if name in ("zeros", "ones", "empty", "full", "arange", "linspace",
                    "zeros_like", "ones_like", "empty_like"):
            if name == "full" and len(node.args) >= 2:
                return self.infer(node.args[1], env)
            return ANY
        if name in _DIMENSIONLESS_CALLS:
            from .units import DIMENSIONLESS
            return DIMENSIONLESS
        if name in _PASSTHROUGH_CALLS:
            if node.args:
                return self.infer(node.args[0], env)
            return None
        ret = registry.RETURN_UNITS.get(name)
        if isinstance(ret, Unit):
            return ret
        if isinstance(ret, tuple):
            return None  # tuple returns handled at unpack sites
        if (name in _PASSTHROUGH_METHODS
                and isinstance(node.func, ast.Attribute)):
            return self.infer(node.func.value, env)
        return None

    def _check_call_args(self, node: ast.Call, name: str,
                         env: Dict[str, UnitLike]) -> None:
        decls = registry.PARAM_UNITS[name]
        by_name = dict(decls)
        for i, arg in enumerate(node.args):
            if i >= len(decls) or isinstance(arg, ast.Starred):
                break
            pname, want = decls[i]
            self._check_arg(node, name, pname, want, arg, env)
        for kw in node.keywords:
            if kw.arg is not None and kw.arg in by_name:
                self._check_arg(node, name, kw.arg, by_name[kw.arg],
                                kw.value, env)

    def _check_arg(self, node: ast.Call, fname: str, pname: str,
                   want: Optional[Unit], arg: ast.expr,
                   env: Dict[str, UnitLike]) -> None:
        if want is None:
            return
        got = self.infer(arg, env)
        if isinstance(got, Unit) and not got.commensurable(want):
            self._flag(arg, "unit-bad-arg",
                       f"{fname}({pname}=...) expects {want}, got {got}")

    # -- statement walk --------------------------------------------------------

    def check_function(self, fn: ast.FunctionDef) -> None:
        env: Dict[str, UnitLike] = {}
        args = fn.args
        for a in (list(args.posonlyargs) + list(args.args)
                  + list(args.kwonlyargs)):
            decl = self._declared(a.arg)
            if isinstance(decl, Unit):
                env[a.arg] = decl
        # the function's own declared parameter units, if registered
        for pname, unit in registry.PARAM_UNITS.get(fn.name, ()):
            if unit is not None:
                env.setdefault(pname, unit)
        self._walk_body(fn, fn.body, env)

    def _walk_body(self, fn: ast.FunctionDef, body: Sequence[ast.stmt],
                   env: Dict[str, UnitLike]) -> None:
        for stmt in body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue  # visited independently by lint_units
            if isinstance(stmt, ast.Assign):
                self._handle_assign(stmt, env)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                if isinstance(stmt.target, ast.Name):
                    self._bind(stmt.target, stmt.target.id,
                               self.infer(stmt.value, env), env)
                else:
                    self.infer(stmt.value, env)
            elif isinstance(stmt, ast.AugAssign):
                self._handle_augassign(stmt, env)
            elif isinstance(stmt, ast.Return) and stmt.value is not None:
                self._handle_return(fn, stmt, env)
            elif isinstance(stmt, ast.Expr):
                self.infer(stmt.value, env)
            elif isinstance(stmt, ast.If):
                self.infer(stmt.test, env)
                self._walk_body(fn, stmt.body, env)
                self._walk_body(fn, stmt.orelse, env)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self.infer(stmt.iter, env)
                if isinstance(stmt.target, ast.Name):
                    env[stmt.target.id] = None
                self._walk_body(fn, stmt.body, env)
                self._walk_body(fn, stmt.orelse, env)
            elif isinstance(stmt, ast.While):
                self.infer(stmt.test, env)
                self._walk_body(fn, stmt.body, env)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._walk_body(fn, stmt.body, env)
            elif isinstance(stmt, ast.Try):
                self._walk_body(fn, stmt.body, env)
                for h in stmt.handlers:
                    self._walk_body(fn, h.body, env)
                self._walk_body(fn, stmt.orelse, env)
                self._walk_body(fn, stmt.finalbody, env)
            elif isinstance(stmt, (ast.Assert,)):
                self.infer(stmt.test, env)
            elif isinstance(stmt, ast.Raise):
                pass
            # everything else (pass, imports, global, ...) is unit-inert

    def _handle_assign(self, stmt: ast.Assign,
                       env: Dict[str, UnitLike]) -> None:
        value_unit = self.infer(stmt.value, env)
        for target in stmt.targets:
            if isinstance(target, ast.Name):
                self._bind(stmt, target.id, value_unit, env)
            elif isinstance(target, ast.Tuple):
                self._bind_tuple(stmt, target, env)
            # attribute/subscript targets: no tracked binding

    def _bind_tuple(self, stmt: ast.Assign, target: ast.Tuple,
                    env: Dict[str, UnitLike]) -> None:
        elem_units: Optional[tuple] = None
        if isinstance(stmt.value, ast.Call):
            name = _callee_name(stmt.value.func)
            ret = registry.RETURN_UNITS.get(name or "")
            if isinstance(ret, tuple) and len(ret) == len(target.elts):
                elem_units = ret
        elif isinstance(stmt.value, (ast.Tuple, ast.List)) \
                and len(stmt.value.elts) == len(target.elts):
            elem_units = tuple(self.infer(e, env) for e in stmt.value.elts)
        for i, elt in enumerate(target.elts):
            if isinstance(elt, ast.Name):
                u = elem_units[i] if elem_units is not None else None
                self._bind(stmt, elt.id, u, env)

    def _bind(self, node: ast.AST, name: str, value_unit: UnitLike,
              env: Dict[str, UnitLike]) -> None:
        decl = self._declared(name)
        if decl is registry.EXCLUDED:
            env[name] = None
            return
        if isinstance(decl, Unit):
            if isinstance(value_unit, Unit) \
                    and not value_unit.commensurable(decl):
                self._flag(node, "unit-bad-assign",
                           f"'{name}' is declared {decl} by naming "
                           f"convention but is assigned {value_unit}")
            env[name] = decl
            return
        env[name] = value_unit

    def _handle_augassign(self, stmt: ast.AugAssign,
                          env: Dict[str, UnitLike]) -> None:
        if not isinstance(stmt.target, ast.Name):
            self.infer(stmt.value, env)
            return
        cur = self.infer(stmt.target, env)
        val = self.infer(stmt.value, env)
        if isinstance(stmt.op, (ast.Add, ast.Sub)):
            if isinstance(cur, Unit) and isinstance(val, Unit) \
                    and not cur.commensurable(val):
                self._flag(stmt, "unit-mismatch",
                           f"augmented {'+=' if isinstance(stmt.op, ast.Add) else '-='} "
                           f"mixes {cur} and {val}")
        elif isinstance(stmt.op, (ast.Mult, ast.Div)):
            if isinstance(cur, Unit) and isinstance(val, Unit):
                new = cur * val if isinstance(stmt.op, ast.Mult) else cur / val
                self._bind(stmt, stmt.target.id, new, env)

    def _handle_return(self, fn: ast.FunctionDef, stmt: ast.Return,
                       env: Dict[str, UnitLike]) -> None:
        want = registry.RETURN_UNITS.get(fn.name)
        got = self.infer(stmt.value, env)
        if isinstance(want, Unit) and isinstance(got, Unit) \
                and not got.commensurable(want):
            self._flag(stmt, "unit-bad-return",
                       f"{fn.name}() is declared to return {want} "
                       f"but returns {got}")


def lint_units(path: str, tree: ast.Module) -> List[Finding]:
    """Run the units pass over every function in a parsed module."""
    linter = UnitLinter(path, tree)
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            linter.check_function(node)
    return linter.findings
