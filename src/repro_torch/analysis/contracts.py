"""Broadcast shape contracts for the vectorized cost-model kernels.

The grid planner's speed comes from struct-of-arrays broadcasting: every
kernel takes flat candidate-axis arrays and must stay shape-consistent or
NumPy silently broadcasts a wrong answer.  A contract writes the intended
shapes down once, at the def site::

    @shape_contract("(c,), (c,a) -> (c,a)")
    def price(wire, per_algo): ...

    @shape_contract("batch:(*g), dp:(*g), tp:(*g) -> ()")
    def working_set(cfg, *, batch, dp, tp): ...

Grammar per spec: ``name:`` (optional — binds by parameter name instead of
position) then a parenthesized axis list.  Axis tokens are names (``c``,
``a`` — equal names must have equal sizes, size-1/scalar operands broadcast)
or a starred group ``*g`` (arbitrary rank; all ``*g`` operands must be
mutually NumPy-broadcastable and outputs must be broadcastable to the
group's result shape).  ``()`` is scalar-or-size-1.

Enforcement is runtime but off by default: the wrapper is always installed,
and when checking is disabled (``REPRO_CHECK`` unset/0, read once at import,
the same variable as the reference's) it costs one global load and a
branch.  Tier-1 tests set ``REPRO_CHECK=1`` (tests/conftest.py, before any
import) so every suite run exercises the full checks.  An operand may be a
NumPy array, a ``torch.Tensor`` (``torch.Size`` is a tuple) or a scalar.  The static half (:func:`lint_contracts`)
validates specs without importing: parseability, named params exist,
positional arity fits, output axes are bound by inputs.
"""
from __future__ import annotations

import ast
import dataclasses
import functools
import inspect
import os
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from .report import Finding

__all__ = ["shape_contract", "ShapeContractError", "set_checking",
           "checking_enabled", "parse_contract", "lint_contracts"]


class ShapeContractError(ValueError):
    """A runtime violation of a ``@shape_contract`` declaration."""


#: runtime enforcement flag; initialized once from the environment so the
#: disabled fast path is a single module-global truthiness test.
_CHECK = os.environ.get("REPRO_CHECK", "") not in ("", "0")


#: serialises ``set_checking``'s read-and-flip; readers take no lock
_CHECK_LOCK = threading.Lock()


def set_checking(enabled: bool) -> bool:
    """Toggle runtime contract enforcement; returns the previous value."""
    global _CHECK
    with _CHECK_LOCK:
        prev = _CHECK
        _CHECK = bool(enabled)
    return prev


def checking_enabled() -> bool:
    return _CHECK


# --- spec parsing -------------------------------------------------------------

_AXIS_RE = re.compile(r"^[A-Za-z_][A-Za-z_0-9]*$")


@dataclasses.dataclass(frozen=True)
class ArgSpec:
    """One operand's spec: named axes, or a broadcast group."""
    param: Optional[str]          # None = positional
    axes: Tuple[str, ...]         # named axes, outermost first
    group: Optional[str]          # broadcast-group name if starred

    @property
    def is_group(self) -> bool:
        return self.group is not None


@dataclasses.dataclass(frozen=True)
class Contract:
    spec: str
    inputs: Tuple[ArgSpec, ...]
    outputs: Tuple[ArgSpec, ...]


def _parse_one(tok: str, spec: str) -> ArgSpec:
    tok = tok.strip()
    param = None
    if ":" in tok:
        param, _, tok = tok.partition(":")
        param = param.strip()
        if not _AXIS_RE.match(param):
            raise ValueError(f"bad parameter name {param!r} in {spec!r}")
        tok = tok.strip()
    if not (tok.startswith("(") and tok.endswith(")")):
        raise ValueError(f"operand {tok!r} in {spec!r} must be parenthesized")
    inner = tok[1:-1].strip().rstrip(",").strip()
    if inner.startswith("*"):
        group = inner[1:].strip()
        if not _AXIS_RE.match(group):
            raise ValueError(f"bad group name {inner!r} in {spec!r}")
        return ArgSpec(param, (), group)
    axes: List[str] = []
    if inner:
        for ax in inner.split(","):
            ax = ax.strip()
            if not _AXIS_RE.match(ax):
                raise ValueError(f"bad axis name {ax!r} in {spec!r}")
            axes.append(ax)
    return ArgSpec(param, tuple(axes), None)


def _split_operands(side: str) -> List[str]:
    """Split on commas at paren depth 0 (axis commas live inside parens)."""
    out, depth, cur = [], 0, []
    for ch in side:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    tail = "".join(cur).strip()
    if tail:
        out.append(tail)
    return out


def parse_contract(spec: str) -> Contract:
    if "->" not in spec:
        raise ValueError(f"contract {spec!r} needs '->'")
    lhs, _, rhs = spec.partition("->")
    inputs = tuple(_parse_one(t, spec) for t in _split_operands(lhs))
    outputs = tuple(_parse_one(t, spec) for t in _split_operands(rhs))
    if not inputs:
        raise ValueError(f"contract {spec!r} has no inputs")
    for o in outputs:
        if o.param is not None:
            raise ValueError(f"output operands cannot be named: {spec!r}")
    in_axes = {ax for s in inputs for ax in s.axes}
    in_groups = {s.group for s in inputs if s.is_group}
    for o in outputs:
        for ax in o.axes:
            if ax not in in_axes:
                raise ValueError(
                    f"output axis {ax!r} in {spec!r} is not bound by any "
                    f"input operand")
        if o.is_group and o.group not in in_groups:
            raise ValueError(
                f"output group {o.group!r} in {spec!r} is not bound by any "
                f"input operand")
    return Contract(spec, inputs, outputs)


# --- runtime enforcement ------------------------------------------------------


def _shape_of(value) -> Optional[Tuple[int, ...]]:
    shape = getattr(value, "shape", None)
    if isinstance(shape, tuple):
        return shape
    if isinstance(value, (int, float, bool)):
        return ()
    if isinstance(value, (list, tuple)):
        import numpy as np
        try:
            return np.shape(value)
        except ValueError:  # ragged sequence: let the kernel complain
            return None
    return None  # not array-like: skipped (e.g. configs, dataclasses)


def _check_named(fname: str, where: str, spec: ArgSpec,
                 shape: Tuple[int, ...], sizes: Dict[str, int],
                 contract: str) -> None:
    rank = len(spec.axes)
    if len(shape) > rank:
        raise ShapeContractError(
            f"{fname}: {where} has shape {shape} but contract "
            f"{contract!r} allows rank <= {rank}")
    # right-align: missing leading axes broadcast like size 1
    aligned = (1,) * (rank - len(shape)) + shape
    for ax, size in zip(spec.axes, aligned):
        if size == 1:
            continue
        bound = sizes.get(ax)
        if bound is None or bound == 1:
            sizes[ax] = size
        elif bound != size:
            raise ShapeContractError(
                f"{fname}: {where} axis {ax!r} has size {size}, already "
                f"bound to {bound} (contract {contract!r})")


def _broadcast_shapes(shapes: Sequence[Tuple[int, ...]]) -> Tuple[int, ...]:
    import numpy as np
    try:
        return np.broadcast_shapes(*shapes)
    except ValueError as e:
        raise ShapeContractError(str(e)) from e


def shape_contract(spec: str):
    """Declare broadcast shapes for a vectorized kernel (see module doc).

    The spec parses at decoration time (import errors beat silent drift);
    the wrapped function checks it only when :func:`checking_enabled`.
    """
    contract = parse_contract(spec)

    def decorate(fn):
        sig = inspect.signature(fn)
        param_names = list(sig.parameters)
        positional = [s for s in contract.inputs if s.param is None]
        if len(positional) > len(param_names):
            raise ValueError(
                f"{fn.__name__}: contract {spec!r} has {len(positional)} "
                f"positional operands but the function takes "
                f"{len(param_names)} parameters")
        for s in contract.inputs:
            if s.param is not None and s.param not in sig.parameters:
                raise ValueError(
                    f"{fn.__name__}: contract names parameter {s.param!r} "
                    f"which the function does not take")
        # resolve every input spec to a parameter name once, eagerly
        resolved = []
        pos_iter = iter(param_names)
        for s in contract.inputs:
            pname = s.param if s.param is not None else next(pos_iter)
            resolved.append((pname, s))

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _CHECK:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            sizes: Dict[str, int] = {}
            groups: Dict[str, List[Tuple[int, ...]]] = {}
            for pname, s in resolved:
                if pname not in bound.arguments:
                    continue
                shape = _shape_of(bound.arguments[pname])
                if shape is None:
                    continue
                if s.is_group:
                    groups.setdefault(s.group, []).append(shape)
                else:
                    _check_named(fn.__name__, f"argument {pname!r}", s,
                                 shape, sizes, spec)
            group_shapes = {g: _broadcast_shapes(shapes)
                            for g, shapes in groups.items()}
            out = fn(*args, **kwargs)
            outs = out if isinstance(out, tuple) else (out,)
            if len(contract.outputs) == len(outs):
                for i, (ospec, val) in enumerate(
                        zip(contract.outputs, outs)):
                    shape = _shape_of(val)
                    if shape is None:
                        continue
                    where = f"output[{i}]"
                    if ospec.is_group:
                        want = group_shapes.get(ospec.group)
                        if want is not None and \
                                _broadcast_shapes([shape, want]) != want:
                            raise ShapeContractError(
                                f"{fn.__name__}: {where} shape {shape} is "
                                f"not broadcastable to group "
                                f"{ospec.group!r} shape {want} "
                                f"(contract {spec!r})")
                    else:
                        _check_named(fn.__name__, where, ospec, shape,
                                     sizes, spec)
            return out

        wrapper.__shape_contract__ = contract
        return wrapper

    return decorate


# --- static pass --------------------------------------------------------------


def _decorator_spec(dec: ast.expr) -> Optional[ast.Call]:
    if isinstance(dec, ast.Call):
        name = dec.func.attr if isinstance(dec.func, ast.Attribute) else \
            dec.func.id if isinstance(dec.func, ast.Name) else None
        if name == "shape_contract":
            return dec
    return None


def lint_contracts(path: str, tree: ast.Module) -> List[Finding]:
    """Validate every ``@shape_contract`` spec in a module without importing.

    Checks: the spec string parses (including output-axes-bound-by-inputs),
    named operands refer to real parameters, and positional operand count
    fits the signature.
    """
    findings: List[Finding] = []

    def flag(node: ast.AST, rule: str, msg: str) -> None:
        findings.append(Finding(path, node.lineno, node.col_offset + 1,
                                rule, "contract", msg))

    for node in ast.walk(tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for dec in node.decorator_list:
            call = _decorator_spec(dec)
            if call is None:
                continue
            if not (call.args and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)):
                flag(dec, "contract-bad-spec",
                     f"@shape_contract on {node.name}() needs a literal "
                     f"string spec")
                continue
            spec = call.args[0].value
            try:
                contract = parse_contract(spec)
            except ValueError as e:
                flag(dec, "contract-bad-spec", str(e))
                continue
            params = ([a.arg for a in node.args.posonlyargs]
                      + [a.arg for a in node.args.args]
                      + [a.arg for a in node.args.kwonlyargs])
            params = [p for p in params if p not in ("self", "cls")]
            positional = [s for s in contract.inputs if s.param is None]
            if len(positional) > len(params) and node.args.vararg is None:
                flag(dec, "contract-arity",
                     f"{node.name}(): {len(positional)} positional operands "
                     f"in {spec!r} but only {len(params)} parameters")
            seen = set()
            for s in contract.inputs:
                if s.param is None:
                    continue
                if s.param not in params:
                    flag(dec, "contract-unknown-param",
                         f"{node.name}(): contract names {s.param!r}, not a "
                         f"parameter")
                if s.param in seen:
                    flag(dec, "contract-duplicate-param",
                         f"{node.name}(): parameter {s.param!r} appears "
                         f"twice in {spec!r}")
                seen.add(s.param)
    return findings
