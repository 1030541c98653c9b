"""`repro_torch.analysis` — static checks for the cost model's physics,
the counterpart of ``repro.analysis``.

Three passes over the `src/repro_torch` AST, run as a CI gate
(``python -m repro_torch.analysis [--json] [PATHS]``, exit 0 iff clean):

- **units** (:mod:`.units`, :mod:`.lint`): dimensional analysis — flops,
  bytes, seconds, and their rates must never be conflated.
- **contracts** (:mod:`.contracts`): ``@shape_contract`` broadcast-shape
  declarations on the vectorized kernels, statically validated here and
  runtime-enforced when ``REPRO_CHECK=1``.
- **state** (:mod:`.state_lint`): writes to module-level mutable state
  must hold a lock.

Suppress a finding with ``# unit: ignore[why]`` / ``# contract:
ignore[why]`` / ``# state: ignore[why]`` — the reason is mandatory.
"""
from .contracts import (ShapeContractError, checking_enabled,  # noqa: F401
                        set_checking, shape_contract)
from .report import Finding, SCHEMA  # noqa: F401
from .runner import check_paths, main  # noqa: F401
from .units import Unit, UnitError, parse_unit  # noqa: F401

__all__ = ["shape_contract", "ShapeContractError", "set_checking",
           "checking_enabled", "Finding", "SCHEMA", "check_paths", "main",
           "Unit", "UnitError", "parse_unit"]
