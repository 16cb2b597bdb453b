"""Runtime solver-option overrides by prefix.

The reference exposes every solver's configuration to the PETSc options
database through ``options_prefix`` ("dpp", "dpp_nonlinear",
``f"dpp_{solver.name}"`` — reference ``solver.py:35,84``,
``convergence_2d.py:96``), so users can override any option from the command
line (``-dpp_ksp_rtol 1e-10``). The equivalent here is a process-global
options database plus an environment hook:

  - programmatic: ``set_options("dpp", ksp_rtol=1e-10)``
  - environment:  ``PERPHIL_TPU_OPTIONS="dpp_ksp_rtol=1e-10 dpp_pc_type=ilu"``

``solve_dpp``/``solve_dpp_nonlinear`` merge matching overrides on top of the
``solver_parameters`` dict, highest priority last (env > programmatic >
dict), mirroring PETSc's CLI-beats-code semantics.
"""

from __future__ import annotations

import os
from typing import Dict

_DB: Dict[str, Dict[str, object]] = {}


def set_options(prefix: str, **opts) -> None:
    """Register option overrides for every solve using ``prefix``."""
    _DB.setdefault(prefix, {}).update(opts)


def clear_options(prefix: str | None = None) -> None:
    if prefix is None:
        _DB.clear()
    else:
        _DB.pop(prefix, None)


def _coerce(v: str):
    low = v.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            pass
    return v


def _env_options(prefix: str) -> Dict[str, object]:
    raw = os.environ.get("PERPHIL_TPU_OPTIONS", "")
    out: Dict[str, object] = {}
    for tok in raw.split():
        if "=" not in tok:
            continue
        key, val = tok.split("=", 1)
        if key.startswith(prefix + "_"):
            out[key[len(prefix) + 1 :]] = _coerce(val)
    return out


def options_for(prefix: str) -> Dict[str, object]:
    """Merged overrides for a prefix (programmatic then environment)."""
    merged = dict(_DB.get(prefix, {}))
    merged.update(_env_options(prefix))
    return merged


def apply_prefix_overrides(solver_parameters: Dict, prefix: str) -> Dict:
    """Overlay registered overrides onto a solver-parameters dict."""
    overrides = options_for(prefix)
    if not overrides:
        return solver_parameters
    merged = dict(solver_parameters or {})
    merged.update(overrides)
    return merged
