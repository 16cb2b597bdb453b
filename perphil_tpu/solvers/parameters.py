"""Solver parameter presets.

Parity with ``/root/reference/src/perphil/solvers/parameters.py:1-102``: the
same 11 preset dictionaries with the same PETSc-style keys, consumed by
``perphil_tpu.solvers.solver`` which maps each option onto the JAX
solver stack:

  - ``ksp_type: gmres``      -> JAX restarted GMRES (``ops/krylov.py``)
  - ``ksp_type: preonly`` + ``pc_type: lu`` (``mumps``) -> exact tensor
    fast-diagonalization direct solve (``ops/direct.py``)
  - ``pc_type: fieldsplit`` (multiplicative) -> explicit 2x2 block
    Gauss-Seidel with per-block solvers
  - ``pc_type: ilu`` -> structured ILU(0) with wavefront triangular solves
  - ``pc_type: jacobi`` -> diagonal scaling
  - ``snes_type: ngs`` -> Picard block Gauss-Seidel sweeps
  - ``snes_type: nrichardson`` -> damped preconditioned Richardson

Keys that only make sense for PETSc internals (``mat_type``,
``pc_factor_mat_solver_type``, ``ksp_monitor``) are accepted and ignored, so
user code written against the reference keeps working unchanged.
"""

_MAX_ITERATION_NUMBER = 50000

# Monolithic exact solve (the reference reaches this via MUMPS LU; here the
# 'lu'/'mumps' keys select the tensor fast-diagonalization direct solver)
LINEAR_SOLVER_PARAMS: dict = {
    "mat_type": "aij",
    "ksp_type": "preonly",
    "pc_type": "lu",
    "pc_factor_mat_solver_type": "mumps",
}

# Base restarted-GMRES settings shared by every Krylov preset
GMRES_PARAMS: dict = {
    "mat_type": "aij",
    "ksp_type": "gmres",
    "ksp_rtol": 1.0e-8,
    "ksp_atol": 1.0e-12,
    "ksp_max_it": _MAX_ITERATION_NUMBER,
}

# Unpreconditioned GMRES (the 'no PC' baseline row of the benchmarks)
PLAIN_GMRES_PARAMS: dict = {"pc_type": "none", **GMRES_PARAMS}

# GMRES with diagonal (Jacobi) scaling
GMRES_JACOBI_PARAMS: dict = {"pc_type": "jacobi", **GMRES_PARAMS}

# GMRES with structured ILU(0)
GMRES_ILU_PARAMS: dict = {"pc_type": "ilu", "pc_factor_levels": 0, **GMRES_PARAMS}

# 2x2 block Gauss-Seidel PC, each diagonal block solved exactly
FIELDSPLIT_LU_PARAMS: dict = {
    "pc_type": "fieldsplit",
    "pc_fieldsplit_type": "multiplicative",
    "pc_fieldsplit_0_fields": "0",
    "pc_fieldsplit_1_fields": "1",
    "fieldsplit_0": LINEAR_SOLVER_PARAMS,
    "fieldsplit_1": LINEAR_SOLVER_PARAMS,
}

# 2x2 block Gauss-Seidel PC with inner (unpreconditioned) GMRES blocks
FIELDSPLIT_GMRES_PARAMS: dict = {
    "pc_type": "fieldsplit",
    "pc_fieldsplit_type": "multiplicative",
    "pc_fieldsplit_0_fields": "0",
    "pc_fieldsplit_1_fields": "1",
    "fieldsplit_0": PLAIN_GMRES_PARAMS,
    "fieldsplit_1": PLAIN_GMRES_PARAMS,
}

# 2x2 block Gauss-Seidel PC with inner GMRES+ILU(0) block solves
FIELDSPLIT_GMRES_ILU_PARAMS: dict = {
    "pc_type": "fieldsplit",
    "pc_fieldsplit_type": "multiplicative",
    "pc_fieldsplit_0_fields": "0",
    "pc_fieldsplit_1_fields": "1",
    "fieldsplit_0": GMRES_ILU_PARAMS,
    "fieldsplit_1": GMRES_ILU_PARAMS,
}

# Damped Richardson Picard iteration (see solver.py for the documented
# deviation from PETSc's unpreconditioned SNESNRICHARDSON)
RICHARDSON_SOLVER_PARAMS: dict = {
    "snes_type": "nrichardson",
    "snes_max_it": _MAX_ITERATION_NUMBER,
    "snes_linesearch_type": "basic",
    "snes_linesearch_damping": 0.5,
    "snes_rtol": 1e-5,
    "snes_atol": 1e-12,
    **FIELDSPLIT_LU_PARAMS,
}

# Picard via SNES 'ngs' (pointwise GS sweeps; the fieldsplit keys below are
# inert for PETSc's NGS and kept only for option-dict compatibility)
PICARD_LU_SOLVER_PARAMS = {
    "snes_type": "ngs",
    "snes_max_it": _MAX_ITERATION_NUMBER,
    "snes_rtol": 1e-8,
    "snes_atol": 1e-12,
    **FIELDSPLIT_LU_PARAMS,
}

# Picard 'ngs' variant carrying GMRES block options (inert, as above)
PICARD_GMRES_SOLVER_PARAMS = {
    "snes_type": "ngs",
    "snes_max_it": _MAX_ITERATION_NUMBER,
    "snes_rtol": 1e-8,
    "snes_atol": 1e-12,
    **FIELDSPLIT_GMRES_PARAMS,
}

# Picard 'ngs' variant carrying GMRES+ILU block options (inert, as above)
PICARD_GMRES_ILU_SOLVER_PARAMS = {
    "snes_type": "ngs",
    "snes_max_it": _MAX_ITERATION_NUMBER,
    "snes_rtol": 1e-8,
    "snes_atol": 1e-12,
    **FIELDSPLIT_GMRES_ILU_PARAMS,
}

# One linear solve driven through the SNES wrapper (SNESKSPONLY semantics:
# iteration_number reports 1)
KSP_PREONLY_PARAMS: dict = {
    "snes_type": "ksponly",
    "ksp_monitor": None,
    **FIELDSPLIT_LU_PARAMS,
}

# Extension: mixed-precision direct solver — f32 fast-diagonalization with
# double-float iterative refinement (float64-level accuracy from float32
# arithmetic; see ops/mixed.py). Same semantics as LINEAR_SOLVER_PARAMS
# (preonly direct solve). The name is kept for API compatibility.
TPU_DIRECT_PARAMS: dict = {
    "mat_type": "aij",
    "ksp_type": "preonly",
    "pc_type": "lu",
    "pc_factor_mat_solver_type": "fastdiag_mixed",
}
