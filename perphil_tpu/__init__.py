"""perphil-tpu: a double porosity/permeability (DPP) FEM framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
``ThermoPhase-FCSRG/perphil`` (a Firedrake/PETSc code; see
``/root/reference/src/perphil/__init__.py:8-16`` for the feature-flag parity):
structured quad/tri/hex/tet meshes, two-field Q1/P1 pressure spaces, the
monolithic and Picard-splitted DPP variational forms lowered to constant
stencil operators, a PETSc-free Krylov/direct solver stack, manufactured
solutions, conditioning analysis, and a profiling harness.

Unlike the reference (which cannot import solvers without Firedrake), every
module here imports and runs on any JAX backend: CPU, GPU, or a
multi-device mesh, in native float64 throughout.
"""

from perphil_tpu import config as _config

_config.setup()

__version__ = "0.1.0"

__all__ = ["__version__"]
