"""DPP variational forms, lowered to stencil operators.

Parity with ``/root/reference/src/perphil/forms/dpp.py``:

  - ``dpp_form``          (reference ``dpp.py:95-132``): the monolithic
    two-field bilinear form + zero linear form.
  - ``dpp_delayed_form``  (reference ``dpp.py:135-205``): the Picard /
    fixed-stress split into two scalar problems with lagged cross-pressure.
  - ``dpp_splitted_form`` (reference ``dpp.py:208-247``): the nonlinear
    residual form for SNES-style fixed-point drivers.

The reference returns UFL ``Form`` objects that Firedrake later compiles to C
kernels. Here a "form" is a small descriptor that already knows its stencil
lowering; solvers consume these descriptors directly (no symbolic layer).
The weak forms match the reference exactly:

    xi = -(beta/mu) (p1 - p2)                         (dpp.py:7-28)
    macro: (k1/mu) grad p1 . grad q1 dx - xi q1 dx    (dpp.py:31-60)
    micro: (k2/mu) grad p2 . grad q2 dx + xi q2 dx    (dpp.py:63-92)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Optional, Tuple

import jax.numpy as jnp

from perphil_tpu.forms.spaces import Function, FunctionSpace, MixedFunctionSpace
from perphil_tpu.models.dpp.parameters import DPPParameters

if TYPE_CHECKING:  # ops.assembly imports forms.spaces: import it lazily
    from perphil_tpu.ops.assembly import DPPOperator, FieldOperator


def _validate_mixed(W) -> None:
    if not hasattr(W, "num_sub_spaces") or W.num_sub_spaces() != 2:
        raise ValueError(f"Expected a 2-field MixedFunctionSpace, got {type(W)}")


@dataclass(frozen=True)
class DPPBilinearForm:
    """Monolithic two-field DPP bilinear form (descriptor)."""

    W: MixedFunctionSpace
    params: DPPParameters

    def operator(self) -> DPPOperator:
        """Lower to the BC-eliminated stencil operator."""
        from perphil_tpu.ops.assembly import DPPOperator

        return DPPOperator(self.W, self.params)


@dataclass(frozen=True)
class ZeroLinearForm:
    """The reference's zero forcing ``L = 0 * q * dx`` (dpp.py:58,90)."""

    W: object


@dataclass(frozen=True)
class FieldBilinearForm:
    """One scalar block ``(k/mu) grad p . grad q + (beta/mu) p q``."""

    V: FunctionSpace
    k: float
    beta: float
    mu: float

    def operator(self) -> FieldOperator:
        from perphil_tpu.ops.assembly import FieldOperator

        return FieldOperator(self.V, self.k, self.beta, self.mu)


@dataclass(frozen=True)
class FieldLinearForm:
    """Lagged coupling RHS ``(beta/mu) * (M p_other)`` of the delayed form
    (the ``fd.rhs`` part at reference dpp.py:197-203)."""

    V: FunctionSpace
    beta: float
    mu: float
    lagged: Function

    def assemble(self) -> jnp.ndarray:
        from perphil_tpu.ops.assembly import FieldOperator

        op = FieldOperator(self.V, 0.0, self.beta, self.mu)
        return op.mass_apply(self.lagged.data)


def dpp_form(
    W: MixedFunctionSpace, model_params: DPPParameters
) -> Tuple[DPPBilinearForm, ZeroLinearForm]:
    """Monolithic DPP bilinear + (zero) linear form; parity with reference
    ``dpp_form`` (dpp.py:95-132), including the 2-field validation."""
    _validate_mixed(W)
    return DPPBilinearForm(W, model_params), ZeroLinearForm(W)


def dpp_delayed_form(
    macro_function_space: FunctionSpace,
    micro_function_space: FunctionSpace,
    model_params: DPPParameters,
    macro_pressure_initial_values: Function,
    micro_pressure_initial_values: Function,
) -> Tuple[
    Tuple[FieldBilinearForm, FieldLinearForm], Tuple[FieldBilinearForm, FieldLinearForm]
]:
    """Picard-split forms with lagged cross pressures; parity with reference
    ``dpp_delayed_form`` (dpp.py:135-205). The trial-side mass term stays in
    the bilinear form, the lagged coupling moves to the RHS (what
    ``fd.lhs/fd.rhs`` do at dpp.py:197-203)."""
    p = model_params
    a_macro = FieldBilinearForm(macro_function_space, p.k1, p.beta, p.mu)
    L_macro = FieldLinearForm(
        macro_function_space, p.beta, p.mu, micro_pressure_initial_values
    )
    a_micro = FieldBilinearForm(micro_function_space, p.k2, p.beta, p.mu)
    L_micro = FieldLinearForm(
        micro_function_space, p.beta, p.mu, macro_pressure_initial_values
    )
    return (a_macro, L_macro), (a_micro, L_micro)


@dataclass(frozen=True)
class DPPResidualForm:
    """Nonlinear residual ``F(p1, p2)`` for Picard drivers."""

    W: MixedFunctionSpace
    params: DPPParameters

    def operator(self) -> DPPOperator:
        from perphil_tpu.ops.assembly import DPPOperator

        return DPPOperator(self.W, self.params)

    def __call__(
        self, z1: jnp.ndarray, z2: jnp.ndarray, b1: jnp.ndarray, b2: jnp.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """F = A z - b on the BC-eliminated system (zero at satisfied BCs)."""
        op = self.operator()
        y1, y2 = op.matvec(z1, z2)
        return y1 - b1, y2 - b2


def dpp_splitted_form(
    W: MixedFunctionSpace, model_params: DPPParameters
) -> Tuple[DPPResidualForm, Function]:
    """Residual form + solution Function; parity with reference
    ``dpp_splitted_form`` (dpp.py:208-247)."""
    _validate_mixed(W)
    fields = Function(W)
    return DPPResidualForm(W, model_params), fields
