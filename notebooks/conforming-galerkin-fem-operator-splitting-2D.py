# %% [markdown]
# # Conforming Galerkin FEM + operator splitting for 2D DPP (exploratory)
#
# JAX reproduction of the reference's exploratory study
# (`/root/reference/notebooks/conforming-galerkin-fem-operator-splitting-2D-perphil.py`):
# compares monolithic direct/GMRES/ILU solves, the scale-splitting
# (fieldsplit) preconditioner, three Picard variants (pointwise NGS, damped
# Richardson, and the explicit delayed-form fixed-point driver built from
# `dpp_delayed_form`), and the conditioning of the delayed macro/micro
# systems.

# %%
import os
from pathlib import Path

if os.environ.get("PERPHIL_CPU"):
    # CPU escape hatch: the study is small enough for CPU
    import jax

    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np
import pandas as pd

from perphil_tpu.forms import create_function_spaces, mixed_space
from perphil_tpu.forms.dpp import dpp_delayed_form
from perphil_tpu.forms.spaces import Function
from perphil_tpu.mesh import create_mesh
from perphil_tpu.models.dpp import DPPParameters
from perphil_tpu.ops.assembly import DirichletBC, DPPOperator, bc_values_per_field
from perphil_tpu.ops.direct import FastDiagFieldSolver
from perphil_tpu.solvers import parameters as sp
from perphil_tpu.solvers import solve_dpp, solve_dpp_nonlinear
from perphil_tpu.solvers.conditioning import calculate_condition_number, get_matrix_data_from_form
from perphil_tpu.utils.manufactured_solutions import exact_expressions
from perphil_tpu.utils.postprocessing import l2_error

OUT = Path(__file__).parent / "results-conforming-2d"
OUT.mkdir(parents=True, exist_ok=True)

N = 32 if not os.environ.get("PERPHIL_FAST") else 8
mesh = create_mesh(N, N)
_, V = create_function_spaces(mesh)
W = mixed_space(V)
params = DPPParameters()
_, p1e, _, p2e = exact_expressions(mesh, params)
bcs = [DirichletBC(W.sub(0), p1e), DirichletBC(W.sub(1), p2e)]

# %% [markdown]
# ## Monolithic and preconditioned linear solves

# %%
rows = []
for name, cfg in [
    ("monolithic-direct", sp.LINEAR_SOLVER_PARAMS),
    ("plain-gmres", sp.PLAIN_GMRES_PARAMS),
    ("gmres-ilu", sp.GMRES_ILU_PARAMS),
    ("gmres-jacobi", sp.GMRES_JACOBI_PARAMS),
    ("ss-gmres (fieldsplit-lu)", {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_LU_PARAMS}),
    ("ss-gmres-ilu", {**sp.GMRES_PARAMS, **sp.FIELDSPLIT_GMRES_ILU_PARAMS}),
]:
    sol = solve_dpp(W, params, bcs, solver_parameters=cfg)
    p1h, _ = sol.solution.split()
    rows.append({"solver": name, "it": sol.iteration_number,
                 "res": sol.residual_error, "e1_L2": l2_error(p1h, p1e)})
    print(rows[-1])

# %% [markdown]
# ## Field plots and midline slices (monolithic solution vs exact)
#
# The reference's field-visualization sections
# (`conforming-galerkin-fem-operator-splitting-2D-perphil.py:94-153`):
# p1/p2 tripcolor fields, Darcy-velocity quivers, and the x=0.5 slice
# compared with the exact solution.

# %%
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

from perphil_tpu.utils.plotting import plot_scalar_field, plot_vector_field
from perphil_tpu.utils.postprocessing import (
    calculate_darcy_velocity_from_pressure,
    slice_along_x,
    split_dpp_solution,
)

sol_mono = solve_dpp(W, params, bcs, solver_parameters=sp.LINEAR_SOLVER_PARAMS)
p1_mono, p2_mono = split_dpp_solution(sol_mono.solution)
u1_mono = calculate_darcy_velocity_from_pressure(p1_mono, params.k1)
u2_mono = calculate_darcy_velocity_from_pressure(p2_mono, params.k2)

for fld, title, fname in [
    (p1_mono, r"$p_1$ scalar field", "p1_field.png"),
    (p2_mono, r"$p_2$ scalar field", "p2_field.png"),
]:
    ax = plot_scalar_field(fld, title=title)
    ax.figure.savefig(OUT / fname, dpi=150)
    plt.close(ax.figure)
for fld, title, fname in [
    (u1_mono, r"$u_1$ vector field", "u1_field.png"),
    (u2_mono, r"$u_2$ vector field", "u2_field.png"),
]:
    ax = plot_vector_field(fld, title=title)
    ax.figure.savefig(OUT / fname, dpi=150)
    plt.close(ax.figure)

# %%
x_mid = 0.5
ys, p1_line = slice_along_x(p1_mono, x_value=x_mid)
_, p2_line = slice_along_x(p2_mono, x_value=x_mid)
# the exact expressions are plain callables — evaluate them on the slice
p1e_line = np.asarray(p1e(np.full_like(ys, x_mid), ys))
p2e_line = np.asarray(p2e(np.full_like(ys, x_mid), ys))

fig, axs = plt.subplots(1, 2, figsize=(11, 4.2))
for ax, (num, ex, lab) in zip(
    axs, [(p1_line, p1e_line, "p_1"), (p2_line, p2e_line, "p_2")]
):
    ax.plot(ys, ex, lw=4, c="k", label="Exact Solution")
    ax.plot(ys, num, "o--", ms=4, label="Monolithic FEM")
    ax.set_xlabel("y")
    ax.set_ylabel(rf"${lab}(x={x_mid}, y)$")
    ax.grid(alpha=0.3)
    ax.legend()
fig.tight_layout()
fig.savefig(OUT / "midline_slices.png", dpi=150)
plt.close(fig)
print("wrote field + slice figures ->", OUT)

# %% [markdown]
# ## Picard variants
#
# All the reference's fixed-point drivers: pointwise NGS (inner LU), the
# inner-GMRES and inner-GMRES+ILU variants
# (`...-perphil.py:359-416`), block Gauss-Seidel (fixed-stress), and
# damped nonlinear Richardson.

# %%
for name, cfg in [
    ("picard-ngs (pointwise GS)", sp.PICARD_LU_SOLVER_PARAMS),
    ("picard-gmres (inner GMRES)", sp.PICARD_GMRES_SOLVER_PARAMS),
    ("picard-gmres-ilu (inner GMRES+ILU)", sp.PICARD_GMRES_ILU_SOLVER_PARAMS),
    ("picard-block-gs (fixed-stress)", {**sp.PICARD_LU_SOLVER_PARAMS, "snes_type": "block_gs"}),
    ("picard-nrichardson (damped 0.5)", sp.RICHARDSON_SOLVER_PARAMS),
]:
    sol = solve_dpp_nonlinear(W, params, bcs, solver_parameters=cfg)
    p1h, _ = sol.solution.split()
    rows.append({"solver": name, "it": sol.iteration_number,
                 "res": sol.residual_error, "e1_L2": l2_error(p1h, p1e)})
    print(rows[-1])

# %% [markdown]
# ## Explicit delayed-form Picard driver (the `dpp_delayed_form` API)

# %%
g1, g2 = bc_values_per_field(W, bcs)
p1_old = Function(V)
p2_old = Function(V)
macro_solver = FastDiagFieldSolver(mesh, params.k1, params.beta, params.mu)
micro_solver = FastDiagFieldSolver(mesh, params.k2, params.beta, params.mu)
op = DPPOperator(W, params)
b1, b2 = op.lifted_rhs(g1, g2)
f0 = float(jnp.sqrt(jnp.vdot(b1, b1) + jnp.vdot(b2, b2)).real)

it = 0
while True:
    (a_mac, L_mac), (a_mic, L_mic) = dpp_delayed_form(V, V, params, p1_old, p2_old)
    rhs_mac = a_mac.operator().lifted_rhs(g1, f=L_mac.assemble())
    p1_new = macro_solver.solve(rhs_mac)
    p1_old = Function(V, p1_new)
    (a_mac, L_mac), (a_mic, L_mic) = dpp_delayed_form(V, V, params, p1_old, p2_old)
    rhs_mic = a_mic.operator().lifted_rhs(g2, f=L_mic.assemble())
    p2_new = micro_solver.solve(rhs_mic)
    p2_old = Function(V, p2_new)
    it += 1
    r1, r2 = op.residual(p1_new, p2_new, b1, b2)
    fn = float(jnp.sqrt(jnp.vdot(r1, r1) + jnp.vdot(r2, r2)).real)
    if fn <= 1e-8 * f0 or it >= 200:
        break

e1 = l2_error(Function(V, p1_new), p1e)
rows.append({"solver": "picard-delayed-form (explicit)", "it": it, "res": fn, "e1_L2": e1})
print(rows[-1])

pd.DataFrame(rows).to_csv(OUT / "operator_splitting_summary.csv", index=False)

# %% [markdown]
# ## Conditioning of the delayed macro/micro systems

# %%
(a_mac, _), (a_mic, _) = dpp_delayed_form(V, V, params, Function(V), Function(V))
for name, form in [("macro", a_mac), ("micro", a_mic)]:
    md = get_matrix_data_from_form(form, bcs)
    cond = calculate_condition_number(md.sparse_csr_data, num_singular_values=None)
    print(f"delayed {name}: ndofs={md.number_of_dofs} nnz={md.number_of_nonzero_entries} "
          f"symmetric={md.is_symmetric} cond={cond:.4f}")
