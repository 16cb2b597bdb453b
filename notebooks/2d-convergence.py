# %% [markdown]
# # 2D h-convergence study — conforming DPP (two pressures)
#
# JAX reproduction of the reference study
# (`/root/reference/notebooks/2d-convergence.py`): sweep N = 4..128 over the
# five solver approaches, compute L2/H1-seminorm errors against the
# manufactured solution, fit observed convergence orders (EOC), and write
# `results-conforming-2d/convergence.csv` + `convergence_eoc.csv` with the
# reference's schemas.
#
# Expected (reference `convergence_eoc.csv`): L2 EOC ~ 1.939 for p1 and p2,
# H1-seminorm EOC ~ 0.945, for every solver.

# %%
import os
from pathlib import Path

# This is a PARITY artifact generator: counts/errors must reproduce the
# reference's CPU/PETSc CSVs digit-for-digit, so pin the exact-parity
# arithmetic (CPU, native float64, f64 ILU application) regardless of
# attached accelerators — the default device mode (f32 ILU
# application) legitimately differs by ±2 iterations at a few sizes.
os.environ.setdefault("PERPHIL_TPU_ILU_DTYPE", "float64")
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pandas as pd

from perphil_tpu.experiments.convergence_2d import SolverSpec, compute_eoc, run_one
from perphil_tpu.experiments.iterative_bench import Approach, params_for
from perphil_tpu.models.dpp import DPPParameters

OUT = Path(__file__).parent / "results-conforming-2d"
OUT.mkdir(parents=True, exist_ok=True)

NS = [4, 8, 16, 32, 64, 128]
if os.environ.get("PERPHIL_FAST"):
    NS = [4, 8, 16]

APPROACHES = [
    Approach.PLAIN_GMRES,
    Approach.GMRES_ILU,
    Approach.SS_GMRES,
    Approach.SS_GMRES_ILU,
    Approach.MONOLITHIC_MUMPS,
]

# %%
params = DPPParameters()
rows = []
for N in NS:
    for ap in APPROACHES:
        spec = SolverSpec(ap.value, params_for(ap))
        row = run_one(N=N, solver=spec, quad=True, degree=1, params=params)
        rows.append(row)
        print(f"N={N:>4} {ap.value:<35} it={row['it']:>6} e1_L2={row['e1_L2']:.6g}")

df = pd.DataFrame(rows)
df.to_csv(OUT / "convergence.csv", index=False)
print("wrote", OUT / "convergence.csv")

# %%
eoc = pd.DataFrame(compute_eoc(rows))
eoc.to_csv(OUT / "convergence_eoc.csv", index=False)
print(eoc.to_string(index=False))

# %% [markdown]
# ## Error-vs-h plot with slope triangles

# %%
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

def slope_triangle(ax, x0, y0, slope, width=2.0, label=None):
    """Annotate a log-log axis with a slope reference triangle (the
    reference notebook's EOC visual, `2d-convergence.py:225-274`)."""
    x1 = x0 * width
    y1 = y0 * (x1 / x0) ** slope
    ax.plot([x0, x1, x1, x0], [y0, y0, y1, y0], "k-", lw=0.8)
    ax.annotate(f"1", ((x0 * x1) ** 0.5, y0 * 0.82), ha="center", fontsize=7)
    ax.annotate(
        label or f"{slope:g}",
        (x1 * 1.06, (y0 * y1) ** 0.5),
        va="center",
        fontsize=7,
    )


fig, axs = plt.subplots(1, 2, figsize=(11, 4.5))
for (err, slope), ax in zip((("e1_L2", 2.0), ("e1_H1s", 1.0)), axs):
    for ap in APPROACHES:
        sel = df[df.solver == ap.value].sort_values("h")
        ax.loglog(sel.h, sel[err], "o-", label=ap.value)
    sel = df[df.solver == APPROACHES[0].value].sort_values("h")
    h_mid = float(sel.h.iloc[len(sel) // 2])
    e_mid = float(sel[sel.h == h_mid][err].iloc[0])
    slope_triangle(ax, h_mid, e_mid * 0.4, slope)
    ax.set_xlabel("h")
    ax.set_ylabel(err)
    ax.set_title(f"expected order {slope:g}")
    ax.grid(True, which="both", alpha=0.3)
axs[0].legend(fontsize=7)
fig.tight_layout()
fig.savefig(OUT / "convergence.png", dpi=150)
print("wrote", OUT / "convergence.png")

# %% [markdown]
# ## Per-solver EOC table vs the reference values

# %%
# every approach must deliver the same discretization accuracy: spread of
# EOC across solvers is a solver-correctness check, not a discretization one
piv = eoc.pivot_table(index="solver", columns="err", values="slope")
print(piv.to_string())
spread = float((piv.max() - piv.min()).max())
print("max EOC spread across solvers:", spread)
assert spread < 0.02, "a solver is polluting the discretization error"

# %% [markdown]
# ## Solution structure: slice along x = 0.5 (reference `2d-convergence.py:238-274`)
#
# The manufactured p1 has an `exp(eta*y)` boundary-layer factor — visible as
# the sharp gradient near y=1 that drives the H1 error and the conditioning
# growth studied in the condition-number notebooks.

# %%
from perphil_tpu.forms.spaces import create_function_spaces, mixed_space
from perphil_tpu.mesh.structured import create_mesh
from perphil_tpu.ops.assembly import DirichletBC
from perphil_tpu.solvers import solve_dpp
from perphil_tpu.solvers.parameters import LINEAR_SOLVER_PARAMS
from perphil_tpu.utils.manufactured_solutions import exact_expressions
from perphil_tpu.utils.postprocessing import slice_along_x, split_dpp_solution

mesh_s = create_mesh(64, 64)
_, V_s = create_function_spaces(mesh_s)
W_s = mixed_space(V_s)
_, p1e_s, _, p2e_s = exact_expressions(mesh_s, params)
bcs_s = [DirichletBC(W_s.sub(0), p1e_s), DirichletBC(W_s.sub(1), p2e_s)]
sol_s = solve_dpp(W_s, params, bcs_s, solver_parameters=LINEAR_SOLVER_PARAMS)
p1h_s, p2h_s = split_dpp_solution(sol_s.solution)
ys, vals1 = slice_along_x(p1h_s, 0.5)
_, vals2 = slice_along_x(p2h_s, 0.5)

fig, axs = plt.subplots(1, 2, figsize=(10, 4))
axs[0].plot(ys, vals1, label="p1_h(0.5, y)")
axs[0].set_xlabel("y"); axs[0].set_ylabel("p1"); axs[0].grid(True, ls=":")
axs[0].legend(); axs[0].set_title("macro pressure slice (boundary layer at y=1)")
axs[1].plot(ys, vals2, "C1", label="p2_h(0.5, y)")
axs[1].set_xlabel("y"); axs[1].set_ylabel("p2"); axs[1].grid(True, ls=":")
axs[1].legend(); axs[1].set_title("micro pressure slice")
fig.tight_layout()
fig.savefig(OUT / "pressure_slices.png", dpi=150)
print("wrote", OUT / "pressure_slices.png")

# %% [markdown]
# ## Beyond the reference: degree-p convergence (Qp tensor-product spaces)
#
# The reference accepts arbitrary degree through Firedrake but publishes
# only degree-1 artifacts. This rebuild's Kronecker-structured Qp path
# (`ops/tensorfem`) delivers the expected higher orders; this writes
# `convergence_qp.csv` documenting them.

# %%
from perphil_tpu.forms.spaces import FunctionSpace
from perphil_tpu.utils.postprocessing import h1_seminorm_error, l2_error

qp_rows = []
QP_NS = [4, 8, 16] if not os.environ.get("PERPHIL_FAST") else [4, 8]
for degree in (2, 3):
    for N in QP_NS:
        mesh_p = create_mesh(N, N)
        Vp = FunctionSpace(mesh_p, degree=degree)
        Wp = mixed_space(Vp)
        _, p1e_p, _, p2e_p = exact_expressions(mesh_p, params)
        bcs_p = [DirichletBC(Wp.sub(0), p1e_p), DirichletBC(Wp.sub(1), p2e_p)]
        sol_p = solve_dpp(Wp, params, bcs_p, solver_parameters=LINEAR_SOLVER_PARAMS)
        p1h_p, _ = sol_p.solution.split()
        qp_rows.append(
            dict(N=N, h=1.0 / N, degree=degree,
                 e1_L2=l2_error(p1h_p, p1e_p),
                 e1_H1s=h1_seminorm_error(p1h_p, p1e_p))
        )
qp = pd.DataFrame(qp_rows)
for degree in (2, 3):
    sel = qp[qp.degree == degree]
    eoc_l2 = np.polyfit(np.log(sel.h), np.log(sel.e1_L2), 1)[0]
    eoc_h1 = np.polyfit(np.log(sel.h), np.log(sel.e1_H1s), 1)[0]
    print(f"Q{degree}: EOC L2={eoc_l2:.3f} (expect {degree+1}), "
          f"H1s={eoc_h1:.3f} (expect {degree})")
qp.to_csv(OUT / "convergence_qp.csv", index=False)
print("wrote", OUT / "convergence_qp.csv")
