# %% [markdown]
# # Condition-number study (3D, hexahedral) — monolithic and block-wise
#
# JAX reproduction of
# `/root/reference/notebooks/condition-number-study-3d.py`: hex unit-cube
# meshes N = 4..16, condition numbers of the monolithic matrix and blocks,
# slopes vs h, written to
# `results-conforming-3d/conditioning/conditioning_3d.csv` (+`_slopes.csv`)
# with the reference's schema (incl. n_dofs, n0, n1 columns).
#
# Expected (reference): kappa = 166.58 / 513.69 / 3306.00 at N = 4/8/16;
# slopes -2.13 / -2.84 / -2.11.

# %%
import os

# conditioning is an f64 eigen-analysis: run on CPU (exact arithmetic,
# leaves the GPU free for the profiling sweeps)
import jax

jax.config.update("jax_platforms", "cpu")

from pathlib import Path

import numpy as np
import pandas as pd

from perphil_tpu.experiments.iterative_bench import estimate_condition_numbers
from perphil_tpu.forms import create_function_spaces, mixed_space
from perphil_tpu.mesh import create_cube_mesh

OUT = Path(__file__).parent / "results-conforming-3d" / "conditioning"
OUT.mkdir(parents=True, exist_ok=True)

NS = [4, 6, 8, 10, 12, 14, 16]  # full reference grid (conditioning_3d.csv)
if os.environ.get("PERPHIL_FAST"):
    NS = [4, 8]

# %%
# PERPHIL_PLOTS_ONLY=1 re-renders the figure from the committed CSV.
if os.environ.get("PERPHIL_PLOTS_ONLY"):
    df = pd.read_csv(OUT / "conditioning_3d.csv")
else:
    rows = []
    for N in NS:
        mesh = create_cube_mesh(N, N, N, hexahedral=True)
        _, V = create_function_spaces(mesh)
        W = mixed_space(V)
        use_sparse = N >= 8  # dense SVD below (9826^2 dense SVD at N=16 is slow)
        conds = estimate_condition_numbers(
            W, num_of_factors=50 if use_sparse else None, use_sparse=use_sparse
        )
        n0 = W.sub(0).dim()
        rows.append(
            {
                "N": N,
                "h": 1.0 / N,
                "cond_monolithic": conds["monolithic"],
                "cond_macro": conds["macro"],
                "cond_micro": conds["micro"],
                "n_dofs": W.dim(),
                "n0": n0,
                "n1": n0,
            }
        )
        print(rows[-1])
    df = pd.DataFrame(rows)
    df.to_csv(OUT / "conditioning_3d.csv", index=False)
    print("wrote", OUT / "conditioning_3d.csv")

# %%
slopes = {
    key: float(np.polyfit(np.log(df.h), np.log(df[f"cond_{key}"]), 1)[0])
    for key in ("monolithic", "macro", "micro")
}
pd.DataFrame([slopes]).to_csv(OUT / "conditioning_3d_slopes.csv", index=False)
print("slopes:", slopes)

# %% [markdown]
# ## kappa-vs-h figure (log-log, fitted-slope annotations)
#
# The reference's `condition_numbers_3d_vs_h.png`
# (`condition-number-study-3d.py:140-215`): one line per operator with the
# fitted slope drawn as a right-angle annotation anchored at the two finest
# meshes.

# %%
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

fig, ax = plt.subplots(figsize=(7.5, 5.5))
dfp = df.sort_values("h")
for key in ("monolithic", "macro", "micro"):
    (line,) = ax.loglog(
        dfp.h, dfp[f"cond_{key}"], "o-", label=f"{key} (slope {slopes[key]:.2f})"
    )
    # right-angle slope annotation at the two smallest h
    h0, h1 = float(dfp.h.iloc[0]), float(dfp.h.iloc[1])
    k0 = float(dfp[f"cond_{key}"].iloc[0])
    k1 = k0 * (h1 / h0) ** slopes[key]
    c = line.get_color()
    ax.plot([h0, h1], [k0, k0], color=c, lw=1.2, alpha=0.7)
    ax.plot([h1, h1], [min(k0, k1), max(k0, k1)], color=c, lw=1.2, alpha=0.7)
    ax.plot([h0, h1], [k0, k1], color=c, lw=1.2, ls="--", alpha=0.7)
ax.set_xlabel("h")
ax.set_ylabel(r"$\kappa(A)$")
ax.set_title("3D DPP: condition number vs mesh size (log-log)")
ax.grid(True, which="both", alpha=0.3)
ax.legend(fontsize=8)
fig.tight_layout()
fig.savefig(OUT / "condition_numbers_3d_vs_h.png", dpi=150)
print("wrote", OUT / "condition_numbers_3d_vs_h.png")
