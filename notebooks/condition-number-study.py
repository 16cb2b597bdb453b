# %% [markdown]
# # Condition-number study (2D) — monolithic and block-wise
#
# JAX reproduction of the reference study
# (`/root/reference/notebooks/condition-number-study.py`): assemble the
# BC-eliminated monolithic DPP matrix for N = 4..64, compute condition
# numbers of the full matrix and its macro/micro diagonal blocks, fit
# kappa-vs-h slopes, and write
# `results-conforming-2d/conditioning/conditioning.csv` + `_slopes.csv`.
#
# Expected (reference): kappa(A) = 81.918 / 223.318 / 893.019 / 3572.76 /
# 14291.96 for N = 4..64; slopes ~ -2 vs h.

# %%
import os
from pathlib import Path

import numpy as np
import pandas as pd

from perphil_tpu.experiments.iterative_bench import (
    build_spaces,
    estimate_condition_numbers,
)
from perphil_tpu.mesh import create_mesh

OUT = Path(__file__).parent / "results-conforming-2d" / "conditioning"
OUT.mkdir(parents=True, exist_ok=True)

NS = [4, 8, 16, 32, 64]
if os.environ.get("PERPHIL_FAST"):
    NS = [4, 8, 16]

# %%
rows = []
for N in NS:
    mesh = create_mesh(N, N)
    _, _, W = build_spaces(mesh)
    # Full dense SVD at every published size — the reference notebook runs
    # with num_of_factors=0, i.e. LAPACK dense SVD even at N=64 (reference
    # condition-number-study.py:42 + conditioning.py:141-155), so Lanczos
    # here would introduce O(1e-6) estimator noise against an exact number
    # (it did in round 2: monolithic/macro off by 4.2e-6 at N=64).
    # Lanczos remains the path for beyond-published sizes (N > 64).
    use_sparse = N > 64
    conds = estimate_condition_numbers(
        W, num_of_factors=50 if use_sparse else None, use_sparse=use_sparse
    )
    rows.append(
        {
            "N": N,
            "h": 1.0 / N,
            "cond_monolithic": conds["monolithic"],
            "cond_macro": conds["macro"],
            "cond_micro": conds["micro"],
        }
    )
    print(rows[-1])

df = pd.DataFrame(rows)
df.to_csv(OUT / "conditioning.csv", index=False)
print("wrote", OUT / "conditioning.csv")

# %%
slopes = {}
for key in ("monolithic", "macro", "micro"):
    # log(kappa) vs log(h): kappa ~ h^-2 gives slope ~ -2
    slopes[key] = float(np.polyfit(np.log(df.h), np.log(df[f"cond_{key}"]), 1)[0])
pd.DataFrame([slopes]).to_csv(OUT / "conditioning_slopes.csv", index=False)
print("slopes:", slopes)

# %%
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

fig, ax = plt.subplots(figsize=(5.5, 4.5))
for key in ("monolithic", "macro", "micro"):
    ax.loglog(df.h, df[f"cond_{key}"], "o-", label=f"{key} (slope {slopes[key]:.2f})")
ax.set_xlabel("h")
ax.set_ylabel(r"$\kappa(A)$")
ax.grid(True, which="both", alpha=0.3)
ax.legend()
fig.tight_layout()
fig.savefig(OUT / "conditioning.png", dpi=150)
print("wrote", OUT / "conditioning.png")
