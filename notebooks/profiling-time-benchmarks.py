# %% [markdown]
# # Solver time benchmarks (2D) — event breakdown, KSP composition, memory
#
# JAX reproduction of
# `/root/reference/notebooks/petsc-profiling-time-benchmarks.py`: profile the
# five solver approaches over meshes 4 -> 256 (repeats=5, events backend),
# write `results-conforming-2d/petsc_profiling/petsc_perf_breakdown.csv`
# (reference schema), and render the stacked time-breakdown / memory plots.
#
# Reference headline (CPU/PETSc, N=256, 132,098 DoF): MUMPS 0.551 s,
# SS-GMRES 0.672 s, GMRES+ILU 0.796 s, plain GMRES 146.9 s.

# %%
import os
from pathlib import Path

if os.environ.get("PERPHIL_PLOTS_ONLY"):
    # plots-only mode never executes solves; keep the backend off the
    # (possibly busy) shared GPU
    import jax

    jax.config.update("jax_platforms", "cpu")

import pandas as pd

from perphil_tpu.experiments.iterative_bench import Approach
from perphil_tpu.experiments.profiling import (
    run_perf_sweep,
    save_perf_csv,
    splice_perf_csv,
)

OUT = Path(__file__).parent / "results-conforming-2d" / "petsc_profiling"
OUT.mkdir(parents=True, exist_ok=True)

SIZES = [4, 8, 16, 32, 64, 128, 256]
if os.environ.get("PERPHIL_FAST"):
    SIZES = [4, 8, 16]

APPROACHES = [
    Approach.PLAIN_GMRES,
    Approach.GMRES_ILU,
    Approach.SS_GMRES,
    Approach.SS_GMRES_ILU,
    Approach.MONOLITHIC_MUMPS,
]

# %%
# PERPHIL_PLOTS_ONLY=1 re-renders every figure from the committed CSV
# without re-running the (hours-long) device sweep.
if os.environ.get("PERPHIL_PLOTS_ONLY"):
    df = pd.read_csv(OUT / "petsc_perf_breakdown.csv")
    rows = df.to_dict("records")
else:
    rows = []
    for n in SIZES:
        for ap in APPROACHES:
            rows.extend(run_perf_sweep([n], approaches=[ap], repeats=5, backend="events"))
            # incremental + partial-sweep-safe: measured rows replace their old
            # versions, every other committed row survives
            splice_perf_csv(rows, OUT / "petsc_perf_breakdown.csv")
    # figures always render from the full (spliced) artifact, not just the
    # sizes this run happened to sweep
    df = pd.read_csv(OUT / "petsc_perf_breakdown.csv")
print(df[["approach", "nx", "dofs", "iterations", "time_total"]].to_string(index=False))

# %% [markdown]
# ## Picard variant (separate CSV, like the reference's
# `petsc_perf_breakdown-with-picard.csv`)

# %%
if not os.environ.get("PERPHIL_PLOTS_ONLY"):
    PICARD_SIZES = [s for s in SIZES if s <= 128]
    rows_p = run_perf_sweep(PICARD_SIZES, approaches=[Approach.PICARD_MUMPS], repeats=1,
                            backend="events")
    splice_perf_csv(rows + rows_p, OUT / "petsc_perf_breakdown-with-picard.csv")

# %% [markdown]
# ## Stacked time breakdown & memory plots

# %%
import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt

events = ["KSPSolve", "PCApply", "MatMult", "PCSetUp"]
fig, axs = plt.subplots(1, 2, figsize=(12, 4.5))
for ap in APPROACHES:
    sel = df[df.approach == ap.value].sort_values("nx")
    axs[0].loglog(sel.dofs, sel.time_total, "o-", label=ap.value)
    axs[1].semilogx(sel.dofs, sel.mem_rss_peak_kb / 1024, "o-", label=ap.value)
axs[0].set_xlabel("DoFs")
axs[0].set_ylabel("time_total [s]")
axs[0].grid(True, which="both", alpha=0.3)
axs[0].legend(fontsize=7)
axs[1].set_xlabel("DoFs")
axs[1].set_ylabel("peak RSS [MB]")
axs[1].grid(True, which="both", alpha=0.3)
fig.tight_layout()
fig.savefig(OUT / "time_benchmarks.png", dpi=150)
print("wrote", OUT / "time_benchmarks.png")

# %% [markdown]
# ## Per-event stacked breakdown (the reference's stacked-bars view,
# `petsc-profiling-time-benchmarks.py`): where each solve spends its time

# %%
import numpy as np

stack_events = ["time_PCSetUp", "time_MatMult", "time_PCApply"]
colors = plt.cm.tab10(np.linspace(0, 1, len(stack_events) + 1))
fig, axs = plt.subplots(1, len(APPROACHES), figsize=(3.2 * len(APPROACHES), 4.0),
                        sharey=False)
for ax, ap in zip(axs, APPROACHES):
    sel = df[df.approach == ap.value].sort_values("nx")
    xs = np.arange(len(sel))
    bottom = np.zeros(len(sel))
    for ev, c in zip(stack_events, colors):
        vals = sel[ev].to_numpy()
        ax.bar(xs, vals, bottom=bottom, color=c, label=ev.removeprefix("time_"))
        bottom += vals
    other = np.maximum(sel.time_total.to_numpy() - bottom, 0.0)
    ax.bar(xs, other, bottom=bottom, color=colors[-1], label="other")
    ax.set_xticks(xs, [str(n) for n in sel.nx], fontsize=7)
    ax.set_title(ap.value, fontsize=8)
    ax.set_xlabel("nx")
    ax.set_yscale("log")
axs[0].set_ylabel("time [s] (stacked events)")
axs[0].legend(fontsize=7)
fig.tight_layout()
fig.savefig(OUT / "time_breakdown_stacked.png", dpi=150)
print("wrote", OUT / "time_breakdown_stacked.png")

# %% [markdown]
# ## KSP composition: MatMult vs PCApply share of the Krylov solve

# %%
fig, ax = plt.subplots(figsize=(6.5, 4.2))
for ap in APPROACHES:
    sel = df[df.approach == ap.value].sort_values("nx")
    denom = sel.time_KSPSolve.replace(0.0, np.nan)
    ax.semilogx(sel.dofs, sel.time_MatMult / denom, "o-", label=f"{ap.value} MatMult")
    ax.semilogx(sel.dofs, sel.time_PCApply / denom, "s--", alpha=0.6,
                label=f"{ap.value} PCApply")
ax.set_xlabel("DoFs")
ax.set_ylabel("share of KSPSolve")
ax.set_ylim(0, 1.6)
ax.grid(True, which="both", alpha=0.3)
ax.legend(fontsize=6, ncols=2)
fig.tight_layout()
fig.savefig(OUT / "ksp_composition.png", dpi=150)
print("wrote", OUT / "ksp_composition.png")

# %% [markdown]
# ## Device-memory footprint (measured via memory_stats)

# %%
fig, ax = plt.subplots(figsize=(6, 4.2))
for ap in APPROACHES:
    sel = df[df.approach == ap.value].sort_values("nx")
    if (sel.mem_device_peak_bytes > 0).any():
        ax.loglog(sel.dofs, sel.mem_device_peak_bytes / 2**20, "o-", label=ap.value)
ax.set_xlabel("DoFs")
ax.set_ylabel("peak device memory [MiB]")
ax.grid(True, which="both", alpha=0.3)
ax.legend(fontsize=7)
fig.tight_layout()
fig.savefig(OUT / "device_memory.png", dpi=150)
print("wrote", OUT / "device_memory.png")

# %% [markdown]
# ## Full reference figure set
#
# Every figure family of the reference notebook (per-metric bars,
# per-iteration scaling, fixed-nx wall-time partitions, KSP-internal
# composition, PC-vs-KSP comparisons, time-vs-memory) rendered from the same
# CSV via the shared library (`notebooks/_perf_figures.py`), with the
# reference's output filenames.

# %%
import sys

sys.path.insert(0, str(Path(__file__).parent))
import _perf_figures as pf

pf.all_figures(df, OUT, sfx="")
for name, table in pf.per_iteration_tables(df).items():
    print(f"--- per-iteration summary ({name}) ---")
    print(table.to_string(index=False))
