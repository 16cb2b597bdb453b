"""Shared figure library for the profiling notebooks (2D and 3D).

Reproduces every figure family of the reference notebooks
(`/root/reference/notebooks/petsc-profiling-time-benchmarks.py:77-755` and
`petsc-profiling-time-benchmarks-3d.py:43-403`) from the committed
`petsc_perf_breakdown*.csv` artifacts, with the same output filenames so the
two artifact trees diff cleanly. The event vocabulary is the shared logical
one (``experiments/profiling.py::DEFAULT_LOGICAL_EVENTS``); events this
library's profiler does not record (e.g. ``KSPGMRESOrthogonalization`` —
the orthogonalization is fused into the compiled solve and cannot be timed
separately) enter the partitions as zero, exactly how the reference's
``.get(col, 0.0)`` treats absent PETSc log events.

Figure families (suffix "" for 2D, "_3d" for 3D):
  - per-metric pivot bars:   petsc_{metric}{sfx}_bar.png, petsc_flops{sfx}_bar.png,
                             petsc_iterations{sfx}_bar.png
  - per-iteration scaling:   {metric}{sfx}_scaling.png
  - fixed-nx breakdowns:     time_breakdown{sfx}_nx{N}.png (+ _absolute),
                             time_breakdown_wall_absolute{sfx}_nx{N}.png,
                             time_breakdown_wall_percent{sfx}_nx{N}.png
  - KSP splits:              time_split_ksp_vs_outside{sfx}_nx{N}.png,
                             ksp_composition_percent{sfx}_nx{N}.png,
                             ksp_breakdown{sfx}_nx{N}.png,
                             ksp_internal_absolute{sfx}_nx{N}.png
  - PC vs KSP:               pc_vs_ksp_wall{sfx}_nx{N}.png,
                             pc_setup_apply_ksp_absolute{sfx}_nx{N}.png
  - memory:                  time_vs_memory{sfx}_lines.png
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import pandas as pd

# Fixed approach -> color assignment (identity follows the entity across
# every figure; approaches absent from a CSV simply don't draw).
APPROACH_ORDER = [
    "GMRES",
    "GMRES + ILU PC",
    "Scale-Splitting GMRES",
    "Scale-Splitting GMRES + ILU PC",
    "Scaling-Splitting Picard with MUMPS",
    "Monolithic LU with MUMPS",
    "GMRES + ILU PC (envelope, production)",
]
_CMAP = plt.get_cmap("tab10")
APPROACH_COLORS: Dict[str, tuple] = {a: _CMAP(i) for i, a in enumerate(APPROACH_ORDER)}
_MARKERS = {a: m for a, m in zip(APPROACH_ORDER, ["o", "s", "^", "D", "P", "X", "v"])}


def _approaches_in(df: pd.DataFrame) -> List[str]:
    present = set(df["approach"].astype(str))
    ordered = [a for a in APPROACH_ORDER if a in present]
    return ordered + sorted(present - set(ordered))


def _col(df: pd.DataFrame, name: str) -> pd.Series:
    """Numeric column with absent-event semantics (missing -> 0.0)."""
    if name in df:
        return pd.to_numeric(df[name], errors="coerce").fillna(0.0).clip(lower=0.0)
    return pd.Series(0.0, index=df.index, dtype=float)


def normalize_per_solve(df: pd.DataFrame) -> pd.DataFrame:
    """Convert repeat-window event columns to per-solve values.

    The profiler's CSV semantics (``experiments/profiling.py``):
    ``time_total`` is already per-solve (window / repeats); ``time_KSPSolve``
    is the whole repeats window; ``time_MatMult``/``time_PCApply`` are
    probe-extrapolated totals across all repeats (probe dispatch overhead
    included — they can exceed the in-solve wall, which the partition
    functions cap); ``time_PCSetUp`` is one-time setup (compile + factor)
    and stays un-normalized, mirroring PETSc's once-per-solver PCSetUp.
    ``repeats`` comes from the metadata column.
    """
    import ast

    df = df.copy()

    def _repeats(meta) -> float:
        try:
            return float(ast.literal_eval(str(meta)).get("repeats", 1) or 1)
        except (ValueError, SyntaxError, AttributeError):
            return 1.0

    reps = df["metadata"].map(_repeats) if "metadata" in df else 1.0
    for c in df.columns:
        if c.startswith("time_") and c not in (
            "time_total", "time_total_repeats", "time_PCSetUp",
        ):
            df[c] = pd.to_numeric(df[c], errors="coerce").fillna(0.0) / reps
    return df


def _save(fig, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print("wrote", out)


def _pivot_bar(df, value: str, out: Path, title: str, ylabel: str) -> None:
    pivot = df.pivot_table(index="nx", columns="approach", values=value).sort_index()
    pivot = pivot[[a for a in _approaches_in(df) if a in pivot.columns]]
    fig, ax = plt.subplots(figsize=(9, 5.5))
    pivot.plot(
        kind="bar", ax=ax, logy=True, rot=0,
        color=[APPROACH_COLORS.get(a, "gray") for a in pivot.columns],
    )
    ax.set_title(title)
    ax.set_xlabel("nx (=ny)")
    ax.set_ylabel(ylabel)
    ax.grid(axis="y", ls=":", alpha=0.6)
    ax.legend(fontsize=7, ncols=2)
    _save(fig, out)


def metric_bars(df: pd.DataFrame, out_dir: Path, sfx: str = "") -> None:
    """Per-metric log-bar charts (reference ``:77-103`` / 3D ``:43-94``)."""
    for metric in ("time_total", "time_PCApply", "time_PCSetUp"):
        _pivot_bar(df, metric, out_dir / f"petsc_{metric}{sfx}_bar.png",
                   metric, "time [s]")
    _pivot_bar(df, "flops_total", out_dir / f"petsc_flops{sfx}_bar.png",
               "flops_total", "FLOPs [-]")
    _pivot_bar(df, "iterations", out_dir / f"petsc_iterations{sfx}_bar.png",
               "iterations", "Iterations [-]")


def per_iteration_scaling(df: pd.DataFrame, out_dir: Path, sfx: str = "") -> None:
    """Per-iteration cost vs cell count for the Krylov approaches
    (reference ``:106-152``)."""
    g = df[df["approach"].astype(str).str.contains("GMRES")].copy()
    if g.empty:
        return
    its = _col(g, "iterations").replace(0, np.nan)
    g["solve_per_iteration"] = _col(g, "time_KSPSolve") / its
    g["time_per_iteration"] = _col(g, "time_total") / its
    for metric in ("solve_per_iteration", "time_per_iteration"):
        fig, ax = plt.subplots(figsize=(7.5, 5.5))
        for ap in _approaches_in(g):
            sel = g[g.approach == ap].sort_values("num_cells")
            ax.loglog(sel.num_cells, sel[metric], marker=_MARKERS.get(ap, "o"),
                      color=APPROACH_COLORS.get(ap, "gray"), label=ap)
        ax.set_title(f"{metric} vs num_cells")
        ax.set_xlabel("num_cells")
        ax.set_ylabel("time [s]")
        ax.grid(which="both", ls=":", alpha=0.6)
        ax.legend(fontsize=7)
        _save(fig, out_dir / f"{metric}{sfx}_scaling.png")


def _assembly_time(df: pd.DataFrame) -> pd.Series:
    return (_col(df, "time_SNESFunctionEval") + _col(df, "time_SNESJacobianEval")
            + _col(df, "time_MatAssemblyBegin") + _col(df, "time_MatAssemblyEnd"))


def _gmres_at(df: pd.DataFrame, nx: Optional[int]) -> tuple:
    g = df[df["approach"].astype(str).str.contains("GMRES")]
    if g.empty:
        return None, g
    nx = nx if nx is not None else int(pd.to_numeric(g["nx"]).max())
    return nx, g[pd.to_numeric(g["nx"]) == nx].copy()


def breakdown_bars(df: pd.DataFrame, out_dir: Path, sfx: str = "",
                   nx: Optional[int] = None) -> None:
    """Share + absolute KSPSolve/PCSetUp/Assembly/Other stacks at fixed nx
    (reference ``:155-232``)."""
    nx, dft = _gmres_at(df, nx)
    if dft is None or dft.empty:
        return
    # cap every component into the remaining wall (PCSetUp is one-time
    # setup incl. XLA compile — often >> per-solve wall; uncapped it would
    # dwarf the stack, see normalize_per_solve)
    tot = _col(dft, "time_total")
    rem = tot.copy()
    comp = {}
    for label, v in [("KSPSolve", _col(dft, "time_KSPSolve")),
                     ("PCSetUp", _col(dft, "time_PCSetUp")),
                     ("Assembly", _assembly_time(dft))]:
        w = pd.concat([v, rem], axis=1).min(axis=1)
        comp[label] = w
        rem = (rem - w).clip(lower=0.0)
    comp = pd.DataFrame(comp)
    comp["Other"] = rem
    comp.index = dft["approach"].astype(str).values
    for absolute in (False, True):
        data = comp if absolute else comp.div(_col(dft, "time_total").values, axis=0)
        fig, ax = plt.subplots(figsize=(8, 6.5))
        data.plot(kind="bar", stacked=True, rot=30, ax=ax)
        ax.set_title(f"Time breakdown ({'absolute, ' if absolute else ''}nx={nx})")
        ax.set_ylabel("Time [s]" if absolute else "share of time_total")
        ax.grid(axis="y", ls=":", alpha=0.6)
        ax.legend(fontsize=8, ncols=2)
        name = "time_breakdown_absolute" if absolute else "time_breakdown"
        _save(fig, out_dir / f"{name}{sfx}_nx{nx}.png")


_KSP_COMPONENTS = [("PC apply", "time_PCApply"),
                   ("GMRES orth", "time_KSPGMRESOrthogonalization"),
                   ("MatMult", "time_MatMult")]


def _capped_exclusive(dft: pd.DataFrame, budget: pd.Series,
                      components) -> "tuple[dict, pd.Series]":
    """Cap each (label, column) component into the remaining ``budget``
    in order; returns (parts dict, remainder). The one shared
    implementation behind both the wall partition and the KSP-internal
    composition (they must attribute identically)."""
    rem = budget.copy()
    parts = {}
    for label, col in components:
        v = pd.concat([_col(dft, col), rem], axis=1).min(axis=1)
        parts[label] = v
        rem = (rem - v).clip(lower=0.0)
    return parts, rem


def _partition_wall(dft: pd.DataFrame) -> pd.DataFrame:
    """Exclusive wall-time partition: KSP internals first (PC apply, GMRES
    orth if recorded, MatMult, remainder), rescaled into time_total if the
    inclusive sums overshoot, then PC setup / assembly / unattributed from
    what's left. Rows sum to time_total by construction."""
    tot = _col(dft, "time_total")
    ksp = _col(dft, "time_KSPSolve")
    parts, rem = _capped_exclusive(dft, ksp, _KSP_COMPONENTS)
    parts["KSP other"] = rem
    inside = sum(parts.values())
    scale = np.where((tot > 0) & (inside > tot), tot / inside.replace(0, np.nan), 1.0)
    parts = {k: v * scale for k, v in parts.items()}
    rem_out = (tot - sum(parts.values())).clip(lower=0.0)
    for label, v in [("PC setup", _col(dft, "time_PCSetUp")),
                     ("Assembly", _assembly_time(dft))]:
        w = pd.concat([v, rem_out], axis=1).min(axis=1)
        parts[label] = w
        rem_out = (rem_out - w).clip(lower=0.0)
    parts["Unattributed"] = rem_out
    out = pd.DataFrame(parts)
    out.index = dft["approach"].astype(str).values
    return out


def wall_partition_bars(df: pd.DataFrame, out_dir: Path, sfx: str = "",
                        nx: Optional[int] = None) -> None:
    """Wall-clock-constrained runtime composition, absolute and percent
    (reference ``:236-364``; stacks sum exactly to time_total)."""
    nx, dft = _gmres_at(df, nx)
    if dft is None or dft.empty:
        return
    parts = _partition_wall(dft)
    tot = _col(dft, "time_total").values
    err = np.abs(parts.sum(axis=1).values - tot)
    assert np.all(err <= 1e-9 + 1e-6 * np.maximum(tot, 1e-30)), "partition must sum to wall"
    fig, ax = plt.subplots(figsize=(8, 6))
    parts.plot(kind="bar", stacked=True, rot=30, logy=True, ax=ax)
    ax.set_title(f"Runtime composition (absolute, nx={nx})")
    ax.set_ylabel("Time [s]")
    ax.grid(axis="y", ls=":", alpha=0.6)
    ax.legend(fontsize=7, ncols=2)
    _save(fig, out_dir / f"time_breakdown_wall_absolute{sfx}_nx{nx}.png")

    pct = 100.0 * parts.div(np.where(tot == 0, np.nan, tot), axis=0)
    fig, ax = plt.subplots(figsize=(8, 6))
    pct.plot(kind="bar", stacked=True, rot=30, ax=ax)
    ax.set_title(f"Runtime composition (nx={nx})")
    ax.set_ylabel("Percent of total runtime [%]")
    ax.grid(axis="y", ls=":", alpha=0.6)
    ax.legend(fontsize=7, ncols=2)
    _save(fig, out_dir / f"time_breakdown_wall_percent{sfx}_nx{nx}.png")


def ksp_split_bars(df: pd.DataFrame, out_dir: Path, sfx: str = "",
                   nx: Optional[int] = None) -> None:
    """KSP-inclusive vs outside-KSP wall split + inside-KSP composition
    (reference ``:455-535,688-730``)."""
    nx, dft = _gmres_at(df, nx)
    if dft is None or dft.empty:
        return
    tot = _col(dft, "time_total")
    ksp = _col(dft, "time_KSPSolve")
    split = pd.DataFrame({
        "KSP (inclusive)": ksp,
        "Outside KSP": (tot - ksp).clip(lower=0.0),
    })
    split.index = dft["approach"].astype(str).values
    pct = 100.0 * split.div(tot.replace(0, np.nan).values, axis=0)
    fig, ax = plt.subplots(figsize=(8, 6))
    pct.plot(kind="bar", stacked=True, rot=30, ax=ax)
    ax.set_title(f"Wall time split (nx={nx})")
    ax.set_ylabel("Percent of wall time [%]")
    ax.grid(axis="y", ls=":", alpha=0.6)
    _save(fig, out_dir / f"time_split_ksp_vs_outside{sfx}_nx{nx}.png")

    # inside-KSP exclusive composition, percent of KSPSolve
    kparts, rem = _capped_exclusive(dft, ksp, _KSP_COMPONENTS)
    kparts["KSP other"] = rem
    kdf = pd.DataFrame(kparts)
    kdf.index = dft["approach"].astype(str).values
    kpct = 100.0 * kdf.div(ksp.replace(0, np.nan).values, axis=0)
    fig, ax = plt.subplots(figsize=(8, 6))
    kpct.plot(kind="bar", stacked=True, rot=30, ax=ax)
    ax.set_title(f"KSP time composition (nx={nx})")
    ax.set_ylabel("Percent of KSPSolve [%]")
    ax.grid(axis="y", ls=":", alpha=0.6)
    _save(fig, out_dir / f"ksp_composition_percent{sfx}_nx{nx}.png")

    fig, ax = plt.subplots(figsize=(8, 6))
    kdf.plot(kind="bar", stacked=True, rot=30, ax=ax)
    ax.set_title(f"Inside KSP (absolute times, nx={nx})")
    ax.set_ylabel("Time in KSPSolve [s]")
    ax.grid(axis="y", ls=":", alpha=0.6)
    _save(fig, out_dir / f"ksp_internal_absolute{sfx}_nx{nx}.png")

    # inclusive shares of KSPSolve (can exceed 1 across rows — not stacked caps)
    kshare = pd.DataFrame({
        "PCApply": _col(dft, "time_PCApply"),
        "MatMult": _col(dft, "time_MatMult"),
        "GMRES_orth": _col(dft, "time_KSPGMRESOrthogonalization"),
    })
    kshare["Other"] = (ksp - kshare.sum(axis=1)).clip(lower=0.0)
    kshare = kshare.div(ksp.replace(0, np.nan).values, axis=0)
    kshare.index = dft["approach"].astype(str).values
    fig, ax = plt.subplots(figsize=(8, 6))
    kshare.plot(kind="bar", stacked=True, rot=30, ax=ax)
    ax.set_title(f"KSP breakdown (nx={nx})")
    ax.set_ylabel("share of KSPSolve")
    ax.grid(axis="y", ls=":", alpha=0.6)
    ax.legend(fontsize=8, ncols=2)
    _save(fig, out_dir / f"ksp_breakdown{sfx}_nx{nx}.png")


def pc_vs_ksp_bars(df: pd.DataFrame, out_dir: Path, sfx: str = "",
                   nx: Optional[int] = None) -> None:
    """PC setup/apply vs KSP, percent-of-wall and absolute side-by-side
    (reference ``:538-685``)."""
    nx, dft = _gmres_at(df, nx)
    if dft is None or dft.empty:
        return
    cmp_ = pd.DataFrame({
        "KSP (inclusive)": _col(dft, "time_KSPSolve"),
        "PC setup": _col(dft, "time_PCSetUp"),
        "PC apply": _col(dft, "time_PCApply"),
    })
    cmp_.index = dft["approach"].astype(str).values
    tot = _col(dft, "time_total").replace(0, np.nan).values
    pct = 100.0 * cmp_.div(tot, axis=0)
    fig, ax = plt.subplots(figsize=(8, 6))
    pct.plot(kind="bar", stacked=False, rot=30, ax=ax)
    ax.set_title(f"PC setup/apply vs KSP (percent of wall time, nx={nx})")
    ax.set_ylabel("Percent of wall time [%]")
    ax.grid(axis="y", ls=":", alpha=0.6)
    _save(fig, out_dir / f"pc_vs_ksp_wall{sfx}_nx{nx}.png")

    fig, ax = plt.subplots(figsize=(8, 6))
    cmp_[["PC setup", "PC apply", "KSP (inclusive)"]].plot(
        kind="bar", stacked=False, rot=30, logy=True, ax=ax)
    ax.set_title(f"Absolute times (nx={nx})")
    ax.set_ylabel("Time [s]")
    ax.grid(axis="y", ls=":", alpha=0.6)
    _save(fig, out_dir / f"pc_setup_apply_ksp_absolute{sfx}_nx{nx}.png")


def time_vs_memory_lines(df: pd.DataFrame, out_dir: Path, sfx: str = "") -> None:
    """time_total vs peak RSS, one line per approach (reference ``:733-755``)."""
    fig, ax = plt.subplots(figsize=(8, 6))
    for ap in _approaches_in(df):
        sel = df[df.approach == ap].copy()
        sel["mem_mb"] = _col(sel, "mem_rss_peak_kb") / 1024.0
        sel = sel.sort_values("mem_mb")
        ax.plot(sel.mem_mb, sel.time_total, marker=_MARKERS.get(ap, "o"),
                markersize=7, markerfacecolor="none", linewidth=1.5,
                color=APPROACH_COLORS.get(ap, "gray"), label=ap, alpha=0.9)
    ax.set_yscale("log")
    ax.set_xlabel("RSS peak [MB]")
    ax.set_ylabel("time_total [s]")
    ax.grid(which="both", ls=":", alpha=0.6)
    ax.legend(fontsize=8, title="Approach")
    _save(fig, out_dir / f"time_vs_memory{sfx}_lines.png")


def per_iteration_tables(df: pd.DataFrame) -> Dict[str, pd.DataFrame]:
    """The reference's in-notebook per-iteration summary tables
    (``:106-131``): per-iteration solve cost and PC cost shares."""
    df = normalize_per_solve(df)
    out: Dict[str, pd.DataFrame] = {}
    pic = df[df["approach"].astype(str).str.contains("Picard")]
    if not pic.empty:
        its = _col(pic, "iterations").replace(0, np.nan)
        out["picard"] = pd.DataFrame({
            "approach": pic["approach"],
            "num_cells": pic["num_cells"],
            "solve_per_iteration": _col(pic, "time_SNESSolve") / its,
            "time_per_iteration": _col(pic, "time_total") / its,
        })
    g = df[df["approach"].astype(str).str.contains("GMRES")]
    if not g.empty:
        its = _col(g, "iterations").replace(0, np.nan)
        tot = _col(g, "time_total").replace(0, np.nan)
        out["gmres"] = pd.DataFrame({
            "approach": g["approach"],
            "num_cells": g["num_cells"],
            "solve_per_iteration": _col(g, "time_KSPSolve") / its,
            "time_per_iteration": _col(g, "time_total") / its,
            "pc_factorization_per_time": _col(g, "time_PCSetUp") / tot,
            "pc_application_per_time": _col(g, "time_PCApply") / tot,
        })
    return out


def all_figures(df: pd.DataFrame, out_dir: Path, sfx: str = "",
                nx: Optional[int] = None) -> None:
    """Render every figure family into ``out_dir`` (per-solve normalized)."""
    df = normalize_per_solve(df)
    metric_bars(df, out_dir, sfx)
    per_iteration_scaling(df, out_dir, sfx)
    breakdown_bars(df, out_dir, sfx, nx)
    wall_partition_bars(df, out_dir, sfx, nx)
    ksp_split_bars(df, out_dir, sfx, nx)
    pc_vs_ksp_bars(df, out_dir, sfx, nx)
    time_vs_memory_lines(df, out_dir, sfx)
