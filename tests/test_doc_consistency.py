"""Doc-vs-source consistency guard for README.md and PARITY.md.

A README once said "32 of 35" while the committed CSVs said 33 of 35. This
test recomputes every iteration-count claim in README.md / PARITY.md from
a chip-independent source in the repository — the parity-mode
``convergence.csv`` and the reference's published golden counts that
``experiments/ordering_study.py`` and the regression tests pin — so a
regeneration that moves a count fails CI instead of silently rotting the
prose. Device timings are not claimed in these documents at all.
"""

from __future__ import annotations

import re
from pathlib import Path

import pandas as pd
import pytest

from perphil_tpu.experiments.ordering_study import REF_ILU_3D, REF_NGS_2D_FULL

REPO = Path(__file__).resolve().parent.parent
NB = REPO / "notebooks"


def _convergence() -> pd.DataFrame:
    return pd.read_csv(NB / "results-conforming-2d" / "convergence.csv")


def _counts(df: pd.DataFrame, solver: str) -> str:
    rows = df[df.solver == solver].sort_values("N")
    return "/".join(str(int(i)) for i in rows.it)


def _flat(text: str) -> str:
    return re.sub(r"\s+", " ", text)


@pytest.mark.parametrize("doc", ["README.md", "PARITY.md"])
def test_convergence_counts_match_csv(doc):
    """The parity-mode plain-GMRES and GMRES+ILU columns and the
    4-iteration fieldsplit signature, as the committed CSV has them."""
    df = _convergence()
    text = _flat((REPO / doc).read_text())
    gm = _counts(df, "GMRES")
    ilu = _counts(df, "GMRES + ILU PC")
    assert f"plain GMRES {gm}" in text, f"{doc}: plain-GMRES counts stale, CSV says {gm}"
    assert f"ILU {ilu}" in text, f"{doc}: ILU counts stale, CSV says {ilu}"
    ss = df[df.solver.str.startswith("Scale-Splitting")].it
    assert (ss == 4).all() and "fieldsplit 4" in text
    assert f"all {len(df)} published rows" in text or f"{len(df)}/{len(df)}" in text


def test_readme_picard_counts_match_golden():
    counts = "/".join(str(REF_NGS_2D_FULL[n]) for n in sorted(REF_NGS_2D_FULL))
    assert counts in (REPO / "README.md").read_text()


def test_readme_3d_ilu_counts_match_golden():
    counts = "/".join(str(REF_ILU_3D[n]) for n in sorted(REF_ILU_3D))
    sizes = "/".join(str(n) for n in sorted(REF_ILU_3D))
    text = _flat((REPO / "README.md").read_text())
    assert f"{counts} at nx={sizes}" in text


def test_no_known_typos():
    for doc in ("README.md", "PARITY.md", "docs/design.md"):
        text = (REPO / doc).read_text()
        assert "rander48" not in text, f"{doc}: 'rander48' should be 'drand48'"
