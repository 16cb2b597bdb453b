"""Every solver family against a plain reference (chip_smoke.py phase G).

Each family's solution — direct, plain GMRES, GMRES+ILU, SS-GMRES,
SS-GMRES+ILU, Picard NGS — is compared with scipy ``spsolve`` of the same
system assembled independently as a CSR on the host
(``materialize_monolithic_csr``), in max-norm relative to the largest
entry: < 1e-10 for the direct solve, < 1e-6 for the iterative families at
ksp_rtol = snes_rtol = 1e-8. Tiny meshes of all four element types here;
the card runs the same comparison at 2D N=64 and 3D 16^3.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("family", chip_smoke.FAMILIES)
@pytest.mark.parametrize("element,n", [("quad", 8), ("tri", 8), ("hex", 4), ("tet", 4)])
def test_family_matches_plain_reference(family, element, n):
    rec = chip_smoke.phase_reference(family, element, n)
    assert rec["max_rel_diff"] < rec["tol"]
