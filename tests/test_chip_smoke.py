"""chip_smoke.py rehearsed on the CPU at tiny sizes.

The script itself refuses the CPU (its measurements mean nothing there),
so these tests call its phase functions directly: every phase's set-up,
solve, checks and reference comparison run here exactly as on the card,
only smaller. Phase G's plain-reference comparison is in
``test_plain_reference.py``.
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("element,n", [("hex", 4), ("quad", 8)])
def test_phase_direct_residuals(element, n):
    rec = chip_smoke.phase_direct(element, n, host_check=True)
    assert rec["iterations"] == 1
    assert rec["rel_residual"] < chip_smoke.DIRECT_TOL
    assert rec["rel_residual_host"] < chip_smoke.DIRECT_TOL


def test_phase_df_direct_meets_residual_bound():
    rec = chip_smoke.phase_df_direct(4)
    assert rec["rel_residual"] < chip_smoke.DIRECT_TOL


def test_phase_ss_gmres_takes_four_iterations():
    assert chip_smoke.phase_ss_gmres(4)["iterations"] == 4


@pytest.mark.parametrize(
    "family,n,published", [("gmres", 4, 10), ("gmres_ilu", 4, 5), ("picard_ngs", 4, 16)]
)
def test_phase_count_matches_published(family, n, published):
    rec = chip_smoke.phase_count(family, "quad", n, published)
    assert rec["drift"] == 0


def test_phase_count_fails_outside_tolerance():
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.phase_count("gmres", "quad", 4, 30)


@pytest.mark.parametrize(
    "published,allowed", [(4, 2), (74, 2), (1673, 17), (11765, 118)]
)
def test_count_tolerance_is_two_or_one_percent(published, allowed):
    assert chip_smoke.count_tolerance(published) == allowed


@pytest.mark.parametrize("argv", [[], ["--four-cards"], ["--compile-only"]])
def test_main_refuses_cpu(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_lists_cover_every_phase():
    names = [name for name, _ in chip_smoke.single_card_phases()]
    assert [n[0] for n in names[:8]] == list("AAABCDEF")
    assert len(names) == 8 + len(chip_smoke.FAMILIES) * len(chip_smoke.REFERENCE_MESHES)
    assert len(chip_smoke.compile_phases()) == 8


def test_four_card_phases_on_virtual_devices():
    """The --four-cards phases on a (2, 2) mesh of virtual CPU devices at
    tiny sizes: iteration counts equal to the single-device solves and
    every solution spread over all four devices."""
    import jax

    assert jax.device_count() >= 4
    phases = chip_smoke.four_card_phases(n=7, n3=7, n2=7, q2_cells=4)
    assert chip_smoke.run_phases(phases) == []
