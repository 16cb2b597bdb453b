"""Level-scheduled parity-ILU on the XLA engine: the committed evaluation
(experiments/levelsched_eval.py) showed counts are engine-independent —
exact 6/8 at nx=4/8 through fori_loop trisolves."""

import pytest

from perphil_tpu.experiments.levelsched_eval import REF, run


@pytest.mark.parametrize("nx", [4, 8])
def test_levelsched_ilu_counts_exact_on_xla(nx, capsys):
    run(nx)
    out = capsys.readouterr().out
    assert f"its={REF[nx]} (ref {REF[nx]}) conv=True" in out
