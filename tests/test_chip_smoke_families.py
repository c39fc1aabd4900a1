"""chip_smoke.py's P4 and four-card phases on CPU, at tiny widths.

Every decoder P4 runs is compiled and checked against its oracle in its
own test file, so these tests cover the phase's wiring: the check list,
failure collection, one decoder check, one stream adapter, the grid step
and the four-card paths on virtual devices.  Apart from
tests/test_chip_smoke.py so that the two files run on separate workers.
"""

import pytest

from tests.test_chip_smoke import TINY, cs


def test_family_checks_cover_every_family():
    names = [name for name, _ in cs.family_checks(TINY)]
    assert len(names) == len(set(names))
    families = {name.split()[0] for name in names}
    assert families >= {
        "minsum", "bp", "minsum_qc", "bp_qc", "minsum_strat", "bp_strat",
        "ddbmp_strat", "ngdbf_hw", "gdbf", "ngdbf_systemc", "ddbmp",
        "nb_qspa", "nb_minsum", "nb_minmax",
    }
    assert sum(name.startswith("stream ") for name in names) == 6


@pytest.mark.parametrize("name", [
    "minsum ET peg_96_48",
    "ddbmp_strat highrate",
    "stream minsum_qc f16 qc_1008_504",
])
def test_family_check_runs_at_tiny_widths(name):
    dec, unc = dict(cs.family_checks(TINY))[name]()
    assert 0 <= dec <= unc


def test_families_phase_collects_every_failure(monkeypatch, tmp_path):
    def crash():
        raise RuntimeError("crash")

    monkeypatch.setattr(cs, "family_checks", lambda w: [
        ("good", lambda: (0, 3)), ("worse", lambda: (4, 3)),
        ("crash", crash),
    ])
    grid = []
    monkeypatch.setattr(cs, "grid_step", lambda *a: grid.append(a))
    with pytest.raises(cs.CheckFailed,
                       match=r"2 family checks failed: \['worse', 'crash'\]"):
        cs.phase_families(TINY, str(tmp_path), cs.CompileClock())
    assert len(grid) == 1


def test_grid_step_at_tiny_widths(tmp_path):
    bers = cs.grid_step(TINY, str(tmp_path), cs.CompileClock())
    assert len(bers) == 2


def test_four_card_paths_on_virtual_devices(tmp_path):
    """The --four-cards phases on the 8 virtual CPU devices."""
    st = cs.four_card_stream(TINY, lanes_per_card=8)
    assert st["differ"] == 0 and st["rows_differ"] == 0 and st["frames"] > 0
    gr = cs.four_card_grid(TINY, str(tmp_path), cs.CompileClock(),
                           word_errors=60, max_frames=4096)
    assert gr["worst_rel"] <= TINY.ber_tol
