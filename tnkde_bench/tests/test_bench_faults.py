"""``correct`` comes out false when the timed path is broken underneath: a
run with the harness's look for a card skipped (CPU, small), once for each
fault the cells can have, and for the control, the program's float32 table
codec (the nearest precision below the configuration's float64)."""
import numpy as np
import pytest

from bench_small import run_small


def test_sound_runs_are_correct():
    for cell in ("berkeley-rfs-fresh", "johns_creek-rfs-serve", "johns_creek-rfs-over"):
        res, _ = run_small(cell)
        assert res["correct"], res
        assert res["check"]["rel_err"]["value"] < 1e-12


@pytest.mark.parametrize("cell", ["berkeley-rfs-fresh", "berkeley-rfs-dashboard"])
def test_answer_altered_where_produced(cell, monkeypatch):
    """One lixel's value changed by each scatter that produces it (every
    lixel checked, so the altered ones are among them)."""
    from repro_torch.kernels import ops

    orig = ops.segment_add

    def altered(heat, src, index, **kw):
        out = orig(heat, src, index, **kw)
        heat[int(index.lixel[0])] *= 1.0 + 1e-6
        return out

    monkeypatch.setattr(ops, "segment_add", altered)
    res, _ = run_small(cell, lixels=10**6)
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["berkeley-rfs-fresh", "johns_creek-rfs-serve",
                                  "johns_creek-rfs-over"])
def test_half_of_the_work_left_out(cell, monkeypatch):
    """Every other atom pack of a flush skipped."""
    from repro_torch.core import rfs

    orig = rfs._rfs_flush
    calls = {"n": 0}

    def half(tabs, entry, heat):
        calls["n"] += 1
        if calls["n"] % 2:
            orig(tabs, entry, heat)

    monkeypatch.setattr(rfs, "_rfs_flush", half)
    res, _ = run_small(cell)
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["johns_creek-rfs-serve", "johns_creek-rfs-over"])
def test_rows_regrouped_to_the_wrong_request(cell, monkeypatch):
    """The server hands a request the rows of its centres in the wrong order."""
    from repro_torch.serve.server import TNKDEServer

    orig = TNKDEServer._mk_ok_response

    def swapped(self, req, heat, stats):
        return orig(self, req, np.ascontiguousarray(heat[::-1]), stats)

    monkeypatch.setattr(TNKDEServer, "_mk_ok_response", swapped)
    res, _ = run_small(cell)
    assert not res["correct"]


@pytest.mark.parametrize("cell", ["berkeley-rfs-fresh", "johns_creek-rfs-serve",
                                  "johns_creek-rfs-over"])
def test_control_float32_tables_fail(cell):
    res, _ = run_small(cell, overrides={"table_codec": "f32"})
    assert not res["correct"]
    assert res["check"]["rel_err"]["value"] > res["check"]["rel_err"]["limit"]


@pytest.mark.chip
def test_control_on_the_card_at_the_cells_size(cuda):
    """The control at the cell's own size on the card, three seeds: each reads
    above the limit (``readings.py`` records the numbers)."""
    from tnkde_bench.harness.cell import run_cell

    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        res, _ = run_cell("berkeley-rfs-fresh", seed, 3.0, False, device=cuda,
                          overrides={"table_codec": "f32"})
        assert not res["correct"], res["check"]
