"""The roofline's work is the query's: the atoms ``roofline.query_atoms``
derives from the benchmark's own network select, for every lixel, exactly
the events the plain reference finds within ``b_s`` of it, each once."""
import numpy as np
import pytest

from tnkde_bench.harness import roofline
from tnkde_bench.harness.cell import BENCH, load_json
from tnkde_bench.harness.dataset import make_dataset
from tnkde_bench.reference.tnkde_ref import _pairs, lixel_geometry


@pytest.mark.parametrize("name", ["berkeley", "johns_creek"])
def test_atoms_select_every_event_in_range_once(name):
    cfg = load_json(BENCH / "configs" / f"{name}-rfs.json")
    ds = make_dataset(cfg["table3"], 0.01, 5)
    g, b_s = float(cfg["g"]), float(cfg["b_s"])
    n_lix = lixel_geometry(ds.edge_len, g)[0].shape[0]
    lixel, edge, side, r_lo, r_hi = roofline.query_atoms(ds, g, b_s, chunk=7)
    assert (r_lo < r_hi).all() and set(np.unique(side)) <= {0, 1}
    got = np.bincount(lixel, weights=r_hi - r_lo, minlength=n_lix)
    rows = _pairs(ds, g, b_s, np.arange(n_lix))[0]
    want = np.bincount(rows, minlength=n_lix)
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)
    # one atom per (lixel, edge, side), and intervals of an edge's sides are disjoint
    key = (lixel * ds.n_edges + edge) * 2 + side
    assert np.unique(key).shape[0] == key.shape[0]


def test_work_is_the_queries_not_the_layout():
    """The account scales with the windows as the formulas say, and counts
    no atom that selects nothing."""
    cfg = load_json(BENCH / "configs" / "berkeley-rfs.json")
    ds = make_dataset(cfg["table3"], 0.01, 5)
    w1 = roofline.query_work(ds, cfg, 1)
    w4 = roofline.query_work(ds, cfg, 4)
    a = w1["fused_walk"]
    assert a["rows_distinct"] <= a["rows_emitted"]
    assert w4["fused_walk"]["atoms_live"] == a["atoms_live"] == w1["segment_add"]["rows"]
    assert w4["segment_add"]["flops"] == 4 * w1["segment_add"]["flops"]
    assert w4["fused_walk"]["flops"] == 4 * a["flops"]
    assert roofline.bound_seconds(w4["fused_walk"]) > roofline.bound_seconds(a) > 0
