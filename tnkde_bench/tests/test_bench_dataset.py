"""The frozen generator, given a configuration's Table-3 sizes, gives the
program's make_dataset arrays for that network bit for bit."""
import numpy as np
import pytest

from repro_torch.data.spatial import make_dataset as program_make_dataset
from tnkde_bench.harness.cell import load_json, BENCH
from tnkde_bench.harness.dataset import make_dataset


@pytest.mark.parametrize("name", ["berkeley", "johns_creek"])
@pytest.mark.parametrize("seed", [0, 2**31 + 7])
def test_frozen_generator_is_the_programs(name, seed):
    cfg = load_json(BENCH / "configs" / f"{name}-rfs.json")
    assert cfg["dataset"] == name
    net, ev, _ = program_make_dataset(name, scale=0.01, seed=seed)
    ds = make_dataset(cfg["table3"], 0.01, seed)
    assert ds.n_vertices == net.n_vertices
    for got, want in ((ds.edge_src, net.edge_src), (ds.edge_dst, net.edge_dst),
                      (ds.edge_len, net.edge_len), (ds.ev_edge, ev.edge_id),
                      (ds.ev_pos, ev.pos), (ds.ev_time, ev.time)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
