"""The plain reference agrees with the port's host path (engine='numpy') at
a small size, on every lixel, and lays its lixels out as the port does."""
import numpy as np
import pytest

from repro_torch.core import TNKDE
from tnkde_bench.harness.cell import BENCH, load_json
from tnkde_bench.harness.dataset import make_dataset
from tnkde_bench.harness.program import network_and_events
from tnkde_bench.reference.tnkde_ref import exact_heat, lixel_geometry


@pytest.mark.parametrize("name", ["berkeley", "johns_creek"])
def test_reference_matches_the_ports_numpy_engine(name):
    ds = make_dataset(load_json(BENCH / "configs" / f"{name}-rfs.json")["table3"], 0.01, 3)
    net, ev = network_and_events(ds)
    b_t = 0.2 * ds.t_span
    m = TNKDE(net, ev, g=50.0, b_s=800.0, b_t=b_t, solution="rfs", engine="numpy")
    lix_edge, lix_pos = lixel_geometry(ds.edge_len, 50.0)
    np.testing.assert_array_equal(lix_edge, m.lix.edge_id)
    np.testing.assert_array_equal(lix_pos, m.lix.pos)
    ts = [ds.t_min + f * ds.t_span for f in (0.1, 0.5, 0.93)]
    want = m.query(ts)  # [W, L]
    got = exact_heat(ds, g=50.0, b_s=800.0, b_t=b_t, lixels=np.arange(m.n_lixels), ts=ts)
    assert np.abs(want).max() > 0
    assert np.abs(got.T - want).max() <= 1e-10 * np.abs(want).max()
