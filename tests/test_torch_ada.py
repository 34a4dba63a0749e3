"""``TNKDE(solution='ada')`` of the port on the CPU: the paper's SOTA baseline
(aggregate distance augmentation, a per-window linear index) is host NumPy in
both packages, so the port's answers are bitwise the reference's, with and
without lixel sharing; against the port's RFS it agrees to 1e-12 of max|F|
(float64 both, a different index and summation order)."""
import numpy as np
import pytest

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.ada import AggregateDistanceIndex as RefADA
from repro_torch.core import TNKDE
from repro_torch.core.ada import AggregateDistanceIndex

KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0)
TS5 = [2 * 86400.0, 4 * 86400.0, 5.5 * 86400.0, 7 * 86400.0, 4 * 86400.0]


def _world(mod):
    net = mod.make_network(60, 100, seed=13)
    return net, mod.make_events(net, 800, seed=14, span_days=12)


@pytest.mark.parametrize("ls", [False, True])
def test_ada_matches_reference_bitwise(ls):
    port = TNKDE(*_world(port_spatial), solution="ada", lixel_sharing=ls, **KW)
    ref = RefTNKDE(*_world(ref_spatial), solution="ada", lixel_sharing=ls, **KW)
    F = port.query(TS5)
    assert port.engine_desc == "numpy" and port.table_codec_used is None
    assert np.array_equal(F, ref.query(TS5)) and np.abs(F).max() > 0
    assert np.array_equal(F[1], F[4])  # duplicate window centres
    assert port.stats.index_bytes == ref.stats.index_bytes > 0
    assert port.stats.n_atoms == ref.stats.n_atoms


def test_ada_window_index_bitwise():
    """The per-window filter + sort + prefix index itself."""
    port = TNKDE(*_world(port_spatial), solution="ada", **KW)
    ref = RefTNKDE(*_world(ref_spatial), solution="ada", **KW)
    assert isinstance(port.index, AggregateDistanceIndex) and isinstance(ref.index, RefADA)
    for t in TS5[:3]:
        for a, b in zip(port.index.build_window(t), ref.index.build_window(t)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("ls", [False, True])
def test_ada_matches_rfs(ls):
    world = _world(port_spatial)
    F_ada = TNKDE(*world, solution="ada", lixel_sharing=ls, **KW).query(TS5)
    F_rfs = TNKDE(*world, solution="rfs", engine="numpy", lixel_sharing=ls, **KW).query(TS5)
    assert np.abs(F_ada - F_rfs).max() <= 1e-12 * np.abs(F_rfs).max()


def test_ada_has_no_device_engine():
    """As ``sps``: the device engine accelerates the forest flush only (the
    reference rejects ``engine='jax'|'pallas'`` for ADA)."""
    with pytest.raises(ValueError, match="rfs"):
        TNKDE(*_world(port_spatial), solution="ada", engine="torch", device="cpu", **KW)
