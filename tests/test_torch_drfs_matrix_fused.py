"""The DRFS equivalence matrix, ``executor='fused'`` (moved unchanged from
``tests/test_torch_drfs.py``; one file per executor keeps the tier-1 run's
files short): ``TNKDE(solution='drfs', engine='torch', device='cpu')`` with
a pending insert live, over kernel families, window counts, lixel sharing
and both modes, ≤ 1e-12 relative to max|F| from the reference's
``engine='numpy'`` (float64 both sides; only summation order differs).
"""
import numpy as np
import pytest

from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from torch_drfs_common import FAMILIES, KW, N_BASE, N_INS, TS5, _reference, _rel, _sub
from torch_drfs_common import worlds  # noqa: F401 (a fixture)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("executor", ["fused"])
@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("ls", [False, True])
@pytest.mark.parametrize("W", [1, 5])
@pytest.mark.parametrize("ks,kt", FAMILIES)
def test_drfs_torch_engine_matches_reference(worlds, ks, kt, W, ls, exact, executor):
    (net, ev), _ = worlds
    m = TNKDE(net, _sub(Events, ev, 0, N_BASE), solution="drfs", engine="torch",
              executor=executor, device="cpu", drfs_depth=5, drfs_exact_leaf=exact,
              lixel_sharing=ls, spatial_kernel=ks, temporal_kernel=kt, **KW)
    assert m.engine_desc == f"torch/{executor}"
    m.insert(_sub(Events, ev, N_BASE, N_BASE + N_INS))
    assert m.index.n_pending == N_INS
    got = m.query(TS5[:W])
    want = _reference(worlds, ks, kt, exact, ls)[:W]
    assert got.shape == want.shape and got.dtype == np.float64
    assert np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-12
    if W == 5:
        assert np.array_equal(got[1], got[4])  # duplicate centres, pending scans live
