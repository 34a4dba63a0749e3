"""``executor='search'|'cascade'`` (static RFS) on the CPU against the JAX
package.

* answers within 1e-12 (relative to max|F|) of the reference's
  ``engine='numpy'``, over two kernel families, for ``search``,
  ``cascade`` and ``cascade`` on a forest built without bridges
  (``cascade=False``: it runs ``search``, as the reference does);
* work counters (rank searches, moment gathers, bytes moved) equal to the
  reference's ``jax/search`` and ``jax/cascade`` engines, reached through
  the x64 shim;
* DRFS refuses both executors with ``ValueError``, as the reference does.
"""
import numpy as np
import pytest

from repro.core import TNKDE as RefTNKDE
from repro_torch.core import TNKDE
from torch_tnkde_common import KW, TS5, ref_world, world, x64_shim  # noqa: F401 (fixtures)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

FAMILIES = [("triangular", "quartic"), ("epanechnikov", "cosine")]
CASES = [("search", True), ("cascade", True), ("cascade", False)]


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("ks,kt", FAMILIES)
@pytest.mark.parametrize("executor,cascade", CASES)
def test_search_cascade_match_reference_numpy(world, ref_world, ks, kt, executor, cascade):
    net, ev = world
    rnet, rev = ref_world
    kw = dict(KW, spatial_kernel=ks, temporal_kernel=kt, cascade=cascade)
    ref = RefTNKDE(rnet, rev, solution="rfs", engine="numpy", **kw).query(TS5)
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu", **kw)
    served = executor if cascade else "search"
    assert m.engine_desc == f"torch/{served}"
    F = m.query(TS5)
    assert np.abs(ref).max() > 0
    assert _rel(F, ref) <= 1e-12
    assert np.array_equal(F[1], m.query([TS5[1]])[0])


@pytest.mark.parametrize("executor,cascade", CASES)
def test_search_cascade_counters_equal_reference(world, ref_world, x64_shim, executor, cascade):
    net, ev = world
    rnet, rev = ref_world
    kw = dict(KW, cascade=cascade)
    ref = RefTNKDE(rnet, rev, solution="rfs", engine="jax", executor=executor, **kw)
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu", **kw)
    assert ref.engine_desc.split("/")[1] == m.engine_desc.split("/")[1]
    for ts in (TS5[:3], TS5[:3], TS5):  # cold, warm, another window batch
        F_ref = ref.query(ts)
        F = m.query(ts)
        assert _rel(F, F_ref) <= 1e-12
        for name in ("n_rank_searches", "n_moment_gathers", "bytes_moved"):
            assert getattr(m.stats, name) == getattr(ref.stats, name), name


@pytest.mark.parametrize("executor", ["search", "cascade"])
def test_drfs_refuses_search_cascade(world, executor):
    net, ev = world
    with pytest.raises(ValueError, match="rfs-only"):
        TNKDE(net, ev, solution="drfs", engine="torch", executor=executor, device="cpu", **KW)
