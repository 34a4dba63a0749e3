"""DRFS streaming scripts on the CPU (moved unchanged from
``tests/test_torch_drfs.py``): seeded insert / seal / extend / query
interleavings and bulk inserts with ``compact()`` under a sliding horizon,
the port's ``engine='torch'`` (every executor, ``device='cpu'``) against the
reference's NumPy DRFS (≤ 1e-12 relative to max|F|) and the port's
index-free SPS oracle over the surviving events (≤ 1e-9: a different
algorithm).
"""
import numpy as np
import pytest

from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from torch_drfs_common import SKW, STS, _rel, _script, _small_worlds, _sps_over, _sub
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_interleavings_match_reference_and_sps(seed, executor):
    (net, ev), (rnet, rev) = _small_worlds(7 + seed)
    mk = dict(solution="drfs", drfs_depth=4, drfs_exact_leaf=True, **SKW)
    m = TNKDE(net, _sub(Events, ev, 0, 40), engine="torch", executor=executor, device="cpu", **mk)
    ref = RefTNKDE(rnet, _sub(RefEvents, rev, 0, 40), engine="numpy", **mk)
    n, n_ext = 40, 0
    for op in _script(np.random.default_rng(seed * 101 + 5), 9) + [("query",)]:
        if op[0] == "insert":
            k = min(op[1], len(ev[0]) - n)
            m.insert(_sub(Events, ev, n, n + k))
            ref.insert(_sub(RefEvents, rev, n, n + k))
            n += k
        elif op[0] == "seal":
            m.seal()
            ref.seal()
        elif op[0] == "extend" and n_ext < 2:  # bound the depth drift
            m.extend()
            ref.extend()
            n_ext += 1
        elif op[0] == "query":
            got, want = m.query(STS), ref.query(STS)
            assert m.epoch == ref.epoch
            assert _rel(got, want) <= 1e-12
            sps = _sps_over(net, m, STS)
            np.testing.assert_allclose(got, sps, rtol=1e-9, atol=1e-9 * max(sps.max(), 1.0))


@pytest.mark.parametrize("executor", ["packed", "fused", "kernel"])
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_under_horizon_matches_reference_and_sps(seed, executor):
    """Bulk inserts + compact() under a sliding horizon: after every
    compaction the port equals the reference and a fresh SPS over exactly
    the surviving events; compact() reports what the reference reports."""
    (net, ev), (rnet, rev) = _small_worlds(11 + seed)
    rng = np.random.default_rng(seed * 31 + 7)
    mk = dict(solution="drfs", drfs_depth=4, drfs_exact_leaf=True, auto_seal=False,
              horizon_s=2.5 * 86400.0, **SKW)
    m = TNKDE(net, _sub(Events, ev, 0, 40), engine="torch", executor=executor, device="cpu", **mk)
    ref = RefTNKDE(rnet, _sub(RefEvents, rev, 0, 40), engine="numpy", **mk)
    n, evicted = 40, 0
    while n < len(ev[0]):
        k = min(int(rng.integers(15, 60)), len(ev[0]) - n)
        m.insert(_sub(Events, ev, n, n + k))
        ref.insert(_sub(RefEvents, rev, n, n + k))
        n += k
        assert m.needs_compaction == ref.needs_compaction
        out = m.compact()
        assert out == ref.compact() and m.index.n_pending == 0
        evicted += out["evicted"]
        if out["evicted"]:  # the device packs of pre-eviction epochs are gone
            assert all(key[0] >= m.epoch[0] for key in m._fe._sealed_packs)
        assert m.epoch == ref.epoch and m.stream_t_max == ref.stream_t_max
        assert np.array_equal(m.ev_min_pos, ref.ev_min_pos)
        assert np.array_equal(np.diff(m.ee.ptr), np.diff(ref.ee.ptr))
        qts = [m.stream_t_max - 0.5 * 86400.0, m.stream_t_max]
        got, want = m.query(qts), ref.query(qts)
        assert _rel(got, want) <= 1e-12
        sps = _sps_over(net, m, qts)
        np.testing.assert_allclose(got, sps, rtol=1e-9, atol=1e-9 * max(sps.max(), 1.0))
    assert evicted > 0
