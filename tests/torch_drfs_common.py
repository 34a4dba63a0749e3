"""Worlds, constants and reference helpers shared by the DRFS test files of
the port (``tests/test_torch_drfs*.py``): the port's and the reference's
copies of one seeded world, the reference's NumPy answers cached per
configuration, the small streaming worlds and the port's index-free SPS
oracle over a model's current event set."""
import jax
import numpy as np
import pytest

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro_torch.core import TNKDE
from repro_torch.core.events import Events

KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0)
# one duplicated centre; the 11-day window covers the inserted (latest) events
TS5 = [2 * 86400.0, 4 * 86400.0, 5.5 * 86400.0, 11 * 86400.0, 4 * 86400.0]
FAMILIES = [("triangular", "quartic"), ("epanechnikov", "cosine"), ("gaussian", "triangular")]
N_BASE, N_INS = 700, 100  # the insert stays pending (100 < 700 / 4 seal trigger)


def _sorted_world(mod, n_nodes=60, n_edges=100, seed=13, n_events=800, span_days=12):
    net = mod.make_network(n_nodes, n_edges, seed=seed)
    ev = mod.make_events(net, n_events, seed=seed + 1, span_days=span_days)
    o = np.argsort(ev.time, kind="stable")
    return net, (ev.edge_id[o], ev.pos[o], ev.time[o])


@pytest.fixture(scope="module")
def worlds():
    return _sorted_world(port_spatial), _sorted_world(ref_spatial)


def _sub(cls, arrs, lo, hi):
    return cls(*(a[lo:hi] for a in arrs))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture
def x64_shim(monkeypatch):
    """The reference's device engines call ``jax.experimental.enable_x64``,
    which newer jax releases dropped; restored for one test only."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda *a, **k: jax.enable_x64(True), raising=False)


_REF = {}


def _reference(worlds, ks, kt, exact, ls):
    key = (ks, kt, exact, ls)
    if key not in _REF:
        _, (rnet, rev) = worlds
        m = RefTNKDE(rnet, _sub(RefEvents, rev, 0, N_BASE), solution="drfs", engine="numpy",
                     drfs_depth=5, drfs_exact_leaf=exact, lixel_sharing=ls,
                     spatial_kernel=ks, temporal_kernel=kt, **KW)
        m.insert(_sub(RefEvents, rev, N_BASE, N_BASE + N_INS))
        _REF[key] = m.query(TS5)
    return _REF[key]


SKW = dict(g=40.0, b_s=600.0, b_t=2.0 * 86400.0)
STS = [2.5 * 86400.0, 6.0 * 86400.0]


def _small_worlds(seed):
    args = dict(n_nodes=24, n_edges=40, seed=seed, n_events=240, span_days=9)
    return _sorted_world(port_spatial, **args), _sorted_world(ref_spatial, **args)


def _sps_over(net, m, ts, kw=SKW):
    """The port's index-free oracle over the model's CURRENT event set."""
    e, p, t = m.index.snapshot().event_set()
    return TNKDE(net, Events(e, p, t), solution="sps", **kw).query(ts)


def _script(rng, n_ops):
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        ops.append(("insert", int(rng.integers(1, 45))) if r < 0.45 else
                   ("seal",) if r < 0.6 else ("extend",) if r < 0.7 else ("query",))
    return ops
