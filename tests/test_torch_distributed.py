"""The sharded forest engines (``TNKDE(mesh=...)``) on the CPU against the
JAX package and the single-device port.

* host side, bitwise the reference's: ``assign_edges`` (degenerate cases
  included), every field of ``build_sharded_packed``,
  ``route_atoms_by_shard`` (its padding rules included), the DRFS sealed
  level tables, ``node_ptr`` and pending CSR per shard (the reference's
  slabbing run on host arrays), and ``plan_degraded_mesh``;
* the reference's equivalence matrix on its world (``make_network(36, 60,
  seed=31)``, 420 events, g 50, b_s 600, b_t 2 days): S ∈ {2, 4} shards ×
  rfs / quantized / exact_leaf within 1e-12 of the single-device port's
  packed executor and of the reference (``engine='numpy'``; in quantized
  mode its ``jax/packed``, see ``_reference``), with the bytes-per-shard and
  load-balance bounds;
* streaming insert → seal → extend → query against the SPS oracle (1e-11);
* ``TNKDEServer(mesh=)`` against an unsharded server (1e-12), checkpoint →
  restore of a sharded model, and ``degrade()`` dropping the mesh.
"""
import contextlib
import dataclasses
import types
from collections import OrderedDict

import numpy as np
import pytest
import torch

import repro.core.distributed as ref_dist
import repro.data.spatial as ref_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.plan import AtomSet as RefAtomSet
from repro.core.query_plan import route_atoms_by_shard as ref_route
from repro.ft.elastic import plan_degraded_mesh as ref_plan_degraded_mesh
from repro_torch.core import TNKDE, WriteAheadLog
from repro_torch.core.distributed import (
    ShardMesh,
    ShardedDynamicEngine,
    assign_edges,
    build_sharded_packed,
)
from repro_torch.core.events import Events
from repro_torch.core.plan import AtomSet
from repro_torch.core.query_plan import route_atoms_by_shard
import repro_torch.data.spatial as port_spatial
from repro_torch.ft import PreemptionHandler, plan_degraded_mesh
from repro_torch.serve import ProfileConfig, TNKDEServer
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)
from torch_tnkde_common import x64_shim  # noqa: F401 (fixture)

KW = dict(g=50.0, b_s=600.0, b_t=2.0 * 86400.0)
TS = [2.5 * 86400.0, 6.0 * 86400.0]
MODES = ("rfs", "quantized", "exact_leaf")


def _world(mod):
    net = mod.make_network(36, 60, seed=31)
    return net, mod.make_events(net, 420, seed=32, span_days=10)


@pytest.fixture(scope="module")
def world():
    return _world(port_spatial)


@pytest.fixture(scope="module")
def ref_world():
    return _world(ref_spatial)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def _mesh(S):
    return ShardMesh.on_one_device(S, device="cpu")


def _mode_kw(mode, depth=4):
    if mode == "rfs":
        return "rfs", {}
    return "drfs", dict(drfs_depth=depth, drfs_exact_leaf=(mode == "exact_leaf"))


# ----------------------------------------------------------- host side
@pytest.mark.parametrize("counts,S", [
    (np.array([5, 3]), 8),  # more shards than edges
    (np.zeros(12, np.int64), 4),  # zero-event edges spread round-robin
    (np.zeros(0, np.int64), 4),  # empty network
    (np.array([1000, 0, 0, 1000, 2, 2]), 2),  # heavy edges balance, light ones fill in
    (np.random.default_rng(5).integers(0, 300, 97), 3),
])
def test_assign_edges_equals_reference(counts, S):
    got = assign_edges(counts, S)
    assert got.dtype == np.int64 and np.array_equal(got, ref_dist.assign_edges(counts, S))
    if len(counts) == 2:
        assert got[0] != got[1]
    if len(counts) == 12:
        assert np.bincount(got, minlength=4).max() == 3


def _forests(world, ref_world):
    net, ev = world
    rnet, rev = ref_world
    port = TNKDE(net, ev, solution="rfs", engine="numpy", **KW).index
    ref = RefTNKDE(rnet, rev, solution="rfs", engine="numpy", **KW).index
    return port, ref


@pytest.mark.parametrize("S", [2, 4, "edges+3"])
def test_build_sharded_packed_equals_reference(world, ref_world, S):
    port, ref = _forests(world, ref_world)
    S = port.net.n_edges + 3 if S == "edges+3" else S
    got, want = build_sharded_packed(port, S), ref_dist.build_sharded_packed(ref, S)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        elif isinstance(b, tuple) and b and isinstance(b[0], np.ndarray):
            assert len(a) == len(b) and all(x.dtype == y.dtype and np.array_equal(x, y)
                                            for x, y in zip(a, b)), f.name
        else:
            assert a == b, f.name
    # every edge owned exactly once, local slots dense per shard
    for s in range(S):
        own = np.nonzero(got.shard_of_edge == s)[0]
        assert sorted(got.edge_slot[own]) == list(range(len(own)))
    assert got.pm_pos.shape[1] >= 1 and got.pm_time.shape[1] >= 1
    assert int(got.events_per_shard.sum()) == int(np.diff(port.ee.ptr).sum())


def _atoms(cls):
    m = 5
    return cls(
        lixel=np.arange(m),
        edge=np.array([0, 1, 1, 2, 3]),
        side_feat=np.zeros(m, np.int64),
        qs=np.ones((m, 2)),
        pos_hi=np.full(m, 10.0),
        pos_lo1=np.zeros(m),
        lo1_right=np.zeros(m, bool),
        pos_lo2=np.zeros(m),
    )


@pytest.mark.parametrize("pad_to", [4, None])
def test_route_atoms_by_shard_equals_reference(pad_to):
    shard_of = np.array([0, 1, 0, 1])
    edge_slot = np.array([0, 0, 1, 1])
    got = route_atoms_by_shard(_atoms(AtomSet), shard_of, edge_slot, 2, pad_to=pad_to)
    want = ref_route(_atoms(RefAtomSet), shard_of, edge_slot, 2, pad_to=pad_to)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
    assert got["valid"].sum() == 5
    assert list(got["edge"][0][got["valid"][0]]) == [0, 1]  # edges 0, 2
    assert list(got["edge"][1][got["valid"][1]]) == [0, 0, 1]  # 1, 1, 3
    pad = ~got["valid"]
    assert np.all(got["pos_hi"][pad] == -np.inf) and np.all(got["edge"][pad] == 0)


def test_route_real_plan_blocks_equal_reference(world, ref_world):
    net, ev = world
    rnet, rev = ref_world
    m = TNKDE(net, ev, solution="rfs", engine="numpy", **KW)
    r = RefTNKDE(rnet, rev, solution="rfs", engine="numpy", **KW)
    sf = build_sharded_packed(m.index, 3)
    for a, b in zip(m._host_plan().blocks, r._host_plan(None).blocks):
        got = route_atoms_by_shard(a, sf.shard_of_edge, sf.edge_slot, 3)
        want = ref_route(b, sf.shard_of_edge, sf.edge_slot, 3)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _ref_dynamic_slabs(rdf, S, snap):
    """The reference's ShardedDynamicEngine slabbing (``_get_sealed`` /
    ``_get_pending``) run on host arrays: a stand-in ``self`` whose device
    upload is the identity."""
    fake = types.SimpleNamespace(n_shards=S, max_snapshots=2, _sealed_packs=OrderedDict(),
                                 _pend_packs=OrderedDict(), _tab_cache=OrderedDict())
    fake.shard_of = ref_dist.assign_edges(np.diff(rdf.ptr), S)
    fake._owned, fake.El, fake.edge_slot = ref_dist._owned_lists(fake.shard_of, S)
    fake._own_mask = [np.isin(np.arange(rdf.net.n_edges), o) for o in fake._owned]
    fake._shard_put = lambda x: x
    fake._jax = types.SimpleNamespace(
        experimental=types.SimpleNamespace(enable_x64=contextlib.nullcontext))
    fake._lens_dev = np.ones((S, fake.El))
    sealed = ref_dist.ShardedDynamicEngine._get_sealed(fake, snap)
    pend = ref_dist.ShardedDynamicEngine._get_pending(fake, snap)
    return fake, sealed, pend


@pytest.mark.parametrize("S", [2, 4])
def test_dynamic_slabs_equal_reference(world, ref_world, S):
    net, ev = world
    rnet, rev = ref_world
    order = np.argsort(ev.time, kind="stable")
    port = TNKDE(net, Events(*(x[order[:300]] for x in (ev.edge_id, ev.pos, ev.time))),
                 solution="drfs", engine="numpy", drfs_depth=3, auto_seal=False, **KW)
    rorder = np.argsort(rev.time, kind="stable")
    ref_ev = type(rev)(*(x[rorder[:300]] for x in (rev.edge_id, rev.pos, rev.time)))
    ref = RefTNKDE(rnet, ref_ev, solution="drfs", engine="numpy", drfs_depth=3,
                   auto_seal=False, **KW)
    tail = Events(*(x[order[300:]] for x in (ev.edge_id, ev.pos, ev.time)))
    port.insert(tail)
    ref.insert(type(rev)(*(x[rorder[300:]] for x in (rev.edge_id, rev.pos, rev.time))))
    eng = ShardedDynamicEngine(port.index, _mesh(S))
    fake, r_sealed, r_pend = _ref_dynamic_slabs(ref.index, S, ref.index.snapshot())
    assert np.array_equal(eng.shard_of, fake.shard_of) and eng.El == fake.El
    assert np.array_equal(eng.edge_slot, fake.edge_slot)
    snap = port.index.snapshot()
    sealed, pend = eng._get_sealed(snap), eng._get_pending(snap)
    assert np.array_equal(sealed.max_occ, r_sealed.max_occ)
    assert sealed.n_levels == r_sealed.n_levels and pend.pend_steps == r_pend.pend_steps
    for name in ("time_lvl", "pos_lvl", "cum_lvl", "node_ptr"):
        got = np.stack([t[name].numpy() for t in sealed.tables])
        assert np.array_equal(got, r_sealed.tables[name]), name
    for name in ("pend_ptr", "pend_pos", "pend_time", "pend_phi"):
        got = np.stack([t[name].numpy() for t in pend.tables])
        assert np.array_equal(got, r_pend.tables[name]), name


@pytest.mark.parametrize("alive", [16, 40, 255, 256, 300, 511, 512, 700])
def test_plan_degraded_mesh_equals_reference(alive):
    assert dataclasses.asdict(plan_degraded_mesh(alive)) == dataclasses.asdict(
        ref_plan_degraded_mesh(alive))
    with pytest.raises(ValueError):
        plan_degraded_mesh(8)


def test_preemption_handler_runs_the_checkpoint_once_requested():
    calls = []
    h = PreemptionHandler(lambda: calls.append(1))
    assert h.poll() is False and calls == []
    h.requested.set()
    assert h.poll() is True and calls == [1]


def test_shard_mesh_axes_and_devices():
    mesh = ShardMesh(["cpu"] * 6, shape=(2, 3), axis_names=("pod", "data"))
    assert mesh.shape == {"pod": 2, "data": 3}
    assert len(mesh.shard_devices(("data",))) == 3
    assert len(mesh.shard_devices(("pod", "data"))) == 6
    with pytest.raises(ValueError):
        ShardMesh(["cpu"] * 5, shape=(2, 3), axis_names=("pod", "data"))
    listed = ShardMesh.from_devices(["cpu", "cpu", "cpu"])
    assert listed.shape == {"data": 3} and listed.shard_devices(("data",)) == listed.devices


# ------------------------------------------------- equivalence matrix
_SINGLE, _REF = {}, {}


def _single(world, mode, kw):
    key = (mode, tuple(sorted(kw.items())))
    if key not in _SINGLE:
        net, ev = world
        sol, mkw = _mode_kw(mode)
        m = TNKDE(net, ev, solution=sol, engine="torch", executor="packed", device="cpu",
                  **kw, **mkw)
        _SINGLE[key] = (m.query(TS), m.stats.bytes_per_shard)
    return _SINGLE[key]


def _reference(ref_world, mode, kw):
    """The reference's answer: ``engine='numpy'``, except in quantized DRFS
    mode its own device engine (``jax/packed``, through the x64 shim). That
    mode differences leaf prefixes, and on this world with the triangular ×
    quartic kernels the reference's ``jax/packed`` reads 1.1e-12 (relative)
    from its own ``engine='numpy'`` — as the port's single-device executors
    do — so the reference's own sharded test holds that mode against
    ``jax/packed``."""
    key = (mode, tuple(sorted(kw.items())))
    if key not in _REF:
        rnet, rev = ref_world
        sol, mkw = _mode_kw(mode)
        engine = "jax" if mode == "quantized" else "numpy"
        _REF[key] = RefTNKDE(rnet, rev, solution=sol, engine=engine, **kw, **mkw).query(TS)
    return _REF[key]


MATRIX = [(S, mode, ("triangular", "quartic")) for S in (2, 4) for mode in MODES] + [
    (2, mode, ("epanechnikov", "cosine")) for mode in MODES]


@pytest.mark.parametrize("S,mode,family", MATRIX)
def test_sharded_matches_single_device_and_reference(world, ref_world, x64_shim, S, mode,
                                                     family):
    net, ev = world
    kw = dict(KW, spatial_kernel=family[0], temporal_kernel=family[1])
    sol, mkw = _mode_kw(mode)
    m = TNKDE(net, ev, solution=sol, mesh=_mesh(S), device="cpu", **kw, **mkw)
    assert m.engine_desc == f"torch/packed@shards={S}"
    got = m.query(TS)
    single, single_bytes = _single(world, mode, kw)
    assert np.abs(single).max() > 0
    assert _rel(got, single) <= 1e-12
    assert _rel(got, _reference(ref_world, mode, kw)) <= 1e-12
    assert np.array_equal(m.query(TS), got)  # warm == cold
    if mode == "rfs":
        # per-shard slab ≈ 1/S of the single-device index (padding slack)
        frac = m.stats.bytes_per_shard / single_bytes
        assert 0 < frac <= 1.0 / S + 0.25, frac
        loads = m._fe.sf.events_per_shard.astype(float)
        assert loads.max() <= 2.0 * max(loads.mean(), 1.0), loads


@pytest.mark.parametrize("S", [2, 4])
def test_sharded_streaming_matches_sps(world, S):
    net, ev = world
    order = np.argsort(ev.time, kind="stable")

    def sub(lo, hi):
        return Events(ev.edge_id[order[lo:hi]], ev.pos[order[lo:hi]], ev.time[order[lo:hi]])

    ms = TNKDE(net, sub(0, 140), solution="drfs", mesh=_mesh(S), device="cpu", drfs_depth=3,
               drfs_exact_leaf=True, **KW)
    n_vis = 140
    errs = []
    for op, arg in (("insert", 60), ("query", None), ("insert", 80), ("query", None),
                    ("seal", None), ("query", None), ("extend", None), ("insert", 70),
                    ("query", None)):
        if op == "insert":
            ms.insert(sub(n_vis, n_vis + arg))
            n_vis += arg
        elif op == "seal":
            ms.index.seal()
        elif op == "extend":
            ms.index.extend()
        else:
            oracle = TNKDE(net, sub(0, n_vis), solution="sps", **KW).query(TS)
            errs.append(_rel(ms.query(TS), oracle))
    assert max(errs) <= 1e-11, errs


def test_sharded_server_matches_unsharded(world):
    net, ev = world
    order = np.argsort(ev.time, kind="stable")

    def sub(lo, hi):
        return Events(ev.edge_id[order[lo:hi]], ev.pos[order[lo:hi]], ev.time[order[lo:hi]])

    cfg = {"default": ProfileConfig(g=60.0, b_s=KW["b_s"], b_t=KW["b_t"], solution="drfs",
                                    drfs_depth=3)}
    srv_s = TNKDEServer(net, sub(0, 200), profiles=cfg, mesh=_mesh(2), device="cpu")
    srv_1 = TNKDEServer(net, sub(0, 200), profiles=cfg, device="cpu")
    assert srv_s.models["default"].engine_desc == "torch/packed@shards=2"
    for srv in (srv_s, srv_1):
        srv.submit(TS[:1])
    # a mutation between admission and pump: both answer the PINNED epoch
    for srv in (srv_s, srv_1):
        srv.insert(sub(200, 240))
        srv.submit(TS)
    got = {name: {r.id: r.heat for r in srv.pump(force=True)}
           for name, srv in (("sharded", srv_s), ("single", srv_1))}
    assert set(got["sharded"]) == set(got["single"]) and len(got["single"]) == 2
    for rid, b in got["single"].items():
        assert np.abs(b).max() > 0
        assert _rel(got["sharded"][rid], b) <= 1e-12


def test_sharded_checkpoint_restore_keeps_the_mesh(world, tmp_path):
    net, ev = world
    order = np.argsort(ev.time, kind="stable")

    def sub(lo, hi):
        return Events(ev.edge_id[order[lo:hi]], ev.pos[order[lo:hi]], ev.time[order[lo:hi]])

    kw = dict(KW, solution="drfs", drfs_depth=3, device="cpu")
    wal = WriteAheadLog(str(tmp_path / "wal"))
    m = TNKDE(net, sub(0, 300), mesh=_mesh(2), **kw)
    m.attach_wal(wal)
    m.insert(sub(300, 360))
    m.checkpoint(str(tmp_path / "ckpt"))
    m.insert(sub(360, 420))
    want = m.query(TS)
    wal.close()
    rec = TNKDE(net, sub(0, 300), mesh=_mesh(2), **kw)
    rep = rec.restore(str(tmp_path / "ckpt"), wal=WriteAheadLog(str(tmp_path / "wal")))
    assert rep.restored_step is not None and rep.n_records >= 1
    assert rec.engine_desc == "torch/packed@shards=2" and rec.epoch == m.epoch
    # the restored planner reads the full event view, the live one the
    # per-edge counts: candidate sets (and so the last bits) may differ
    assert _rel(rec.query(TS), want) <= 1e-12


@pytest.mark.parametrize("solution", ["rfs", "drfs"])
def test_degrade_drops_the_mesh_first(world, solution):
    net, ev = world
    m = TNKDE(net, ev, solution=solution, mesh=_mesh(2), device="cpu", drfs_depth=3, **KW)
    F = m.query(TS)
    assert m.degrade() == "torch/packed" and m.mesh is None
    assert _rel(m.query(TS), F) <= 1e-12
    assert m.degrade() == "numpy"


@pytest.mark.parametrize("kwargs", [
    dict(executor="fused"), dict(executor="kernel"), dict(executor="search"),
    dict(table_codec="f32"), dict(engine="numpy"), dict(solution="sps"),
    dict(shard_axes=("model",)),
])
def test_mesh_refuses_what_the_sharded_path_does_not_run(world, kwargs):
    net, ev = world
    with pytest.raises(ValueError):
        TNKDE(net, ev, mesh=_mesh(2), device="cpu", **{**KW, **kwargs})


def test_lower_flush_names_its_queue_item(world):
    """The queue item this once named (A10d) is done: ``lower_flush`` returns
    the flush's account, which a real query then matches shard for shard
    (``tests/test_torch_lower_flush.py`` holds it against the reference)."""
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", mesh=_mesh(2), device="cpu", **KW)
    wb = m._fe.window_batch(m.ctx, TS)
    lo = m._fe.lower_flush(wb, m._host_plan(), m.n_lixels)
    assert lo.n_shards == 2 and lo.launches > 0 and (lo.n_lixels, lo.n_windows) == \
        (m.n_lixels, len(TS))
    assert m._fe.bytes_per_shard == lo.slab_bytes_per_shard < lo.bytes_per_shard
    m.query(TS)
    assert m._fe.bytes_per_shard == lo.bytes_per_shard


def test_sharded_bytes_scale_with_shards(world):
    net, ev = world
    b = {S: TNKDE(net, ev, solution="rfs", mesh=_mesh(S), device="cpu", **KW)._fe.bytes_per_shard
         for S in (1, 2, 4)}
    assert b[4] < b[2] < b[1]
    assert torch.device("cpu") == _mesh(2).devices[0]
