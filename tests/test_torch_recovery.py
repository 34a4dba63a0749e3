"""Durability of the port (``repro_torch.ckpt``, ``TNKDE.checkpoint`` /
``restore``, ``repro_torch.ft.faults``) against the reference package.

Both ways: a reference checkpoint + WAL is restored by the port, and a port
checkpoint + WAL by the reference; the recovered model answers within
``TOL`` (1e-12 relative to max|F|) of the reference's uncrashed run at
identical epochs. A fingerprint mismatch raises in both directions, a save
killed at any ``_CRASH_HOOK`` stage leaves the last committed step readable
by both packages, and eviction replays to bit-identical index arrays. The
port runs on the CPU (``device='cpu'``: the kernels' plain versions); the
reference runs its NumPy engine, which needs no shim.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro.ckpt as ref_ckpt
import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.events import Events as RefEvents
from repro.core.wal import WriteAheadLog as RefWAL
from repro.ft.faults import tear_wal_tail as ref_tear
from repro_torch.ckpt import (
    latest_step,
    load_checkpoint_arrays,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.core import TNKDE, WriteAheadLog
from repro_torch.core.events import Events
from repro_torch.ft.faults import KillPoint, crash_checkpoint_save, tear_wal_tail
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

KW = dict(g=40.0, b_s=600.0, b_t=2.0 * 86400.0, solution="drfs", drfs_depth=4)
TS = [2.5 * 86400.0, 6.0 * 86400.0]
TOL = 1e-12
REPO = os.path.join(os.path.dirname(__file__), "..")


def _worlds(seed=7, n_events=160):
    net = port_spatial.make_network(24, 40, seed=seed)
    ev = port_spatial.make_events(net, n_events, seed=seed, span_days=8.0)
    rnet = ref_spatial.make_network(24, 40, seed=seed)
    return net, ev, rnet, RefEvents(ev.edge_id, ev.pos, ev.time)


def _batches(net, cls, k=6, n=25, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(k):
        e = rng.integers(0, net.n_edges, n).astype(np.int32)
        out.append(cls(e, rng.uniform(0, net.edge_len[e]),
                       np.sort(rng.uniform(8.1e5 + i * 1e4, 8.1e5 + (i + 1) * 1e4, n))))
    return out


def _apply(model, batches, seal_at=(), extend_at=()):
    for i, b in enumerate(batches):
        model.insert(b)
        if i in seal_at:
            model.seal()
        if i in extend_at:
            model.extend()


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-300)


def _port(net, ev, engine, exact, **kw):
    executor = "fused" if engine == "torch" else "auto"
    return TNKDE(net, ev, engine=engine, executor=executor, drfs_exact_leaf=exact, device="cpu",
                 **{**KW, **kw})


# ------------------------------------------------------------- checkpoints
def _tree():
    return {"w": np.arange(12.0).reshape(3, 4), "i": np.arange(5),
            "nest": {"b": [np.ones(2, np.float32), np.zeros((2, 2), np.int8)], "a": 7.5},
            "gone": None}


def test_checkpoint_layout_equals_the_reference(tmp_path):
    """Same leaf keys, files, shapes and dtypes as ``jax.tree_util``'s walk
    in the reference; either package loads the other's save."""
    tree = _tree()
    save_checkpoint(str(tmp_path / "port"), 4, tree, extras={"x": 1})
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 4, tree, extras={"x": 1})
    for reader in (load_checkpoint_arrays, ref_ckpt.load_checkpoint_arrays):
        a, sa, ea = reader(str(tmp_path / "port"))
        b, sb, eb = reader(str(tmp_path / "ref"))
        assert (sa, ea) == (sb, eb) == (4, {"x": 1})
        assert list(a) == list(b) == ["['i']", "['nest']['a']", "['nest']['b'][0]",
                                      "['nest']['b'][1]", "['w']"]
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert sorted(os.listdir(tmp_path / "port" / "step_000000004")) == sorted(
        os.listdir(tmp_path / "ref" / "step_000000004"))


def test_restore_checkpoint_against_a_skeleton(tmp_path):
    """Shapes checked against the skeleton; leaves come back in its dtype,
    torch tensors as tensors; a tensor saved from any device is read back."""
    tree = {"a": torch.arange(6, dtype=torch.float64).reshape(2, 3), "b": np.arange(4)}
    save_checkpoint(str(tmp_path), 1, tree)
    skel = {"a": torch.zeros(2, 3, dtype=torch.float32), "b": np.zeros(4, np.int32)}
    out, step, _ = restore_checkpoint(str(tmp_path), skel)
    assert step == 1 and out["a"].dtype == torch.float32 and out["b"].dtype == np.int32
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"].numpy())
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros(3, 3), "b": np.zeros(4)})
    with pytest.raises(KeyError):
        restore_checkpoint(str(tmp_path), {"c": np.zeros(1)})


@pytest.mark.parametrize("stage,detail", [("array", 0), ("array", 1), ("meta", 0),
                                          ("commit", 0), ("replace", 0)])
def test_killed_save_leaves_the_last_commit_readable(tmp_path, stage, detail):
    """A save killed at any ``_CRASH_HOOK`` stage is invisible — even at
    'replace', where the staging dir already holds COMMIT — to both
    packages' readers, and the next save collects the debris."""
    tree = _tree()
    save_checkpoint(str(tmp_path), 10, tree)
    with crash_checkpoint_save(stage, detail):
        with pytest.raises(KillPoint):
            save_checkpoint(str(tmp_path), 20, {"w": tree["w"] + 1, "i": tree["i"]})
    assert latest_step(str(tmp_path)) == ref_ckpt.latest_step(str(tmp_path)) == 10
    for reader in (load_checkpoint_arrays, ref_ckpt.load_checkpoint_arrays):
        arrays, step, _ = reader(str(tmp_path))
        assert step == 10
        np.testing.assert_array_equal(arrays["['w']"], tree["w"])
    save_checkpoint(str(tmp_path), 30, tree)
    names = os.listdir(tmp_path)
    assert latest_step(str(tmp_path)) == 30
    assert not [n for n in names if n.endswith(".tmp")]
    assert all(os.path.exists(tmp_path / n / "COMMIT") for n in names)


# --------------------------------------------------- cross-package recovery
def _crashed_run(model, wal, batches, cdir):
    """The durable run both directions share: inserts with an explicit
    seal and extend, a checkpoint, two more inserts, then a crash whose
    torn final record was never applied."""
    model.attach_wal(wal)
    _apply(model, batches[:4], seal_at=(2,), extend_at=(3,))
    model.checkpoint(cdir)
    _apply(model, batches[4:])
    wal.close()


def _uncrashed(rnet, rev, batches, exact, **kw):
    ref = RefTNKDE(rnet, rev, engine="numpy", drfs_exact_leaf=exact, **{**KW, **kw})
    _apply(ref, batches[:4], seal_at=(2,), extend_at=(3,))
    ref.seal()  # the checkpoint's logged seal
    _apply(ref, [batches[4]])
    return ref


@pytest.mark.parametrize("exact", [False, True], ids=["quantized", "exact_leaf"])
@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_checkpoint_and_wal_restore_across_packages(tmp_path, direction, exact):
    net, ev, rnet, rev = _worlds()
    wdir, cdir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    if direction == "ref_to_port":
        writer = RefTNKDE(rnet, rev, engine="numpy", drfs_exact_leaf=exact, **KW)
        _crashed_run(writer, RefWAL(wdir), _batches(rnet, RefEvents), cdir)
        ref_tear(wdir, nbytes=7, scribble=True)
        rec = _port(net, ev, "torch", exact)
        rep = rec.restore(cdir, wal=WriteAheadLog(wdir))
        assert rec.engine_desc == "torch/fused"
    else:
        writer = _port(net, ev, "torch", exact)
        _crashed_run(writer, WriteAheadLog(wdir), _batches(net, Events), cdir)
        tear_wal_tail(wdir, nbytes=7, scribble=True)
        rec = RefTNKDE(rnet, rev, engine="numpy", drfs_exact_leaf=exact, **KW)
        rep = rec.restore(cdir, wal=RefWAL(wdir))
    assert rep.restored_step is not None and rep.n_truncated_bytes > 0
    assert rep.n_records == 1 and rep.n_events == 25
    ref = _uncrashed(rnet, rev, _batches(rnet, RefEvents), exact)
    assert rec.epoch == ref.epoch
    assert _rel(rec.query(TS), ref.query(TS)) <= TOL


@pytest.mark.parametrize("direction", ["ref_to_port", "port_to_ref"])
def test_fingerprint_mismatch_raises_both_ways(tmp_path, direction):
    net, ev, rnet, rev = _worlds()
    if direction == "ref_to_port":
        m = RefTNKDE(rnet, rev, engine="numpy", **KW)
        m.insert(_batches(rnet, RefEvents, k=1)[0])
        m.checkpoint(str(tmp_path))
        other = _port(net, ev, "numpy", False, b_s=500.0)
        same = _port(net, ev, "numpy", False)
    else:
        m = _port(net, ev, "numpy", False)
        m.insert(_batches(net, Events, k=1)[0])
        m.checkpoint(str(tmp_path))
        other = RefTNKDE(rnet, rev, engine="numpy", **{**KW, "b_s": 500.0})
        same = RefTNKDE(rnet, rev, engine="numpy", **KW)
    with pytest.raises(ValueError, match="fingerprint"):
        other.restore(str(tmp_path))
    assert same.restore(str(tmp_path)).restored_step == 1


def test_recovery_without_checkpoint_replays_the_whole_log(tmp_path):
    net, ev, rnet, rev = _worlds()
    m = _port(net, ev, "numpy", True)
    m.attach_wal(WriteAheadLog(str(tmp_path / "wal")))
    _apply(m, _batches(net, Events, k=3), seal_at=(1,))
    m._wal.close()
    rec = _port(net, ev, "torch", True)
    rep = rec.restore(str(tmp_path / "ckpt"), wal=WriteAheadLog(str(tmp_path / "wal")))
    assert rep.restored_step is None and rep.n_records == 4  # 3 inserts + seal
    ref = RefTNKDE(rnet, rev, engine="numpy", drfs_exact_leaf=True, **KW)
    _apply(ref, _batches(rnet, RefEvents, k=3), seal_at=(1,))
    assert rec.epoch == ref.epoch
    assert _rel(rec.query(TS), ref.query(TS)) <= TOL
    s0 = rec._wal.last_seq  # the recovered model is itself durable
    rec.insert(_batches(net, Events, k=1)[0])
    assert rec._wal.last_seq == s0 + 1


def test_crash_during_checkpoint_recovers_from_previous(tmp_path):
    """Killed mid-checkpoint: recovery restores the PREVIOUS commit and
    replays past it, including the seal marker the doomed save logged."""
    net, ev, rnet, rev = _worlds()
    wdir, cdir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    b, rb = _batches(net, Events), _batches(rnet, RefEvents)
    m = _port(net, ev, "torch", False)
    m.attach_wal(WriteAheadLog(wdir))
    _apply(m, b[:3], seal_at=(1,))
    m.checkpoint(cdir)
    step1 = latest_step(cdir)
    _apply(m, [b[3]], seal_at=(0,))
    with crash_checkpoint_save("meta"):
        with pytest.raises(KillPoint):
            m.checkpoint(cdir)
    m._wal.close()
    assert latest_step(cdir) == step1
    rec = RefTNKDE(rnet, rev, engine="numpy", **KW)
    rec.restore(cdir, wal=RefWAL(wdir))
    _apply(rec, rb[4:])
    ref = RefTNKDE(rnet, rev, engine="numpy", **KW)
    _apply(ref, rb[:3], seal_at=(1,))
    ref.seal()
    _apply(ref, [rb[3]], seal_at=(0,))
    ref.seal()
    _apply(ref, rb[4:])
    assert rec.epoch == ref.epoch
    assert _rel(rec.query(TS), ref.query(TS)) <= TOL


def test_evict_replay_is_bit_identical(tmp_path):
    """Horizon evictions replay exactly (each EVICT record carries its
    resolved stream time): the port's recovered index arrays and planner
    state equal the reference's uncrashed run bit for bit."""
    kw = dict(auto_seal=False, horizon_s=2.5e4)
    net, ev, rnet, rev = _worlds()
    b, rb = _batches(net, Events), _batches(rnet, RefEvents)
    wdir, cdir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    m = _port(net, ev, "torch", False, **kw)
    m.attach_wal(WriteAheadLog(wdir))
    n_evicted = 0
    for i in range(4):
        m.insert(b[i])
        n_evicted += m.compact()["evicted"]
        if i == 2:
            m.checkpoint(cdir)
    m.insert(b[4])
    m.compact()
    m.insert(b[5])  # torn below: never applied
    m._wal.close()
    assert n_evicted > 0
    tear_wal_tail(wdir, nbytes=7, scribble=True)
    rec = _port(net, ev, "torch", False, **kw)
    rep = rec.restore(cdir, wal=WriteAheadLog(wdir))
    assert rep.n_evicted > 0 and rep.n_truncated_bytes > 0
    ref = RefTNKDE(rnet, rev, engine="numpy", **{**KW, **kw})
    for i in range(4):
        ref.insert(rb[i])
        ref.compact()
        if i == 2:
            ref.seal()
    ref.insert(rb[4])
    ref.compact()
    assert rec.epoch == ref.epoch
    for f in ("ptr", "pos", "time", "phi"):
        np.testing.assert_array_equal(getattr(rec.index, f), getattr(ref.index, f))
    np.testing.assert_array_equal(rec._ev_counts, ref._ev_counts)
    np.testing.assert_array_equal(rec.ev_min_pos, ref.ev_min_pos)
    assert (rec._ee_tmin, rec._ee_tmax) == (ref._ee_tmin, ref._ee_tmax)
    ts2 = [rec.stream_t_max - 5e4, rec.stream_t_max]
    assert _rel(rec.query(ts2), ref.query(ts2)) <= TOL


def test_subprocess_crash_replay(tmp_path):
    """A real process death (``os._exit`` mid-stream) of a port model with a
    WAL: the parent recovers it and matches the reference."""
    wdir = str(tmp_path / "wal")
    child = textwrap.dedent(
        """
        import os, sys
        sys.path.insert(0, sys.argv[1])
        import numpy as np
        from repro_torch.core import TNKDE, WriteAheadLog
        from repro_torch.core.events import Events
        from repro_torch.data.spatial import make_events, make_network

        net = make_network(24, 40, seed=7)
        ev = make_events(net, 160, seed=7, span_days=8.0)
        m = TNKDE(net, ev, engine="numpy", g=40.0, b_s=600.0, b_t=2.0 * 86400.0,
                  solution="drfs", drfs_depth=4, device="cpu")
        m.attach_wal(WriteAheadLog(sys.argv[2]))
        rng = np.random.default_rng(3)
        for i in range(4):
            e = rng.integers(0, net.n_edges, 25).astype(np.int32)
            m.insert(Events(e, rng.uniform(0, net.edge_len[e]),
                            np.sort(rng.uniform(8.1e5 + i * 1e4, 8.1e5 + (i + 1) * 1e4, 25))))
            if i == 1:
                m.seal()
        os._exit(1)
        """
    )
    proc = subprocess.run([sys.executable, "-c", child, os.path.join(REPO, "src"), wdir],
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    net, ev, rnet, rev = _worlds()
    rec = _port(net, ev, "torch", False)
    rep = rec.restore(None, wal=WriteAheadLog(wdir))
    assert rep.n_records == 5 and rep.n_events == 100
    ref = RefTNKDE(rnet, rev, engine="numpy", **KW)
    _apply(ref, _batches(rnet, RefEvents, k=4), seal_at=(1,))
    assert rec.epoch == ref.epoch
    assert _rel(rec.query(TS), ref.query(TS)) <= TOL


def test_server_multi_profile_recovery(tmp_path):
    """One server WAL recovers every profile (quantized on the fused
    executor, exact on the host): the restored server equals the
    reference's uncrashed models and stays durable."""
    from repro_torch.serve import ProfileConfig, TNKDEServer

    net, ev, rnet, rev = _worlds()
    b, rb = _batches(net, Events), _batches(rnet, RefEvents)
    q = dict(g=40.0, b_s=600.0, b_t=2 * 86400.0, solution="drfs", drfs_depth=4)
    x = dict(g=40.0, b_s=500.0, b_t=86400.0, solution="drfs", drfs_depth=3, drfs_exact_leaf=True)
    profs = dict(q=ProfileConfig(engine="torch", executor="fused", **q),
                 x=ProfileConfig(engine="numpy", **x))
    wdir, cdir = str(tmp_path / "wal"), str(tmp_path / "ckpt")
    srv = TNKDEServer(net, ev, profs, device="cpu")
    srv.attach_wal(WriteAheadLog(wdir))
    for i, bb in enumerate(b[:4]):
        srv.insert(bb)
        if i == 2:
            srv.seal()
    srv.checkpoint(cdir)
    for bb in b[4:]:
        srv.insert(bb)
    srv._wal.close()
    rec = TNKDEServer(net, ev, profs, device="cpu")
    rep = rec.restore(cdir, wal=WriteAheadLog(wdir))
    assert rep.restored_step is not None
    for name, cfg in (("q", q), ("x", x)):
        ref = RefTNKDE(rnet, rev, engine="numpy", **cfg)
        for i, bb in enumerate(rb):
            ref.insert(bb)
            if i in (2, 3):
                ref.index.seal()  # the explicit seal and the checkpoint's
        assert rec.models[name].epoch == ref.epoch
        assert _rel(rec.models[name].query(TS), ref.query(TS)) <= TOL
    assert rec.models["q"].engine_desc == "torch/fused"
    s0 = rec._wal.last_seq
    rec.insert(b[0])
    assert rec._wal.last_seq == s0 + 1
    rec.submit(TS, profile="q", tag=0)
    (r,) = rec.pump()
    assert r.ok and _rel(r.heat, rec.models["q"].query(TS)) <= TOL
