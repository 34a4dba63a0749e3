"""Port engine modules vs their JAX-package counterparts, on the CPU.

The same seeded world goes through ``repro`` and ``repro_torch``:

* host modules (data generator, RangeForest tables, packed host tables, host
  plan blocks, window batches) must be bit-for-bit identical — they are the
  same NumPy code;
* the device functions of ``torch_engine`` are held against
  ``jax_engine`` on the same host tables: rank intervals exact, values
  ≤ 1e-13 relative (float64 both sides; only the association of the small
  feature contractions differs);
* ``FlatForestEngine.from_host_tables`` fed the REFERENCE's packed tables
  answers like the port's own build.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.jax_engine as je
import repro.core.rfs as ref_rfs
import repro.data.spatial as ref_spatial
import repro_torch.core.rfs as port_rfs
import repro_torch.core.torch_engine as te
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro.core.query_plan import build_host_plan as ref_build_host_plan
from repro_torch.core import TNKDE
from repro_torch.core.query_plan import build_host_plan

KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0)
TS = [2 * 86400.0, 4 * 86400.0, 5.5 * 86400.0]
HOST_KEYS = ("pm_pos", "pos_base", "pm_time", "pm_cum", "edge_base", "n_pad",
             "n_lev", "node_base")


def _world(mod):
    net = mod.make_network(60, 100, seed=13)
    return net, mod.make_events(net, 800, seed=14, span_days=12)


@pytest.fixture(scope="module")
def models():
    """(reference numpy model, port numpy model) over the same seeded world."""
    ref = RefTNKDE(*_world(ref_spatial), solution="rfs", engine="numpy", **KW)
    port = TNKDE(*_world(port_spatial), solution="rfs", engine="numpy", **KW)
    return ref, port


@pytest.fixture(scope="module")
def hosts(models):
    ref, port = models
    return (ref_rfs.build_packed_host_tables(ref.index),
            port_rfs.build_packed_host_tables(port.index))


@pytest.fixture(scope="module")
def plans(models):
    ref, port = models
    return (ref_build_host_plan(ref, ((0, 0), False), flush_cap=20_000, ls=False),
            build_host_plan(port, ((0, 0), False), flush_cap=20_000, ls=False))


# ------------------------------------------------------------ host, bitwise
def test_data_generator_bitwise():
    (rn, re), (pn, pe) = _world(ref_spatial), _world(port_spatial)
    for f in ("edge_src", "edge_dst", "edge_len"):
        assert np.array_equal(getattr(rn, f), getattr(pn, f))
    for f in ("edge_id", "pos", "time"):
        assert np.array_equal(getattr(re, f), getattr(pe, f))
    _, _, rmeta = ref_spatial.make_dataset("berkeley", scale=0.01, seed=3)
    _, _, pmeta = port_spatial.make_dataset("berkeley", scale=0.01, seed=3)
    assert rmeta == pmeta


def test_range_forest_tables_bitwise(models):
    ref, port = models
    for f in ("pos_flat", "cum_flat", "bridge", "time_cum", "n_pad", "n_levels", "edge_base"):
        assert np.array_equal(getattr(ref.index, f), getattr(port.index, f)), f
    assert ref.index.index_bytes == port.index.index_bytes


def test_build_packed_host_tables_bitwise(hosts):
    href, hport = hosts
    assert set(href) == set(hport)
    for k in HOST_KEYS:
        assert href[k].dtype == hport[k].dtype and np.array_equal(href[k], hport[k]), k
    assert href["n_nodes"] == hport["n_nodes"]
    assert href["steps_per_level"] == hport["steps_per_level"]
    assert len(href["node_starts"]) == len(hport["node_starts"])
    for a, b in zip(href["node_starts"], hport["node_starts"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("ls", [False, True])
def test_build_host_plan_blocks_bitwise(models, ls):
    ref, port = models
    pr = ref_build_host_plan(ref, ((0, 0), ls), flush_cap=20_000, ls=ls)
    pp = build_host_plan(port, ((0, 0), ls), flush_cap=20_000, ls=ls)
    assert (pr.n_atoms, pr.pairs, pr.n_blocks) == (pp.n_atoms, pp.pairs, pp.n_blocks)
    assert pr.n_blocks > 1 and len(pr.dominated) == len(pp.dominated)
    for br, bp in zip(pr.blocks, pp.blocks):
        for f in ("lixel", "edge", "side_feat", "qs", "pos_hi", "pos_lo1", "lo1_right", "pos_lo2"):
            assert np.array_equal(getattr(br, f), getattr(bp, f)), f


def test_make_window_batch_bitwise(models):
    ref, port = models
    for a, b in zip(ref_rfs.make_window_batch(ref.ctx, TS), port_rfs.make_window_batch(port.ctx, TS)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_numpy_engine_bitwise(models):
    ref, port = models
    assert np.array_equal(ref.query(TS), port.query(TS))


# ------------------------------------------- device functions vs jax_engine
def _jax_side(href, ref_ctx, atoms):
    """Reference PackedForest / WindowBatch / FlatAtoms as jnp arrays
    (call under ``jax.enable_x64(True)``)."""
    pf = je.PackedForest(**{k: jnp.asarray(href[k]) for k in HOST_KEYS})
    t_lo, t_hi, lo_right, half, qt = ref_rfs.make_window_batch(ref_ctx, TS)
    wb = je.WindowBatch(*(jnp.asarray(x) for x in (t_lo, t_hi, lo_right, half, qt)))
    fa = je.FlatAtoms(
        lixel=jnp.asarray(atoms.lixel), edge=jnp.asarray(atoms.edge),
        side_feat=jnp.asarray(atoms.side_feat.astype(np.int32)), qs=jnp.asarray(atoms.qs),
        pos_hi=jnp.asarray(atoms.pos_hi), pos_lo1=jnp.asarray(atoms.pos_lo1),
        lo1_right=jnp.asarray(atoms.lo1_right), pos_lo2=jnp.asarray(atoms.pos_lo2),
        valid=jnp.ones(atoms.m, bool),
    )
    return pf, wb, fa


@pytest.fixture(scope="module")
def both_sides(models, hosts, plans):
    """Everything the comparisons need, computed once: the reference's
    tables/ranks/values (jnp, x64) and the port engine's inputs (torch)."""
    ref, port = models
    href, hport = hosts
    atoms_ref, atoms_port = plans[0].blocks[0], plans[1].blocks[0]
    fe = port_rfs.FlatForestEngine(port.index, executor="packed", device="cpu")
    max_levels = fe.max_levels
    with jax.enable_x64(True):
        pf, wb, fa = _jax_side(href, ref.ctx, atoms_ref)
        j_lo, j_hi = je.packed_root_ranks(pf, fa, search_steps=fe.search_steps)
        j_tabs = je.packed_node_tables(
            pf, wb, tuple(jnp.asarray(s) for s in href["node_starts"]),
            steps_per_level=href["steps_per_level"], k_t=int(ref.ctx.k_t))
        nbl = jnp.asarray(href["node_base"].T.copy())
        j_acc = je.packed_walk(j_tabs, nbl, fa.edge.astype(jnp.int32),
                               fa.side_feat, j_lo, j_hi, max_levels=max_levels)
        j_vals = je.eval_atoms_packed(j_tabs, nbl, fa, j_lo, j_hi, max_levels=max_levels)
        jx = {k: np.asarray(v) for k, v in dict(
            r_lo=j_lo, r_hi=j_hi, tabs=j_tabs, acc=j_acc, vals=j_vals).items()}
    t_fa = fe._device_atoms(atoms_port, np.arange(atoms_port.m))
    t_wb = fe.window_batch(port.ctx, TS)
    return fe, t_fa, t_wb, jx


def test_packed_root_ranks_exact(both_sides):
    fe, t_fa, _, jx = both_sides
    r_lo, r_hi = te.packed_root_ranks(fe._packed["pf"], t_fa, search_steps=fe.search_steps)
    assert r_lo.dtype == r_hi.dtype == torch.int32
    assert np.array_equal(r_lo.numpy(), jx["r_lo"]) and np.array_equal(r_hi.numpy(), jx["r_hi"])
    assert (jx["r_hi"] > jx["r_lo"]).any()


def test_packed_root_ranks_padded_atoms_are_empty(both_sides):
    """Padding rows (pos_hi = -inf, pos_lo* = +inf) must give r_lo == r_hi."""
    fe, t_fa, _, _ = both_sides
    n = 5
    pad = t_fa._replace(
        lixel=t_fa.lixel[:n], edge=t_fa.edge[:n], side_feat=t_fa.side_feat[:n], qs=t_fa.qs[:n],
        pos_hi=torch.full((n,), -np.inf, dtype=torch.float64),
        pos_lo1=torch.full((n,), np.inf, dtype=torch.float64),
        lo1_right=t_fa.lo1_right[:n],
        pos_lo2=torch.full((n,), np.inf, dtype=torch.float64),
        valid=torch.zeros(n, dtype=torch.bool),
    )
    r_lo, r_hi = te.packed_root_ranks(fe._packed["pf"], pad, search_steps=fe.search_steps)
    assert torch.equal(r_lo, r_hi)


def test_packed_node_tables_match(both_sides, monkeypatch):
    fe, _, t_wb, jx = both_sides
    pk = fe._packed
    kw = dict(steps_per_level=pk["steps_per_level"], k_t=int(fe.rf.ctx.k_t))
    tabs = te.packed_node_tables(pk["pf"], t_wb, pk["node_starts"], **kw)
    assert tabs.dtype == torch.float64 and tuple(tabs.shape) == jx["tabs"].shape
    scale = np.abs(jx["tabs"]).max()
    assert scale > 0 and np.abs(tabs.numpy() - jx["tabs"]).max() <= 1e-13 * scale
    # folding a level in several chunks changes nothing
    monkeypatch.setattr(te, "FOLD_CHUNK", 37)
    assert torch.equal(te.packed_node_tables(pk["pf"], t_wb, pk["node_starts"], **kw), tabs)


def test_packed_walk_and_eval_atoms_match(both_sides):
    fe, t_fa, t_wb, jx = both_sides
    pk = fe._packed
    tabs = fe.window_tables(t_wb, tuple(TS))
    r_lo, r_hi = torch.as_tensor(jx["r_lo"]), torch.as_tensor(jx["r_hi"])
    acc = te.packed_walk(tabs, pk["node_base_lvl"], t_fa.edge, t_fa.side_feat,
                         r_lo, r_hi, max_levels=fe.max_levels)
    vals = te.eval_atoms_packed(tabs, pk["node_base_lvl"], t_fa, r_lo, r_hi,
                                max_levels=fe.max_levels)
    for got, want in ((acc, jx["acc"]), (vals, jx["vals"])):
        assert tuple(got.shape) == want.shape
        scale = np.abs(want).max()
        assert scale > 0 and np.abs(got.numpy() - want).max() <= 1e-13 * scale


# ------------------------------------------------- state carried across
@pytest.mark.parametrize("executor", ["packed", "fused"])
def test_from_host_tables_serves_reference_state(models, hosts, executor):
    """Index state built by the reference package, served by the port."""
    ref, _ = models
    href, _ = hosts
    net, ev = _world(port_spatial)
    own = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu", **KW)
    fed = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu", **KW)
    fed._fe = port_rfs.FlatForestEngine.from_host_tables(
        fed.index, href, executor=executor, device="cpu")
    F_own, F_fed = own.query(TS), fed.query(TS)
    assert fed.engine_desc == f"torch/{executor}"
    assert np.array_equal(F_own, F_fed)
    want = ref.query(TS)
    assert np.abs(F_fed - want).max() <= 1e-12 * np.abs(want).max()


def test_packed_forest_from_numpy_types(hosts):
    pf, meta = te.packed_forest_from_numpy(hosts[1], "cpu")
    assert pf.pm_cum.dtype == pf.pm_pos.dtype == pf.pm_time.dtype == torch.float64
    assert pf.node_base.dtype == pf.pos_base.dtype == torch.int64
    assert meta["node_base_lvl"].shape == pf.node_base.T.shape
    assert meta["n_nodes"] == hosts[1]["n_nodes"]
    assert sum(int(s.shape[0]) for s in meta["node_starts"]) >= meta["n_nodes"]
