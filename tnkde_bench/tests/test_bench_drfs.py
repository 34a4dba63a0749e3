"""The streaming cell ``berkeley-drfs-exact`` (CPU, small): a sound run is
``correct``; the check turns it false when the scans are skipped, when the
pending feed is hidden from queries while the index still counts it, and
under the float32 control; the run loads no JAX module; every new metric
reads a value; and the tree phase's roofline account is the query's."""
import json
import subprocess
import sys

import numpy as np
import pytest

from bench_small import ROOT_PATHS, run_small
from tnkde_bench.harness import cell as C
from tnkde_bench.harness import roofline, roofline_drfs
from tnkde_bench.harness.dataset import make_dataset
from tnkde_bench.reference.tnkde_ref import _pairs, lixel_geometry

CELL = "berkeley-drfs-exact"
NEW_METRICS = ("drfs.tables_host_ms", "drfs.launch_host_ms", "drfs.scan_host_ms",
               "drfs.scan_pairs", "drfs.walk_roofline")
# accepted metrics whose layers the cell runs too
SHARED = {"end_to_end": ("query_p95_ms",),
          "per_layer": ("setup.build_s", "setup.first_query_s", "device.idle_pct",
                        "device.peak_gib")}


def test_sound_run_is_correct():
    res, info = run_small(CELL)
    assert res["correct"], res
    assert res["check"]["rel_err"]["value"] < 1e-12
    assert set(res["metrics"]) == {"setup_s", "windows_per_s", "query_p95_ms"}
    assert info["forbidden"] == []


def test_scans_skipped(monkeypatch):
    """The boundary-leaf and pending scans of every block left out: only
    the tree phase's whole leaves answer."""
    from repro_torch.core import rfs

    orig = rfs._dyn_plain_flush

    def tree_only(*a, tree=True, **kw):
        if tree:
            orig(*a, tree=tree, **kw)

    monkeypatch.setattr(rfs, "_dyn_plain_flush", tree_only)
    res, _ = run_small(CELL, lixels=10**6)
    assert not res["correct"]
    assert res["check"]["rel_err"]["value"] > res["check"]["rel_err"]["limit"]


def test_pending_feed_hidden_from_queries(monkeypatch):
    """The pending scan runs no trip while the index still counts every fed
    event as pending (the set-up check of `fed_closed_loop` passes)."""
    from repro_torch.core import rfs

    orig = rfs.FlatDynamicEngine._get_pending

    def hidden(self, snap):
        pack = orig(self, snap)
        pack.pend_steps = 0
        return pack

    monkeypatch.setattr(rfs.FlatDynamicEngine, "_get_pending", hidden)
    res, _ = run_small(CELL, lixels=10**6)
    assert not res["correct"]
    assert res["check"]["rel_err"]["value"] > res["check"]["rel_err"]["limit"]


def test_control_float32_tables_fail():
    res, _ = run_small(CELL, overrides={"table_codec": "f32"})
    assert not res["correct"]
    assert res["check"]["rel_err"]["value"] > res["check"]["rel_err"]["limit"]


REHEARSE = f"""
import json, sys
sys.path[:0] = {ROOT_PATHS!r}
from bench_small import run_small
from tnkde_bench.harness.cell import forbidden_modules
res, info = run_small({CELL!r})
print(json.dumps({{"correct": res["correct"], "forbidden": forbidden_modules(),
                  "loaded": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_run_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", REHEARSE], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["loaded"])
    assert "repro_torch" in out["loaded"]


class _Device:
    """A stand-in for the profiler's device trace (the CPU has none)."""

    def __init__(self, seconds):
        self.seconds = seconds

    def kernel_seconds(self, part):
        return self.seconds if part == "fused_walk_kernel" else 0.0


def test_every_new_metric_reads_a_value():
    """A traced run reads the host spans and the counter; the device's two
    (kernel time, peak memory) read a stand-in trace over the account the
    traffic module gives for the cell."""
    res, _ = run_small(CELL, trace=True)
    assert res["correct"], res
    host = NEW_METRICS[:4] + SHARED["per_layer"][:2]
    assert set(res["metrics"]) == set(host), res["metrics"]
    for name in host:
        assert res["metrics"][name]["value"] > 0.0
    wl, cfg = C.load_cell(CELL)
    ds = make_dataset(cfg["table3"], 0.02, 0)
    acc = roofline_drfs.query_work(ds, cfg, int(wl["params"]["windows"]), ds.ev_edge)
    bound = roofline.bound_seconds(acc)
    run = C.Run(device=_Device(4.0 * bound), work={"drfs_walk": acc}, peak_bytes=3 * 2**30)
    read = {m: C.load_module(C.BENCH / "metrics" / f"{m}.py").read
            for m in ("drfs.walk_roofline", "device.peak_gib")}
    assert read["drfs.walk_roofline"](run) == pytest.approx(25.0)
    assert read["device.peak_gib"](run) == pytest.approx(3.0)
    assert read["drfs.walk_roofline"](C.Run(work={"drfs_walk": acc})) is None


def test_new_cell_is_declared():
    spec = json.loads((C.BENCH.parent / "BENCHMARK.json").read_text())
    (cell,) = [w for w in spec["workloads"] if w["name"] == CELL]
    assert cell["chips"] == 1 and cell["config"] == "berkeley-drfs"
    for name in NEW_METRICS:
        (m,) = [m for m in spec["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "windows_per_s"
    for kind, names in SHARED.items():
        for name in names:
            (m,) = [m for m in spec[kind] if m["name"] == name]
            assert m["workloads"][-1] == CELL
    wl, cfg = C.load_cell(CELL)
    assert cfg["reduced"] == [] and cfg["scale"] == 1.0 and wl["params"]["windows"] == 24


def test_atom_bounds_select_every_event_in_range_once():
    """The position-bounded atoms select, for every lixel, exactly the
    events the plain reference finds within b_s of it; a covered leaf range
    holds only events inside its atom's bounds."""
    _, cfg = C.load_cell(CELL)
    ds = make_dataset(cfg["table3"], 0.01, 5)
    g, b_s = float(cfg["g"]), float(cfg["b_s"])
    n_lix = lixel_geometry(ds.edge_len, g)[0].shape[0]
    has = np.bincount(ds.ev_edge, minlength=ds.n_edges) > 0
    lixel, edge, side, lo, lo_open, hi = roofline_drfs.query_atom_bounds(ds, g, b_s, has,
                                                                        chunk=7)
    assert set(np.unique(side)) <= {0, 1}
    key = (lixel * ds.n_edges + edge) * 2 + side
    assert np.unique(key).shape[0] == key.shape[0]
    order = np.lexsort((ds.ev_pos, ds.ev_edge))
    ptr = np.searchsorted(ds.ev_edge[order], np.arange(ds.n_edges + 1))
    depth = int(cfg["drfs_depth"])
    leaf_lo, leaf_hi = roofline_drfs.leaf_ranges(ds.edge_len, edge, lo, lo_open, hi, depth)
    got = np.zeros(n_lix, np.int64)
    for i in range(lixel.shape[0]):
        p = ds.ev_pos[order[ptr[edge[i]]:ptr[edge[i] + 1]]]
        inside = (p <= hi[i]) & ((p > lo[i]) if lo_open[i] else (p >= lo[i]))
        got[lixel[i]] += int(inside.sum())
        w = ds.edge_len[edge[i]] / (1 << depth)
        covered = (p >= leaf_lo[i] * w) & (p <= leaf_hi[i] * w)
        assert not (covered & ~inside).any()
    rows = _pairs(ds, g, b_s, np.arange(n_lix))[0]
    want = np.bincount(rows, minlength=n_lix)
    assert want.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_tree_work_scales_with_windows():
    _, cfg = C.load_cell(CELL)
    ds = make_dataset(cfg["table3"], 0.01, 5)
    a1 = roofline_drfs.query_work(ds, cfg, 1, ds.ev_edge)
    a4 = roofline_drfs.query_work(ds, cfg, 4, ds.ev_edge)
    assert 0 < a1["rows_distinct"] <= a1["rows_emitted"]
    assert a4["atoms_live"] == a1["atoms_live"] > 0 and a4["flops"] == 4 * a1["flops"]
    assert roofline.bound_seconds(a4) > roofline.bound_seconds(a1) > 0
