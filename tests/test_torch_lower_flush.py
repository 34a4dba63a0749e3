"""``ShardedForestEngine.lower_flush`` (the account of the sharded TN-KDE
flush) and ``launch.dryrun.kde_cell`` against the reference's lowering.

* The reference's ``lower_flush`` runs in a subprocess with 512 forced host
  devices (``tests/test_distributed_kde.py``'s way; the x64 shim applied
  there) on both production meshes over its ``kde_cell`` world
  (``make_network(40, 70, seed=5)``, 800 events, seed 6): the port's
  per-shard argument shapes, times S, equal the stacked shapes it lowers,
  every dtype equal but ``node_base_lvl``'s (int64 in the port, int32
  there); ``n_shards`` equal; the port's slab bytes per shard exceed the
  reference's ``bytes_per_shard`` (78 096 / 62 488) by exactly the
  int64-over-int32 bytes of ``node_base_lvl`` and ``node_starts``.
* On ``ShardMesh.on_one_device(S, 'cpu')`` for S ∈ {2, 16}, each shard's
  account equals ``_device_nbytes(_shard_parts(s))`` after a real query,
  and the flush calls ``segment_add`` as often as the account says.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.core import TNKDE
from repro_torch.core.distributed import ShardMesh
from repro_torch.core.rfs import _device_nbytes
from repro_torch.data.spatial import make_events, make_network
from repro_torch.kernels import _build, ops
from repro_torch.launch import dryrun
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(g=50.0, b_s=600.0, b_t=2.0 * 86400.0)
TS = [2.0 * 86400.0, 5.0 * 86400.0, 8.0 * 86400.0]
SCRIPT = textwrap.dedent(
    """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import sys, json
    sys.path.insert(0, sys.argv[1])
    import jax
    jax.experimental.enable_x64 = lambda *a, **k: jax.enable_x64(True)
    from repro.core import TNKDE
    from repro.data.spatial import make_network, make_events
    from repro.launch.mesh import make_production_mesh

    net = make_network(40, 70, seed=5)
    ev = make_events(net, 800, seed=6, span_days=10)
    out = {}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        m = TNKDE(net, ev, solution="rfs", mesh=mesh,
                  shard_axes=("pod", "data") if mp else ("data",), %KW%)
        fe = m._fe
        res = {"n_shards": int(fe.n_shards), "bytes_per_shard": int(fe.bytes_per_shard),
               "blocks": len(m._host_plan(None).blocks)}
        lowered = fe.lower_flush(fe.window_batch(m.ctx, %TS%), m._host_plan(None), m.n_lixels)
        leaves = jax.tree_util.tree_flatten_with_path(lowered.args_info)[0]
        res["args"] = {jax.tree_util.keystr(p): [list(a.shape), str(a.dtype)] for p, a in leaves}
        out["pod2" if mp else "pod1"] = res
    print(json.dumps(out))
    """
).replace("%KW%", ", ".join(f"{k}={v!r}" for k, v in KW.items())).replace("%TS%", repr(TS))
# the reference's rfs_flush(tables, node_base_lvl, atoms, r_lo, r_hi, heat)
REF_NAMES = {"[0][0]": "window_table", "[0][1]": "slab.node_base_lvl", "[0][3]": "pack[0].r_lo",
             "[0][4]": "pack[0].r_hi"}


@pytest.fixture(scope="module")
def ref_kde():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-c", SCRIPT, os.path.join(ROOT, "src")],
                         capture_output=True, text=True, timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cells():
    return {("pod2" if mp else "pod1"): dryrun.kde_cell(mp, compile_prog=False)
            for mp in (False, True)}


@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_account_shapes_match_reference_lowering(ref_kde, cells, mesh):
    ref, cell = ref_kde[mesh], cells[mesh]
    lo = cell["lowered"]
    S = ref["n_shards"]
    assert cell["n_shards"] == lo.n_shards == S == (16 if mesh == "pod1" else 32)
    assert ref["blocks"] == 1
    assert cell["engine_desc"] == f"torch/packed@shards={S}"
    for sh in lo.shards:
        for key, (shape, dtype) in ref["args"].items():
            if key == "[0][5]":  # the heatmap, replicated
                assert shape == [lo.n_lixels, lo.n_windows] and dtype == "float64"
                continue
            name = REF_NAMES.get(key) or "pack[0].fa." + key.split(".")[1]
            got_shape, got_dtype, _ = sh["args"][name]
            assert [S, *got_shape] == shape, (name, got_shape, shape)
            want = "int64" if name == "slab.node_base_lvl" else dtype
            assert got_dtype == want, (name, got_dtype, dtype)
    assert lo.launches == cell["segment_add_launches"] > 0
    assert lo.collectives == {"all-reduce": lo.n_lixels * lo.n_windows * 8,
                              "total": lo.n_lixels * lo.n_windows * 8}


@pytest.mark.parametrize("mesh", ["pod1", "pod2"])
def test_bytes_per_shard_differ_by_the_int64_indices(ref_kde, cells, mesh):
    ref, cell = ref_kde[mesh], cells[mesh]
    args = cell["lowered"].shards[0]["args"]
    int64_idx = [v for k, v in args.items()
                 if k == "slab.node_base_lvl" or k.startswith("slab.node_starts")]
    assert {dt for _, dt, _ in int64_idx} == {"int64"}
    gap = sum(nbytes // 2 for _, _, nbytes in int64_idx)  # 8 bytes here, 4 there
    assert cell["bytes_per_shard"] - ref["bytes_per_shard"] == gap
    assert (ref["bytes_per_shard"], cell["bytes_per_shard"]) == \
        {"pod1": (78096, 79040), "pod2": (62488, 63248)}[mesh]
    assert cell["flush_bytes_per_shard"] > cell["bytes_per_shard"]


@pytest.mark.parametrize("S", [2, 16])
def test_account_equals_a_real_flush(monkeypatch, S):
    net = make_network(40, 70, seed=5)
    ev = make_events(net, 800, seed=6, span_days=10)
    m = TNKDE(net, ev, solution="rfs", mesh=ShardMesh.on_one_device(S, "cpu"), device="cpu", **KW)
    fe = m._fe
    lo = fe.lower_flush(fe.window_batch(m.ctx, TS), m._host_plan(), m.n_lixels)
    calls = []
    real = ops.segment_add
    monkeypatch.setattr(ops, "segment_add", lambda *a, **k: calls.append(1) or real(*a, **k))
    F = m.query(TS)
    assert F.shape == (len(TS), m.n_lixels) == (lo.n_windows, lo.n_lixels)
    assert len(calls) == lo.launches
    assert [_device_nbytes(fe._shard_parts(s)) for s in range(S)] == \
        [sh["bytes"] for sh in lo.shards]
    assert fe.bytes_per_shard == lo.bytes_per_shard
    assert lo.slab_bytes_per_shard == max(_device_nbytes([fe._pf[s], fe._starts[s]])
                                          for s in range(S))


def test_compile_builds_the_flush_kernel():
    net = make_network(40, 70, seed=5)
    m = TNKDE(net, make_events(net, 800, seed=6, span_days=10), solution="rfs",
              mesh=ShardMesh.on_one_device(2, "cpu"), device="cpu", **KW)
    lo = m._fe.lower_flush(m._fe.window_batch(m.ctx, TS), m._host_plan(), m.n_lixels)
    assert lo.argument_bytes == lo.bytes_per_shard + lo.n_lixels * lo.n_windows * 8
    assert lo.temp_bytes == lo.n_lixels * lo.n_windows * 8
    try:
        _build.find_nvcc()
    except RuntimeError:
        with pytest.raises(RuntimeError, match="nvcc"):
            dryrun.kde_cell(False, compile_prog=True)
        return
    cell = dryrun.kde_cell(False, compile_prog=True)
    assert cell["library_load_s"] >= 0
    assert cell["memory"] == {"argument_bytes": cell["lowered"].argument_bytes,
                              "temp_bytes": cell["lowered"].temp_bytes}


def test_kde_main_writes_both_meshes(tmp_path, capsys):
    assert dryrun.main(["--kde", "--kde-no-compile", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    for tag, S in (("pod1", 16), ("pod2", 32)):
        rec = json.load(open(tmp_path / f"kde__{tag}.json"))
        assert rec["ok"] and rec["n_shards"] == S and "library_load_s" not in rec
        assert rec["engine_desc"] == f"torch/packed@shards={S}"
    assert "failures=0" in capsys.readouterr().out
