"""The slice as a whole: the port's ``TNKDE(engine='torch')`` on the CPU
(``device='cpu'``) vs the reference package and vs the port's SPS oracle.

Tolerances: ≤ 1e-12 relative to max|F| against the reference's NumPy engine
(float64 both sides, same tables; only summation order differs) and ≤ 1e-9
against the index-free SPS evaluation (a different algorithm: prefix-moment
differences vs direct kernel sums).

The equivalence matrix lives in ``tests/test_torch_tnkde_matrix_<executor>.py``
(one file per executor keeps the tier-1 run's files short); the shared worlds
and helpers are in ``tests/torch_tnkde_common.py``.
"""
import re

import jax
import numpy as np
import pytest

from repro.core import TNKDE as RefTNKDE
from repro_torch.core import TNKDE
from repro_torch.core.distributed import ShardMesh
from repro_torch.core.events import Events
from torch_tnkde_common import KW, REPO, TS5
from torch_tnkde_common import ref_world, world, x64_shim  # noqa: F401 (fixtures)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def test_executor_auto_resolves_to_packed(world):
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", device="cpu", **KW)
    assert (m.engine, m.engine_desc) == ("torch", "torch/packed")
    assert TNKDE(net, ev, solution="rfs", engine="auto", device="cpu", **KW).engine_desc == "torch/packed"
    assert TNKDE(net, ev, solution="rfs", engine="numpy", **KW).engine_desc == "numpy"
    assert TNKDE(net, ev, solution="sps", **KW).engine_desc == "numpy"


@pytest.mark.parametrize("executor", ["fused", "packed", "kernel"])
def test_edge_case_windows(world, executor):
    """query([]), a window far outside the event span (exact zeros, not NaN)
    and duplicate centres (bitwise equal rows)."""
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu", **KW)
    empty = m.query([])
    assert empty.shape == (0, m.n_lixels)
    far = m.query([100 * 86400.0])
    np.testing.assert_array_equal(far, np.zeros_like(far))
    dup = m.query([TS5[1], TS5[2], TS5[1]])
    assert np.isfinite(dup).all() and dup.max() > 0
    assert np.array_equal(dup[0], dup[2])
    again = m.query([TS5[1], TS5[2], TS5[1]])
    assert np.array_equal(dup, again)  # warm query: same bits


def test_dispatch_result_is_idempotent(world):
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor="fused", device="cpu", **KW)
    pending = m.dispatch(TS5[:2])
    assert not pending.done and pending.ts == TS5[:2]
    F = pending.result()
    assert pending.done and pending.result() is F
    assert np.array_equal(F, m.query(TS5[:2]))


# ----------------------------------------------------------------- counters
# the reference's name of each executor and the engine_desc it reports
REF_EXECUTOR = {"fused": ("fused", "jax/fused"), "packed": ("packed", "jax/packed"),
                "kernel": ("pallas", "pallas/pallas")}


@pytest.mark.parametrize("executor", ["fused", "packed", "kernel"])
def test_counters_equal_reference_device_engine(world, ref_world, x64_shim, executor):
    """n_rank_searches / n_moment_gathers / bytes_moved (and the launch
    count) follow the reference's formulas: equal to its jax engine (for
    ``kernel``, its ``executor='pallas'`` tier, Pallas in interpret mode),
    cold and warm, on one world."""
    ts = TS5[:3]
    rnet, rev = ref_world
    ref_executor, ref_desc = REF_EXECUTOR[executor]
    ref = RefTNKDE(rnet, rev, solution="rfs", engine="jax", executor=ref_executor, **KW)
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu", **KW)
    assert ref.engine_desc == ref_desc and m.engine_desc == f"torch/{executor}"
    for _ in range(2):  # cold, then warm
        F_ref, F = ref.query(ts), m.query(ts)
        assert np.abs(F - F_ref).max() <= 1e-12 * np.abs(F_ref).max()
        for stat in ("n_atoms", "n_rank_searches", "n_moment_gathers", "bytes_moved"):
            assert getattr(m.stats, stat) == getattr(ref.stats, stat), stat
        assert m._fe.counters["fused_launches"] == ref._fe.counters["fused_launches"]
    assert (m._fe.counters["fused_launches"] > 0) == (executor == "fused")


def test_kernel_executor_counts_no_fused_launch_and_searches_once(world):
    """executor='kernel': one [3, W, E] rank search per ts tuple (none on a
    warm query), no fused_launches (as in the reference), warm == cold."""
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor="kernel", device="cpu", **KW)
    cold = m.query(TS5[:2])
    s0 = m.stats.n_rank_searches
    assert s0 == 3 * 2 * net.n_edges
    assert np.array_equal(m.query(TS5[:2]), cold)
    assert m.stats.n_rank_searches == s0 and m._fe.counters["fused_launches"] == 0
    assert m.stats.bytes_per_shard == m._fe.device_bytes > 0


def test_warm_query_searches_nothing_and_one_launch_per_pack(world):
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor="fused", device="cpu", **KW)
    m.query(TS5[:2])
    packs = m._fe._atom_packs(m._host_plan())
    s0, l0 = m.stats.n_rank_searches, m._fe.counters["fused_launches"]
    assert s0 > 0 and l0 == len(packs) > 0
    m.query(TS5[:2])
    assert m.stats.n_rank_searches == s0
    assert m._fe.counters["fused_launches"] == 2 * l0
    assert m.stats.bytes_per_shard == m._fe.device_bytes > 0


def test_x64_shim_does_not_leak():
    """The fixture above must leave jax as it found it."""
    import repro.core.rfs  # noqa: F401 — the module whose engines use the call

    fn = getattr(jax.experimental, "enable_x64", None)
    assert fn is None or getattr(fn, "__name__", "") != "<lambda>"


# ------------------------------------- what the later slices brought (A5, A8)
@pytest.mark.parametrize("kwargs,desc", [
    # the table codec and ADA: tests/test_torch_codec.py::test_a3_arguments_are_served
    (dict(mesh=ShardMesh.on_one_device(2, device="cpu")), "torch/packed@shards=2"),
    (dict(executor="search"), "torch/search"),
    (dict(executor="cascade"), "torch/cascade"),
])
def test_a5_a8_arguments_are_served(world, kwargs, desc):
    """Sharding and the legacy executors raise no NotImplementedError: they
    answer, within 1e-12 of the packed executor (tests/test_torch_distributed.py
    and tests/test_torch_search_cascade.py hold them against the reference)."""
    net, ev = world
    m = TNKDE(net, ev, device="cpu", **{**KW, **kwargs})
    assert m.engine_desc == desc
    want = TNKDE(net, ev, engine="torch", executor="packed", device="cpu", **KW).query(TS5[:2])
    got = m.query(TS5[:2])
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("solution", ["rfs", "drfs"])
def test_executor_pallas_is_called_kernel_here(world, solution):
    """The reference's executor='pallas' tier is executor='kernel' in this
    package: the old name is refused with a ValueError that names the new
    one, never served under a different path."""
    net, ev = world
    with pytest.raises(ValueError, match="executor='kernel'"):
        TNKDE(net, ev, solution=solution, engine="torch", executor="pallas", device="cpu", **KW)
    m = TNKDE(net, ev, solution=solution, engine="torch", executor="kernel", device="cpu", **KW)
    assert m.engine_desc == "torch/kernel"


STREAMING_METHODS = ("insert", "seal", "extend", "compact", "snapshot")  # served (Queue A4)


@pytest.mark.parametrize("method", STREAMING_METHODS)
def test_unsupported_methods_raise_not_implemented(world, method):
    """The streaming methods are served for solution='drfs' and, as in the
    reference, refused by a static index (``snapshot`` pins nothing). The
    durability and serve-tier methods (``degrade``, ``attach_wal``,
    ``checkpoint``, ``restore``) are served too:
    ``tests/test_torch_serve.py::test_a6_a7_methods_are_served``."""
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="numpy", **KW)
    if method == "snapshot":
        assert m.snapshot() is None
        return
    args = (Events(ev.edge_id[:3], ev.pos[:3], ev.time[:3]),) if method == "insert" else ()
    with pytest.raises(ValueError, match=f"{method}\\(\\) requires solution='drfs'"):
        getattr(m, method)(*args)
    d = TNKDE(net, ev, solution="drfs", engine="numpy", drfs_depth=3, auto_seal=False, **KW)
    getattr(d, method)(*args)  # served: no NotImplementedError
    assert d.epoch[0] >= 3


def test_bad_arguments_raise_value_error(world):
    net, ev = world
    for kwargs in (dict(solution="nope"), dict(engine="jax"), dict(executor="nope"),
                   dict(table_codec="nope"), dict(solution="sps", engine="torch"),
                   dict(solution="sps", lixel_sharing=True)):
        with pytest.raises(ValueError):
            TNKDE(net, ev, device="cpu", **{**KW, **kwargs})


def test_default_device_needs_a_card(world):
    """device defaults to 'cuda'; without a card the constructor raises
    instead of carrying on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")
    net, ev = world
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TNKDE(net, ev, solution="rfs", engine="torch", executor="fused", **KW)


# ------------------------------------------------------------ independence
def test_port_imports_nothing_of_jax_or_the_reference_package():
    pat = re.compile(r"^\s*(import jax|from jax|from repro[. ]|import repro($|[. ]))", re.M)
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in pat.finditer(f.read_text())]
    assert not hits, hits
