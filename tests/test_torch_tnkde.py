"""The slice as a whole: the port's ``TNKDE(engine='torch')`` on the CPU
(``device='cpu'``) vs the reference package and vs the port's SPS oracle.

Tolerances: ≤ 1e-12 relative to max|F| against the reference's NumPy engine
(float64 both sides, same tables; only summation order differs) and ≤ 1e-9
against the index-free SPS evaluation (a different algorithm: prefix-moment
differences vs direct kernel sums).
"""
import pathlib
import re

import jax
import numpy as np
import pytest

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro_torch.core import TNKDE

KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0)
TS5 = [2 * 86400.0, 4 * 86400.0, 5.5 * 86400.0, 7 * 86400.0, 9 * 86400.0]
KERNEL_FAMILIES = [
    ("triangular", "quartic"),
    ("epanechnikov", "cosine"),
    ("quartic", "exponential"),
    ("cosine", "triangular"),
    ("exponential", "epanechnikov"),
    ("gaussian", "triangular"),
]
REPO = pathlib.Path(__file__).resolve().parents[1]


def _world(mod):
    net = mod.make_network(60, 100, seed=13)
    return net, mod.make_events(net, 800, seed=14, span_days=12)


@pytest.fixture(scope="module")
def world():
    return _world(port_spatial)


@pytest.fixture(scope="module")
def ref_world():
    return _world(ref_spatial)


_REF, _SPS = {}, {}


def _reference(ref_world, ks, kt, ls):
    """Reference package, NumPy engine, all five windows."""
    key = (ks, kt, ls)
    if key not in _REF:
        net, ev = ref_world
        _REF[key] = RefTNKDE(net, ev, solution="rfs", engine="numpy", lixel_sharing=ls,
                             spatial_kernel=ks, temporal_kernel=kt, **KW).query(TS5)
    return _REF[key]


def _sps(world, ks, kt):
    """The port's own index-free oracle."""
    key = (ks, kt)
    if key not in _SPS:
        net, ev = world
        _SPS[key] = TNKDE(net, ev, solution="sps", spatial_kernel=ks,
                          temporal_kernel=kt, **KW).query(TS5)
    return _SPS[key]


@pytest.fixture
def x64_shim(monkeypatch):
    """The reference's device engines call ``jax.experimental.enable_x64``,
    which newer jax releases dropped. Restore it for ONE test (monkeypatch
    undoes it afterwards, so the reference's own tests see jax as it is)."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda *a, **k: jax.enable_x64(True), raising=False)


# ------------------------------------------------------- equivalence matrix
@pytest.mark.parametrize("executor", ["fused", "packed"])
@pytest.mark.parametrize("ls", [False, True])
@pytest.mark.parametrize("W", [1, 5])
@pytest.mark.parametrize("ks,kt", KERNEL_FAMILIES)
def test_torch_engine_matches_reference_and_sps(world, ref_world, ks, kt, W, ls, executor):
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu",
              lixel_sharing=ls, spatial_kernel=ks, temporal_kernel=kt, **KW)
    assert m.engine_desc == f"torch/{executor}"
    got = m.query(TS5[:W])
    ref = _reference(ref_world, ks, kt, ls)[:W]
    assert got.shape == ref.shape and got.dtype == np.float64
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= 1e-12 * scale, np.abs(got - ref).max() / scale
    sps = _sps(world, ks, kt)[:W]
    assert np.abs(got - sps).max() <= 1e-9 * scale, np.abs(got - sps).max() / scale


def test_executor_auto_resolves_to_packed(world):
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", device="cpu", **KW)
    assert (m.engine, m.engine_desc) == ("torch", "torch/packed")
    assert TNKDE(net, ev, solution="rfs", engine="auto", device="cpu", **KW).engine_desc == "torch/packed"
    assert TNKDE(net, ev, solution="rfs", engine="numpy", **KW).engine_desc == "numpy"
    assert TNKDE(net, ev, solution="sps", **KW).engine_desc == "numpy"


@pytest.mark.parametrize("executor", ["fused", "packed"])
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
@pytest.mark.parametrize("executor", ["fused", "packed"])
def test_counters_equal_reference_device_engine(world, ref_world, x64_shim, executor):
    """n_rank_searches / n_moment_gathers / bytes_moved (and the launch
    count) follow the reference's formulas: equal to its jax engine, cold and
    warm, on one world."""
    ts = TS5[:3]
    rnet, rev = ref_world
    ref = RefTNKDE(rnet, rev, solution="rfs", engine="jax", executor=executor, **KW)
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu", **KW)
    assert ref.engine_desc == f"jax/{executor}"
    for _ in range(2):  # cold, then warm
        F_ref, F = ref.query(ts), m.query(ts)
        assert np.abs(F - F_ref).max() <= 1e-12 * np.abs(F_ref).max()
        for stat in ("n_atoms", "n_rank_searches", "n_moment_gathers", "bytes_moved"):
            assert getattr(m.stats, stat) == getattr(ref.stats, stat), stat
        assert m._fe.counters["fused_launches"] == ref._fe.counters["fused_launches"]
    assert (m._fe.counters["fused_launches"] > 0) == (executor == "fused")


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


# ------------------------------------------------------ what is not served
@pytest.mark.parametrize("kwargs,match", [
    (dict(solution="drfs"), "A4"),
    (dict(solution="ada"), "A3"),
    (dict(table_codec="f32"), "A3"),
    (dict(table_codec="bf16"), "A3"),
    (dict(mesh=object()), "A8"),
    (dict(executor="pallas"), "A5"),
    (dict(executor="search"), "A5"),
    (dict(executor="cascade"), "A5"),
    (dict(horizon_s=3600.0), "A4"),
])
def test_unsupported_arguments_raise_not_implemented(world, kwargs, match):
    net, ev = world
    with pytest.raises(NotImplementedError, match=match):
        TNKDE(net, ev, device="cpu", **{**KW, **kwargs})


@pytest.mark.parametrize("method", ["insert", "seal", "extend", "compact", "snapshot",
                                    "degrade", "attach_wal", "checkpoint", "restore"])
def test_unsupported_methods_raise_not_implemented(world, method):
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="numpy", **KW)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A"):
        getattr(m, method)()


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
