"""The table codec on the CPU: ``TNKDE(table_codec='f32'|'bf16')`` of the port
against the JAX package.

* ``torch_engine.TableCodec`` validates like ``repro.core.jax_engine.TableCodec``
  (the same verdict and ``fallback_reason``, overflow and over-``rtol``
  included);
* the port *stores* what the reference stores: fold and node tables within
  one storage-dtype ulp of the reference's (plus the 1e-13 of the table's max
  by which the two f64 folds already differ, ``test_torch_engine``), the
  delta-encoded DRFS leaf prefix within 1e-6 of its max;
* the port *computes* in f64 on those values, where the reference computes in
  the table's dtype: answers within ``CODEC_TOL`` of the reference's
  (same executor family, same codec) and of the port's own f64 answer, and
  the port's executors within 1e-12 of each other on one codec; the
  counters equal the reference's;
* the plain walk and leaf on a narrow table are bitwise the f64 plain
  versions on the widened table.

The reference's device engines are reached through the ``x64`` shim of
``test_torch_drfs.py`` (set only while a reference model runs).
"""
import jax
import numpy as np
import pytest
import torch

import repro.core.jax_engine as je
import repro.data.spatial as ref_spatial
import repro_torch.core.torch_engine as te
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro_torch.core import TNKDE
from repro_torch.kernels import ops
from repro_torch.kernels.fused_walk import fused_leaf_flat_ref, fused_walk_flat_ref

# the world of tests/test_query_plan.py
KW = dict(g=40.0, b_s=600.0, b_t=2.5 * 86400.0)
TS = [3 * 86400.0, 6 * 86400.0]
# codec answer vs f64 (and vs the reference's codec answer), relative to
# max|F|: f32 storage moves an answer ~1e-7, bf16 (8 mantissa bits) ~1e-3
CODEC_TOL = {"f32": 2e-6, "bf16": 1e-2}
NARROW = {"f32": torch.float32, "bf16": torch.bfloat16}
# the port's executor and the reference's of the same family
REF_EXECUTOR = {"packed": "packed", "fused": "fused", "kernel": "pallas"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small: one intra-op thread does them as fast and
    leaves the cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(mod):
    net = mod.make_network(30, 50, seed=31)
    return net, mod.make_events(net, 400, seed=32, span_days=12)


def _rel(got, want):
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


_PORT, _REF = {}, {}


STATS = ("n_rank_searches", "n_moment_gathers", "bytes_moved")


def _cold(m):
    """(answer, stats) of the model's first query."""
    F = m.query(TS)
    return F, {k: getattr(m.stats, k) for k in STATS}


def _port(solution, executor, codec, exact=False):
    """The port's model after its first query: (model, answer, stats)."""
    key = (solution, executor, codec, exact)
    if key not in _PORT:
        m = TNKDE(*_world(port_spatial), solution=solution, engine="torch", executor=executor,
                  table_codec=codec, drfs_exact_leaf=exact, device="cpu", **KW)
        _PORT[key] = (m, *_cold(m))
    return _PORT[key]


def _ref(solution, executor, codec, exact=False):
    """The reference's model after its first query, built and run under the
    x64 shim: (model, answer, stats)."""
    key = (solution, executor, codec, exact)
    if key not in _REF:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax.experimental, "enable_x64", lambda *a, **k: jax.enable_x64(True),
                       raising=False)
            m = RefTNKDE(*_world(ref_spatial), solution=solution, engine="jax",
                         executor=executor, table_codec=codec, drfs_exact_leaf=exact, **KW)
            _REF[key] = (m, *_cold(m))
    return _REF[key]


# ------------------------------------------------------------- the codec
def _case(kind, rng):
    x = rng.normal(size=(64, 4, 3)) * 1e3
    if kind == "overflow":
        x[3, 1, 2] = 1e39  # beyond float32's (and bfloat16's) range
    if kind == "zeros":
        x[:] = 0.0
    return x


@pytest.mark.parametrize("preset", ["auto", "f64", "f32", "bf16"])
@pytest.mark.parametrize("kind", ["normal", "overflow", "over_rtol", "zeros"])
def test_table_codec_matches_reference(preset, kind):
    host = _case(kind, np.random.default_rng(5))
    port, ref = te.TableCodec(preset), je.TableCodec(preset)
    if kind == "over_rtol":  # no finite cast loses more than its preset's rtol
        port.rtol = ref.rtol = 1e-9
    assert port.name == ref.name and port.is_identity == ref.is_identity
    assert (port.fold_itemsize, port.moment_itemsize) == (ref.fold_itemsize, ref.moment_itemsize)
    assert port.validate(host) == ref.validate(host)
    assert port.fallback_reason == ref.fallback_reason
    assert (port.name, port.rtol, port.is_identity) == (ref.name, ref.rtol, ref.is_identity)
    assert (port.fold_itemsize, port.moment_itemsize) == (ref.fold_itemsize, ref.moment_itemsize)
    if preset in ("f32", "bf16") and kind in ("overflow", "over_rtol"):
        assert port.name == "f64" and port.fallback_reason  # fell back, and says why


def test_table_codec_names():
    assert te.TableCodec("f32").fold_dtype == torch.float32
    assert te.TableCodec("bf16").fold_dtype == torch.bfloat16
    assert te.TableCodec("bf16").moment_dtype == torch.float32
    assert te.TableCodec(te.TableCodec("bf16")).name == "bf16"
    with pytest.raises(ValueError, match="unknown table codec"):
        te.TableCodec("f16")


# ------------------------------------------------------ what is stored
def _tables(m, exact=False):
    """The engine's cached window table for TS (one tensor)."""
    fe = m._fe
    wb = fe.window_batch(m.ctx, TS)
    if m.solution == "rfs":
        return fe.window_tables(wb, tuple(TS))
    snap = m.snapshot()
    (tab,) = fe.window_tables(wb, tuple(TS), snap, fe._get_sealed(snap), snap.depth, exact)
    return tab


def _as_f64(t):
    return np.asarray(t.to(torch.float64)) if isinstance(t, torch.Tensor) \
        else np.asarray(t).astype(np.float64)


@pytest.mark.parametrize("codec", ["f32", "bf16"])
@pytest.mark.parametrize("solution", ["rfs", "drfs"])
def test_fold_tables_within_one_ulp(solution, codec):
    """RFS fold tables and DRFS exact node tables: each element within one
    ulp of the storage dtype of the reference's (and the f64 folds' own
    1e-13 of the table's max)."""
    exact = solution == "drfs"
    port = _tables(_port(solution, "packed", codec, exact)[0], exact)
    ref = _tables(_ref(solution, "packed", codec, exact)[0], exact)
    assert port.dtype == NARROW[codec] and port.is_contiguous()
    got, want = _as_f64(port), _as_f64(ref)
    assert got.shape == want.shape
    eps = torch.finfo(NARROW[codec]).eps
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = eps * np.exp2(np.floor(np.log2(np.where(mag > 0, mag, 1.0))))
    scale = np.abs(want).max()
    assert scale > 0 and (np.abs(got - want) <= ulp + 1e-13 * scale).all()


@pytest.mark.parametrize("codec", ["f32", "bf16"])
def test_delta_encoded_leaf_table(codec):
    """DRFS quantized mode: the leaf prefix table, delta-encoded in the
    moment dtype (float32 under both presets), within 1e-6 of its max of
    the reference's; contiguous, so the flush reads it in place."""
    port = _tables(_port("drfs", "packed", codec)[0])
    ref = _tables(_ref("drfs", "packed", codec)[0])
    assert port.dtype == torch.float32 and port.is_contiguous()
    got, want = _as_f64(port), _as_f64(ref)
    scale = np.abs(want).max()
    assert got.shape == want.shape and scale > 0
    assert np.abs(got - want).max() <= 1e-6 * scale


def test_delta_encoding_recovers_quantized_leaf_values():
    """The prefix sums f64 over float32-quantized per-leaf values: the
    difference of two neighbouring rows is the quantized value itself, to
    the final float32 cast of the prefix (not the cancellation of two
    unquantized prefixes)."""
    m = _port("drfs", "packed", "f32")[0]
    narrow = _tables(m).to(torch.float64)
    f64 = _tables(_port("drfs", "packed", "auto")[0])
    E = m.net.n_edges
    nleaf = 1 << m.snapshot().depth
    shape = (E, nleaf + 1, 2) + tuple(f64.shape[1:])
    leaf64 = f64.reshape(shape).diff(dim=1)
    leaf32 = narrow.reshape(shape).diff(dim=1)
    quant = leaf64.to(torch.float32).to(torch.float64)
    pref = narrow.reshape(shape).abs().amax(dim=1, keepdim=True)
    ulp = torch.finfo(torch.float32).eps * pref
    assert bool(((leaf32 - quant).abs() <= 2 * ulp).all())


# ------------------------------------------------------------- answers
CASES = [
    ("rfs", "packed", "f32", False), ("rfs", "packed", "bf16", False),
    ("rfs", "fused", "f32", False), ("rfs", "fused", "bf16", False),
    ("drfs", "packed", "f32", False), ("drfs", "fused", "f32", False),
    ("drfs", "kernel", "f32", False),
    ("drfs", "packed", "f32", True), ("drfs", "fused", "f32", True),
    ("drfs", "kernel", "f32", True),
    ("drfs", "packed", "bf16", True), ("drfs", "fused", "bf16", True),
    ("drfs", "kernel", "bf16", True),
]


@pytest.mark.parametrize("solution,executor,codec,exact", CASES)
def test_answers_match_reference(solution, executor, codec, exact):
    m, F, stats = _port(solution, executor, codec, exact)
    r, F_ref, ref_stats = _ref(solution, REF_EXECUTOR[executor], codec, exact)
    F64 = _port(solution, "packed", "auto", exact)[1]
    assert m.table_codec_used.name == r._fe.codec.name == codec
    assert m.table_codec_used.fallback_reason is None
    assert _rel(F, F_ref) <= CODEC_TOL[codec]
    assert _rel(F, F64) <= CODEC_TOL[codec]
    assert _rel(F, F64) > 0.0  # the narrow tables were read
    assert stats == ref_stats
    if executor == "fused":
        assert m._fe.counters["fused_launches"] > 0


@pytest.mark.parametrize("solution,codec,exact", [
    ("rfs", "f32", False), ("rfs", "bf16", False), ("drfs", "f32", False),
    ("drfs", "f32", True), ("drfs", "bf16", True),
])
def test_executors_agree_on_one_codec(solution, codec, exact):
    """packed, fused and (DRFS) kernel compute f64 on the same stored values:
    within 1e-12 of each other, as on f64 tables."""
    executors = ("packed", "fused") if solution == "rfs" else ("packed", "fused", "kernel")
    F0 = _port(solution, executors[0], codec, exact)[1]
    for ex in executors[1:]:
        assert _rel(_port(solution, ex, codec, exact)[1], F0) <= 1e-12


@pytest.mark.parametrize("codec", ["f32", "bf16"])
def test_rfs_kernel_executor_ignores_codec(codec):
    """RFS ``executor='kernel'`` reads the raw f64 forest, as the reference's
    pallas tier does: the codec does not reach it."""
    m = TNKDE(*_world(port_spatial), solution="rfs", engine="torch", executor="kernel",
              table_codec=codec, device="cpu", **KW)
    F64 = _port("rfs", "kernel", "auto")[1]
    F = m.query(TS)
    assert m.table_codec_used.name == "f64" and np.array_equal(F, F64)


def test_fused_f32_warm_bytes_bound():
    """Warm bytes_moved of fused+f32 ≤ 0.55 × the f64 packed executor's
    (the reference's gate, tests/test_query_plan.py)."""
    def warm_bytes(executor, codec):
        m = _port("rfs", executor, codec)[0]
        b0 = m.stats.bytes_moved
        m.query(TS)
        return m.stats.bytes_moved - b0

    fused, packed = warm_bytes("fused", "f32"), warm_bytes("packed", "auto")
    assert 0 < fused <= 0.55 * packed


@pytest.mark.parametrize("solution,executor,codec,exact", [
    ("rfs", "fused", "f32", False), ("rfs", "fused", "bf16", False),
    ("drfs", "fused", "bf16", False), ("drfs", "packed", "bf16", True),
])
def test_device_bytes_count_narrow_tables(solution, executor, codec, exact):
    """device_bytes counts each window table at its own itemsize: the codec
    engine holds exactly (8 − itemsize) bytes less per table element."""
    m = _port(solution, executor, codec, exact)[0]
    m64 = _port(solution, executor, "auto", exact)[0]
    tab = _tables(m, exact)
    saved = tab.numel() * (8 - tab.element_size())
    assert tab.element_size() < 8
    assert m64._fe.device_bytes - m._fe.device_bytes == saved


@pytest.mark.parametrize("solution", ["rfs", "drfs"])
def test_codec_fallback_is_visible(solution, monkeypatch):
    """A narrow codec that cannot hold the index falls back to f64 in place
    at build, says why, and answers as f64 does."""
    monkeypatch.setitem(te._CODEC_PRESETS["bf16"], "rtol", 1e-9)
    m = TNKDE(*_world(port_spatial), solution=solution, engine="torch", executor="fused",
              table_codec="bf16", device="cpu", **KW)
    used = m.table_codec_used
    assert used.name == "f64" and used.fallback_reason.startswith("round-trip error")
    assert "bfloat16" in used.fallback_reason
    assert np.array_equal(m.query(TS), _port(solution, "fused", "auto")[1])


# ------------------------------------------------------ the plain versions
def _flat_walk(dtype, rng):
    E, npad, G, Q, W, ks = 5, 16, 4, 33, 3, 2
    nlev = npad.bit_length()
    e = torch.arange(E)
    lvl_base = torch.stack([E * (2 * npad - 2 * (npad >> lev)) + e * (npad >> lev)
                            for lev in range(nlev)])
    table = torch.as_tensor(rng.normal(size=(2 * E * (2 * npad - 1), W * 2 * ks))).to(dtype)
    r_lo = rng.integers(0, npad + 1, (G, Q))
    r_hi = np.maximum(rng.integers(0, npad + 1, (G, Q)), r_lo)
    index = ops.walk_index(lvl_base, torch.as_tensor(rng.integers(0, E, G)), npad)
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32)  # noqa: E731
    return (table, index, i32(r_lo), i32(r_hi), i32(rng.integers(0, 2, (G, Q))),
            torch.as_tensor(rng.normal(size=(G, Q, ks))))


def _flat_leaf(dtype, rng):
    E, nleaf, G, Q, W, ks, kt = 5, 8, 4, 33, 3, 2, 2
    R = (nleaf + 1) * 2
    lcum = np.cumsum(rng.normal(size=(E, R, W * 2 * ks * kt)), axis=1).reshape(E * R, -1)
    lo = rng.integers(0, nleaf + 1, (G, Q))
    hi = np.maximum(rng.integers(0, nleaf + 1, (G, Q)), lo)
    i32 = lambda x: torch.as_tensor(x, dtype=torch.int32)  # noqa: E731
    return (torch.as_tensor(lcum).to(dtype), ops.leaf_index(torch.as_tensor(rng.integers(0, E, G)),
                                                            nleaf),
            i32(lo), i32(hi), i32(rng.integers(0, 2, (G, Q))),
            torch.as_tensor(rng.normal(size=(G, Q, ks))), torch.as_tensor(rng.normal(size=(W, kt))),
            torch.as_tensor(rng.normal(size=(W, kt))))


@pytest.mark.parametrize("kernel,dtype", [
    ("walk", torch.float32), ("walk", torch.bfloat16), ("leaf", torch.float32),
])
def test_plain_versions_widen_the_gathered_rows(kernel, dtype):
    """On a narrow table the plain versions (what the wrappers run on a CPU
    tensor) are bitwise the f64 plain versions on the widened table: each
    gathered row is widened, the arithmetic is f64."""
    rng = np.random.default_rng(17)
    args = _flat_walk(dtype, rng) if kernel == "walk" else _flat_leaf(dtype, rng)
    ref, wrapper = ((fused_walk_flat_ref, ops.fused_walk_flat) if kernel == "walk"
                    else (fused_leaf_flat_ref, ops.fused_leaf_flat))
    widened = (args[0].to(torch.float64),) + args[1:]
    want = ref(*widened)
    for got in (ref(*args), wrapper(*args)):
        assert got.dtype == torch.float64 and torch.equal(got, want)


def test_wrappers_take_only_instantiated_dtypes():
    """On a CUDA tensor the leaf kernel takes float64 and float32 tables, the
    walk also bfloat16: anything else is refused before any build."""
    assert set(ops.WALK_DTYPES) == {torch.float64, torch.float32, torch.bfloat16}
    assert set(ops.LEAF_DTYPES) == {torch.float64, torch.float32}
    with pytest.raises(TypeError, match="bfloat16"):
        ops._table_suffix("fused_leaf", torch.zeros(1, dtype=torch.bfloat16), ops.LEAF_DTYPES)
    assert ops.walk_stage_bytes(256, 20, 8) == 2 * 511 * 20 * 8
    # a bfloat16 node of W·2k_s = 2 values is 8 bytes: the block is rounded to 16
    assert ops.walk_stage_bytes(1, 2, 2) == 16
    # a narrow table stages the npad classes a float64 one does (W = 5, k_s = 2)
    for itemsize in (8, 4, 2):
        assert ops.walk_staged(128, 20, itemsize) and not ops.walk_staged(256, 20, itemsize)
        assert ops.walk_stageable(256, 20, itemsize)


# -------------------------------------------- the arguments A3 serves now
TNKDE_KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0)
_F64 = {}  # f64 answers of the argument sets below, by their kwargs
TS5 = [2 * 86400.0, 4 * 86400.0, 5.5 * 86400.0, 7 * 86400.0, 9 * 86400.0]


def _tnkde_world(mod):
    net = mod.make_network(60, 100, seed=13)
    return net, mod.make_events(net, 800, seed=14, span_days=12)


@pytest.mark.parametrize("kwargs", [
    dict(solution="drfs", table_codec="f32"),
    dict(solution="ada"),
    dict(table_codec="f32"),
    dict(table_codec="bf16"),
    dict(solution="drfs", horizon_s=3600.0, table_codec="bf16"),
], ids=["drfs-f32", "ada", "f32", "bf16", "drfs-horizon-bf16"])
def test_a3_arguments_are_served(kwargs):
    """What raised NotImplementedError until the codec and ADA were ported:
    each constructs and answers within CODEC_TOL of its f64 answer (ADA:
    bitwise the reference's)."""
    world = _tnkde_world(port_spatial)
    m = TNKDE(*world, device="cpu", **{**TNKDE_KW, **kwargs})
    F = m.query(TS5)
    if kwargs.get("solution") == "ada":
        want = RefTNKDE(*_tnkde_world(ref_spatial), solution="ada", **TNKDE_KW).query(TS5)
        assert m.engine_desc == "numpy" and np.array_equal(F, want)
        return
    codec = kwargs["table_codec"]
    f64 = {**kwargs, "table_codec": "auto"}
    key = tuple(sorted(f64.items()))
    if key not in _F64:
        _F64[key] = TNKDE(*world, device="cpu", **{**TNKDE_KW, **f64}).query(TS5)
    assert m.table_codec_used.name == codec and m.table_codec_used.fallback_reason is None
    assert 0.0 < _rel(F, _F64[key]) <= CODEC_TOL[codec]
