"""The window-table fold (``ops.fold_node_tables``, ``csrc/fold_tables.cu``).

On the CPU: the wrapper takes the plain version (``fold_node_tables_ref``)
and counts no launch, never substitutes it off the CPU, and refuses what the
kernel does not take; the plain version equals a brute-force fold in NumPy
(``np.searchsorted`` per node and window, the prefix difference and the q_t
contraction in the same order) bit for bit, over runs of 1 to 2^11 rows,
times on an integer grid so that window boundaries tie with events, +inf
pads, a level without nodes and W in {1, 4, 24}; the kernel source carries
its note and one entry per fold dtype.

On the card (marked ``cuda``; each skips without a CUDA device): the kernel
against the plain version on the same synthetic forests and on the
berkeley replica at full size with W = 24 — float64 within 1e-13 of
max|F| (KERNEL_TOL's reason: only association and FMA could differ; the
kernel rounds every subtract, multiply and add on its own, so it reads 0),
float32 and bfloat16 equal to the plain version's cast, or one unit in the
narrow type's last place where the float64 values differ — and the launch
count of an engine: 1 a fresh ``ts`` tuple (one a shard when sharded), 0 on
a cache hit. Run them on the card with
``python -m pytest -q tests/test_torch_fold_tables.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, fold_tables, ops
from repro_torch.kernels.fold_tables import MAX_LEVELS, fold_node_tables_ref

NARROW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}  # same-width int views
KERNEL_TOL = 1e-13


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fold kernel has no interpret mode")
    return torch.device("cuda")


def synth_forest(seed, counts, ks, kt, W, *, grid=24, band=3):
    """A packed-forest layout of ``counts[l]`` nodes at level l, each a
    time-sorted run of 2^l rows: a random number of events with times on
    an integer grid (so boundaries tie with events), +inf pads after them,
    inclusive prefix moments [T, 4, K] of random Φ rows (zero on pads).
    Window centres on the grid, half-width ``band``. Returns the host
    arrays and the wrapper's keywords."""
    rng = np.random.default_rng(seed)
    K = ks * kt
    times, cums = [], []
    for lev, n in enumerate(counts):
        L = 1 << lev
        t = np.sort(rng.integers(0, grid, (n, L)), axis=1).astype(np.float64)
        pad = np.arange(L)[None] >= rng.integers(0, L + 1, n)[:, None]
        t[pad] = np.inf
        phi = rng.normal(size=(n, L, 4, K)) * ~pad[..., None, None]
        times.append(t.reshape(-1))
        cums.append(np.cumsum(phi, axis=1).reshape(-1, 4, K))
    sizes = [n << lev for lev, n in enumerate(counts)]
    starts = np.concatenate([off + (np.arange(n) << lev) for lev, (n, off) in
                             enumerate(zip(counts, np.cumsum([0] + sizes)))]).astype(np.int64)
    c = rng.integers(0, grid, W).astype(np.float64)
    t_lo = np.stack([c - band, c], axis=1).reshape(-1)
    t_hi = np.stack([c, c + band], axis=1).reshape(-1)
    qt = rng.normal(size=(2 * W, kt))
    arrs = (np.concatenate(times), np.concatenate(cums), starts, t_lo, t_hi, qt)
    kw = dict(lvl_ptr=tuple(np.cumsum([0] + list(counts)).tolist()),
              steps=tuple(lev + 1 for lev in range(len(counts))), k_t=kt)
    return arrs, kw


def torch_args(arrs, device="cpu"):
    return tuple(torch.as_tensor(a).to(device).contiguous() for a in arrs)


def brute_force(arrs, lvl_ptr, k_t):
    """The fold in NumPy, one node at a time."""
    time, cum, starts, t_lo, t_hi, qt = arrs
    K = cum.shape[2]
    ks, W = K // k_t, t_lo.shape[0] // 2
    out = np.zeros((starts.shape[0] * 2, W, 2 * ks))
    for lev in range(len(lvl_ptr) - 1):
        for n in range(lvl_ptr[lev], lvl_ptr[lev + 1]):
            s = int(starts[n])
            run, rows = time[s:s + (1 << lev)], cum[s:s + (1 << lev)]
            for w in range(W):
                i = (np.searchsorted(run, t_lo[2 * w], "left"),
                     np.searchsorted(run, t_hi[2 * w], "right"),
                     np.searchsorted(run, t_hi[2 * w + 1], "right"))
                P = [rows[j - 1] if j > 0 else np.zeros((4, K)) for j in i]
                for side in range(2):
                    for half in range(2):
                        d = (P[half + 1][2 * side + half]
                             - P[half][2 * side + half]).reshape(ks, k_t)
                        q = qt[2 * w + half]
                        v = d[:, 0] * q[0]
                        for t in range(1, k_t):
                            v = v + d[:, t] * q[t]
                        out[2 * n + side, w, half * ks:(half + 1) * ks] = v
    return out


# (level counts, k_s, k_t, W): runs of 1 .. 2^11 rows, a level without nodes
# (an edge too short for it), W 1, 4 and 24, the gaussian's k_s and another k_t
SWEEP = [
    ((5, 4, 3, 2, 2, 1, 1, 1, 1, 1, 1, 1), 2, 2, 24),
    ((7, 0, 3, 1), 2, 2, 1),
    ((9, 5, 3), 2, 3, 4),
    ((3, 2, 1, 1), 11, 2, 4),
]


@pytest.mark.parametrize("counts,ks,kt,W", SWEEP)
def test_fold_plain_version_equals_brute_force(monkeypatch, counts, ks, kt, W):
    arrs, kw = synth_forest(sum(counts) * 7 + W, counts, ks, kt, W)
    monkeypatch.setattr(fold_tables, "FOLD_CHUNK", 3)  # levels folded in several chunks
    got = ops.fold_node_tables(*torch_args(arrs), **kw)
    assert got.dtype == torch.float64 and tuple(got.shape) == (sum(counts) * 2, W, 2 * ks)
    want = brute_force(arrs, kw["lvl_ptr"], kt)
    assert np.array_equal(got.numpy(), want)
    assert np.abs(want).max() > 0 and (want == 0).any()  # empty prefixes fold to 0


def test_ops_fold_cpu_uses_plain_version_and_counts_no_launch():
    arrs, kw = synth_forest(1, (6, 3, 2), 2, 2, 5)
    targs = torch_args(arrs)
    before = (ops.fold_node_tables.launches, dict(ops.fold_node_tables.launches_by_dtype))
    for dtype in (None, torch.float32, torch.bfloat16):
        got = ops.fold_node_tables(*targs, **kw, out_dtype=dtype)
        want = fold_node_tables_ref(*targs, **kw, out_dtype=dtype)
        assert got.dtype == (dtype or torch.float64) and torch.equal(got, want)
    assert (ops.fold_node_tables.launches, ops.fold_node_tables.launches_by_dtype) == before


def test_ops_fold_never_falls_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises — the
    plain version is never substituted (here: a device no kernel serves)."""
    arrs, kw = synth_forest(2, (4, 2), 2, 2, 3)
    margs = torch_args(arrs, "meta")
    before = ops.fold_node_tables.launches
    with pytest.raises(ValueError, match="fold_node_tables: unsupported device"):
        ops.fold_node_tables(*margs, **kw)
    assert ops.fold_node_tables.launches == before


def _bad(case, targs, kw):
    time, cum, starts, t_lo, t_hi, qt = targs
    if case == "time-f32":
        return (time.float(), cum, starts, t_lo, t_hi, qt), kw
    if case == "starts-i32":
        return (time, cum, starts.int(), t_lo, t_hi, qt), kw
    if case == "cum-strided":
        wide = torch.cat([cum, cum], dim=2)
        return (time, wide[:, :, ::2], starts, t_lo, t_hi, qt), kw
    if case == "qt-width":
        return (time, cum, starts, t_lo, t_hi, torch.cat([qt, qt], dim=1)), kw
    if case == "lvl-ptr":
        return targs, dict(kw, lvl_ptr=kw["lvl_ptr"][:-1])
    return targs, dict(kw, out_dtype=torch.float16)


@pytest.mark.parametrize("case,exc,match", [
    ("time-f32", TypeError, "time_tab must be torch.float64"),
    ("starts-i32", TypeError, "starts must be torch.int64"),
    ("cum-strided", ValueError, "cum_tab must be contiguous"),
    ("qt-width", ValueError, "qt must have shape"),
    ("lvl-ptr", ValueError, "lvl_ptr"),
    ("out-f16", TypeError, "the table must be one of"),
])
def test_ops_fold_rejects_what_the_kernel_does_not_take(case, exc, match):
    arrs, kw = synth_forest(3, (4, 2), 2, 2, 3)
    targs, kw = _bad(case, torch_args(arrs), kw)
    with pytest.raises(exc, match=match):
        ops.fold_node_tables(*targs, **kw)


def test_fold_kernel_source():
    """The source says it replaces no TPU kernel and what bounds it, exports
    one C entry per fold dtype, agrees with the wrapper on the level limit,
    and names its kernel outside the benchmark's list of the port's
    hand-written kernels, whose device time tables.device_ms leaves out."""
    from tnkde_bench.harness.trace import PORT_KERNELS

    text = (_build.CSRC / "fold_tables.cu").read_text()
    assert "__global__" in text and "fold_tables_kernel" in text
    assert "replaces no TPU kernel" in text and "What bounds it on this card:" in text
    for suffix in ops.WALK_DTYPES.values():
        assert f"FOLD_ENTRY(fold_tables_{suffix}," in text
    assert f"MAX_LEVELS = {MAX_LEVELS};" in text
    assert not any(k in "fold_tables_kernel" for k in PORT_KERNELS)


# -------------------------------------------------------------------- card
def _held(got, k64, want64, want, dtype):
    """The kernel's table against the plain version's: float64 within
    KERNEL_TOL of max|F|; a narrow table equal to the plain version's cast,
    or one unit in its last place where the float64 tables differ."""
    if float((k64 - want64).abs().max()) > KERNEL_TOL * float(want64.abs().max()):
        return False
    if dtype is None:
        return True
    ulps = (got.view(NARROW[dtype]).int() - want.view(NARROW[dtype]).int()).abs()
    return bool(((ulps == 0) | ((ulps <= 1) & (k64 != want64))).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("counts,ks,kt,W", SWEEP)
def test_fold_kernel_matches_plain_version(card, counts, ks, kt, W, dtype):
    arrs, kw = synth_forest(sum(counts) * 7 + W, counts, ks, kt, W)
    targs = torch_args(arrs, card)
    before = ops.fold_node_tables.launches
    got = ops.fold_node_tables(*targs, **kw, out_dtype=dtype)
    torch.cuda.synchronize()
    assert ops.fold_node_tables.launches == before + 1
    k64 = ops.fold_node_tables(*targs, **kw)
    want64 = fold_node_tables_ref(*targs, **kw)
    want = fold_node_tables_ref(*targs, **kw, out_dtype=dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert _held(got, k64, want64, want, dtype)


@pytest.mark.cuda
def test_fold_kernel_at_berkeley_size(card):
    """The berkeley replica at full size (Table 3), W = 24 fresh centres: the
    engine's own fold (the kernel) against the plain version on the same
    tables, in all three fold dtypes."""
    from repro_torch.core import TNKDE
    from repro_torch.data.spatial import make_dataset

    net, ev, _ = make_dataset("berkeley", scale=1.0, seed=0)
    t0, span = float(ev.time.min()), float(ev.time.max() - ev.time.min())
    m = TNKDE(net, ev, g=50.0, b_s=800.0, b_t=0.2 * span, solution="rfs", engine="torch",
              executor="fused", device="cuda")
    fe, pk = m._fe, m._fe._packed
    ts = tuple(t0 + span * (0.02 + 0.04 * i) for i in range(24))
    wb = fe.window_batch(m.ctx, ts)
    args = (pk["pf"].pm_time, pk["pf"].pm_cum, pk["starts"], wb.t_lo, wb.t_hi, wb.qt)
    kw = dict(lvl_ptr=pk["lvl_ptr"], steps=pk["steps_per_level"], k_t=int(m.ctx.k_t))
    want64 = fold_node_tables_ref(*args, **kw)
    k64 = ops.fold_node_tables(*args, **kw)
    assert float(want64.abs().max()) > 0
    for dtype in (None, torch.float32, torch.bfloat16):
        got = ops.fold_node_tables(*args, **kw, out_dtype=dtype)
        want = want64 if dtype is None else want64.to(dtype)
        assert _held(got, k64, want64, want, dtype), dtype
        del got, want


@pytest.mark.cuda
@pytest.mark.parametrize("executor,shards", [("fused", 0), ("packed", 0), ("packed", 2)])
def test_fold_launches_once_a_fresh_window_batch(card, executor, shards):
    """An engine's fold is one launch a fresh ``ts`` tuple (one a shard when
    sharded), none on a cache hit, in ops' count, the engine's
    ``fold_launches`` counter and the answer's unchanged bits."""
    from repro_torch.core import TNKDE
    from repro_torch.core.distributed import ShardMesh
    from repro_torch.data.spatial import make_events, make_network

    net = make_network(60, 100, seed=13)
    ev = make_events(net, 800, seed=14, span_days=12)
    kw = dict(mesh=ShardMesh.on_one_device(shards, device="cuda")) if shards else {}
    m = TNKDE(net, ev, g=35.0, b_s=700.0, b_t=2.5 * 86400.0, solution="rfs", engine="torch",
              executor=executor, device="cuda", **kw)
    per_fold = max(shards, 1)
    ts_a, ts_b = [2 * 86400.0, 4 * 86400.0], [5.5 * 86400.0]
    l0, c0 = ops.fold_node_tables.launches, m._fe.counters["fold_launches"]
    F = m.query(ts_a)
    assert ops.fold_node_tables.launches - l0 == per_fold
    assert np.array_equal(m.query(ts_a), F)  # the cached table
    assert ops.fold_node_tables.launches - l0 == per_fold
    m.query(ts_b)
    assert ops.fold_node_tables.launches - l0 == 2 * per_fold
    assert m._fe.counters["fold_launches"] - c0 == 2 * per_fold
