"""Port kernels vs the JAX package's oracles, on the CPU.

``fused_walk_ref``, ``fused_leaf_ref``, ``tree_query_ref``,
``dyn_leaf_query_ref`` and ``dyn_node_walk_ref`` (the plain PyTorch versions
the CUDA kernels are held against on the card) must agree with BOTH
``repro.kernels.ref`` and the Pallas kernels in interpret mode (and
``tree_query_ref`` with a brute-force sum over the raw events), over the
shapes of the reference's own sweeps: float64, rtol 1e-12 (only the
association of the addends differs). The reference's own sweeps
(``tests/test_kernels_pallas.py``) are marked slow and deselected, so these
are the tier-1 guard of the oracles. The CUDA kernels themselves are
compiled and compared on the GPU by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import _build, ops
from repro_torch.kernels.dyn_query import dyn_leaf_query_ref, dyn_node_walk_ref, tree_offs
from repro_torch.kernels.fused_walk import MAX_LEVELS, fused_leaf_ref, fused_walk_ref
from repro_torch.kernels.tree_query import tree_buckets, tree_query_ref

LAYOUTS = [
    ("rfs4", 7, 1, 2), ("rfs8", 33, 2, 3), ("rfs16", 65, 3, 2),
    ("tree2", 7, 1, 2), ("tree3", 33, 2, 3), ("tree4", 65, 2, 2),
]


def _rfs_offs(npad):
    offs, acc = [], 0
    for lev in range(npad.bit_length()):
        offs.append(acc)
        acc += npad >> lev
    return tuple(offs), acc


def _case(layout, Q, W, ks, G=3):
    n = int(layout.lstrip("rfstre"))
    if layout.startswith("rfs"):
        offs, R = _rfs_offs(n)
        rank_hi = n
    else:  # complete tree of height hq=n
        offs = tuple((1 << (n - lev)) - 1 for lev in range(n + 1))
        R = (1 << (n + 1)) - 1
        rank_hi = 1 << n
    rng = np.random.default_rng(R * 100 + Q)
    nv = rng.normal(size=(G, R * 2, W * 2 * ks))
    r_lo = rng.integers(0, rank_hi + 1, (G, Q))
    r_hi = np.maximum(rng.integers(0, rank_hi + 1, (G, Q)), r_lo)
    side = rng.integers(0, 2, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    return (nv, r_lo, r_hi, side, qs), offs


def _torch_args(arrs):
    nv, r_lo, r_hi, side, qs = arrs
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)  # noqa: E731
    return torch.as_tensor(nv), i32(r_lo), i32(r_hi), i32(side), torch.as_tensor(qs)


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("layout,Q,W,ks", LAYOUTS)
def test_fused_walk_ref_matches_reference(layout, Q, W, ks, oracle):
    arrs, offs = _case(layout, Q, W, ks)
    got = fused_walk_ref(*_torch_args(arrs), offs=offs).numpy()
    with jax.enable_x64(True):
        jargs = [jnp.asarray(x) for x in arrs]
        if oracle == "ref":
            want = np.asarray(ref_oracle.fused_walk(*jargs, offs=offs))
        else:
            want = np.asarray(ref_ops.fused_walk(*jargs, offs=offs, tq=32))
    assert want.dtype == np.float64 and got.dtype == np.float64
    assert got.shape == want.shape == (3, W, Q)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_ops_fused_walk_cpu_uses_plain_version_and_counts_no_launch():
    arrs, offs = _case("rfs16", 65, 3, 2)
    targs = _torch_args(arrs)
    before = ops.fused_walk.launches
    got = ops.fused_walk(*targs, offs=offs)
    assert ops.fused_walk.launches == before  # only kernel launches count
    assert torch.equal(got, fused_walk_ref(*targs, offs=offs))


def test_ops_fused_walk_masked_atoms_and_window_independence():
    """Empty intervals with qs = 0 give exact zeros; two windows with the same
    node values give bitwise identical outputs."""
    (nv, r_lo, r_hi, side, qs), offs = _case("rfs16", 65, 1, 2)
    nv = np.concatenate([nv, nv], axis=-1)  # W=2, identical windows
    r_hi[:, ::3] = r_lo[:, ::3]
    qs[:, ::3] = 0.0
    out = ops.fused_walk(*_torch_args((nv, r_lo, r_hi, side, qs)), offs=offs)
    assert out.shape == (3, 2, 65)
    assert torch.equal(out[:, 0], out[:, 1])
    assert bool((out[:, :, ::3] == 0.0).all())
    assert bool((out != 0.0).any())


def test_ops_fused_walk_never_falls_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises — the
    plain version is never substituted (here: a device the kernel does not
    serve)."""
    arrs, offs = _case("rfs4", 7, 1, 2)
    margs = [t.to("meta") for t in _torch_args(arrs)]
    before = ops.fused_walk.launches
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_walk(*margs, offs=offs)
    assert ops.fused_walk.launches == before


def test_kernel_source_and_build_settings(monkeypatch, tmp_path):
    src = _build.CSRC / "fused_walk.cu"
    text = src.read_text()
    assert "__global__" in text and 'extern "C" int fused_walk_f64' in text
    assert f"MAX_LEVELS = {MAX_LEVELS}" in text  # wrapper and kernel agree
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    # the default build directory is the checkout's git-ignored build/
    assert _build.build_dir().parts[-2:] == ("build", "repro_torch")
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.build_dir() == tmp_path


# ---------------------------------------------------------------- fused_leaf
LEAF_CASES = [
    (4, 2, 2, 7, 1), (8, 3, 2, 33, 2), (16, 2, 3, 65, 2),  # the reference's sweep
    (16, 2, 2, 1, 3), (32, 3, 3, 130, 9),  # ragged Q below / above a block, W > 8
    (8, 11, 11, 17, 2),  # k_s = k_t = 11 (gaussian kernels): K = 121
]


def _leaf_case(nleaf, ks, kt, Q, W, G=3):
    rng = np.random.default_rng(nleaf * 100 + Q)
    R = (nleaf + 1) * 2
    tab = np.cumsum(rng.normal(size=(G, R, W * 2 * ks * kt)), axis=1)
    leaf_lo = rng.integers(0, nleaf + 1, (G, Q))
    leaf_hi = np.maximum(rng.integers(0, nleaf + 1, (G, Q)), leaf_lo)
    side = rng.integers(0, 2, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    qtl, qtr = rng.normal(size=(W, kt)), rng.normal(size=(W, kt))
    return tab, leaf_lo, leaf_hi, side, qs, qtl, qtr


def _leaf_torch(arrs):
    tab, lo, hi, side, qs, qtl, qtr = arrs
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)  # noqa: E731
    f64 = torch.as_tensor
    return f64(tab), i32(lo), i32(hi), i32(side), f64(qs), f64(qtl), f64(qtr)


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("nleaf,ks,kt,Q,W", LEAF_CASES)
def test_fused_leaf_ref_matches_reference(nleaf, ks, kt, Q, W, oracle):
    arrs = _leaf_case(nleaf, ks, kt, Q, W)
    got = fused_leaf_ref(*_leaf_torch(arrs)).numpy()
    with jax.enable_x64(True):
        jargs = [jnp.asarray(x) for x in arrs]
        if oracle == "ref":
            want = np.asarray(ref_oracle.fused_leaf(*jargs))
        else:
            want = np.asarray(ref_ops.fused_leaf(*jargs, tq=32))
    assert want.dtype == np.float64 and got.dtype == np.float64
    assert got.shape == want.shape == (3, W, Q)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_ops_fused_leaf_cpu_uses_plain_version_and_counts_no_launch():
    targs = _leaf_torch(_leaf_case(16, 2, 3, 65, 2))
    before = ops.fused_leaf.launches
    got = ops.fused_leaf(*targs)
    assert ops.fused_leaf.launches == before  # only kernel launches count
    assert torch.equal(got, fused_leaf_ref(*targs))


def test_ops_fused_leaf_empty_ranges_and_window_independence():
    """Empty leaf ranges give exact zeros; two windows with the same prefix
    rows and temporal vectors give bitwise identical outputs."""
    tab, lo, hi, side, qs, qtl, qtr = _leaf_case(8, 2, 2, 33, 1)
    G, R, _ = tab.shape
    tab = np.concatenate([tab.reshape(G, R, 1, -1)] * 2, axis=2).reshape(G, R, -1)  # W=2
    qtl, qtr = np.concatenate([qtl, qtl]), np.concatenate([qtr, qtr])
    hi[:, ::3] = lo[:, ::3]
    out = ops.fused_leaf(*_leaf_torch((tab, lo, hi, side, qs, qtl, qtr)))
    assert out.shape == (3, 2, 33)
    assert torch.equal(out[:, 0], out[:, 1])
    assert bool((out[:, :, ::3] == 0.0).all())
    assert bool((out != 0.0).any())


def test_ops_fused_leaf_never_falls_back_off_cpu():
    """A tensor that is not on the CPU goes to the kernel or raises."""
    margs = [t.to("meta") for t in _leaf_torch(_leaf_case(4, 2, 2, 7, 1))]
    before = ops.fused_leaf.launches
    with pytest.raises(ValueError, match="unsupported device"):
        ops.fused_leaf(*margs)
    assert ops.fused_leaf.launches == before


def test_fused_leaf_kernel_source():
    text = (_build.CSRC / "fused_leaf.cu").read_text()
    assert "__global__" in text and 'extern "C" int fused_leaf_f64' in text
    assert f"SMEM_MAX = {ops.LEAF_SMEM_MAX // 1024} * 1024" in text  # wrapper and kernel agree
    assert "fused_leaf_pallas" in text  # names the TPU kernel it replaces


# ---------------------------------------------------------------- tree_query
def _tree_forest(rng, G, n_events, K4, empty_group=None):
    """Time-major merge-tree tables built as the reference's kernel tests
    build them (tests/test_kernels_pallas.py): level ℓ buckets 2^ℓ
    consecutive time ranks, position-sorted inside with +inf padding at the
    end, inclusive prefix moments. ``empty_group`` holds no events at all:
    its rows are all +inf and its moments zero."""
    from repro_torch.core.aggregation import next_pow2, segmented_cumsum

    npad = next_pow2(n_events)
    lvl = npad.bit_length()
    pos = np.full((G, lvl, npad), np.inf)
    cum = np.zeros((G, lvl, npad, K4))
    raw = []
    for g in range(G):
        n = 0 if g == empty_group else n_events
        p = rng.uniform(0, 100, n)
        f = rng.normal(size=(n, K4))
        raw.append((p, f))
        pp = np.full(npad, np.inf)
        pp[:n] = p
        ff = np.zeros((npad, K4))
        ff[:n] = f
        ranks = np.arange(npad)
        for lev in range(lvl):
            order = np.lexsort((pp, ranks >> lev))
            pos[g, lev] = pp[order]
            cum[g, lev] = segmented_cumsum(ff[order], np.arange(0, npad + 1, 1 << lev))
    return pos, cum, raw


TREE_CASES = [  # (n_events, k_s, k_t, Q, Wh, empty_group): ragged Q, Wh > 8 half-windows
    (5, 1, 1, 7, 1, None), (16, 1, 1, 33, 3, None), (21, 2, 1, 130, 2, None),
    (9, 2, 1, 65, 10, 1),  # one group of all-+inf padding
    (12, 11, 2, 17, 2, None),  # 4·k_s·k_t = 88: the gaussian × triangular kernels
]


def _tree_case(n_events, ks, kt, Q, Wh, empty_group, G=3):
    """One seeded case in both forms. ``new``: the kernel's inputs over a
    flat forest made by concatenating the per-group tables (``base =
    g·LVL·NPAD``), per-edge rank intervals [G, Wh] and the factors of the
    query vector. ``old``: the reference's inputs — per-group tables, rank
    intervals broadcast to [G, Wh, Q] and the one-hot ``q_vec [G, Wh, Q, 4K]``
    materialised from the same factors."""
    K = ks * kt
    rng = np.random.default_rng(n_events * 31 + Q)
    pos, cum, raw = _tree_forest(rng, G, n_events, 4 * K, empty_group)
    npad, lvl = pos.shape[2], pos.shape[1]
    r_lo = rng.integers(0, n_events, (G, Wh))
    r_hi = np.maximum(rng.integers(0, n_events + 1, (G, Wh)), r_lo)
    ph = rng.uniform(0, 110, (G, Q))
    pl1 = rng.uniform(-10, 100, (G, Q))
    l1r = (rng.random((G, Q)) < 0.5).astype(np.int32)
    pl2 = rng.uniform(-10, 60, (G, Q))
    qs = rng.normal(size=(G, Q, ks))
    # padding slots of the grouped layout: bounds that select nothing, qs zero
    ph[:, ::5], pl1[:, ::5], pl2[:, ::5], qs[:, ::5] = -np.inf, np.inf, np.inf, 0.0
    qt = rng.normal(size=(Wh, kt))
    side = rng.integers(0, 2, (G, Q)).astype(np.int32)
    half = (np.arange(Wh) % 2).astype(np.int32)
    new = (pos.reshape(-1), cum.reshape(-1, 4 * K), np.arange(G) * lvl * npad, r_lo, r_hi,
           ph, pl1, l1r, pl2, qs, qt, side, half)
    qfull = (qs[:, None, :, :, None] * qt[None, :, None, None, :]).reshape(G, Wh, Q, K)
    combo = side[:, None, :] * 2 + half[None, :, None]  # [G, Wh, Q]
    q_vec = np.zeros((G, Wh, Q, 4, K))
    for c in range(4):
        q_vec[:, :, :, c] = np.where((combo == c)[..., None], qfull, 0.0)
    b3 = lambda x: np.broadcast_to(x[:, :, None], (G, Wh, Q)).copy()  # noqa: E731
    old = (pos, cum, b3(r_lo), b3(r_hi), ph, pl1, l1r, pl2, q_vec.reshape(G, Wh, Q, 4 * K))
    return new, int(npad), old, raw


def _tree_torch(new):
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)  # noqa: E731
    f64 = torch.as_tensor
    pf, cf, base, r_lo, r_hi, ph, pl1, l1r, pl2, qs, qt, side, half = new
    return (f64(pf), f64(cf), torch.as_tensor(base).to(torch.int64), i32(r_lo), i32(r_hi),
            f64(ph), f64(pl1), i32(l1r), f64(pl2), f64(qs), f64(qt), i32(side), i32(half))


def _tree_query_qvec_form(pos, cum, r_lo, r_hi, ph, pl1, l1r, pl2, q_vec):
    """The composition the kernel executor ran before the kernel built its
    query vectors: per-group table copies, [G, Wh, Q] rank intervals and a
    materialised one-hot q_vec, summed over all 4K columns in order."""
    NPAD, K4 = pos.shape[2], cum.shape[-1]
    acc = torch.zeros(r_lo.numel(), dtype=cum.dtype)
    q_flat = q_vec.reshape(-1, K4)
    for lev, lane, g, seg_lo, i_lo, i_hi in tree_buckets(pos, r_lo, r_hi, ph, pl1, l1r, pl2):
        c = cum[:, lev]

        def pref(i):
            rows = c[g, (i - 1).clamp(0, NPAD - 1)]
            return torch.where((i > seg_lo)[:, None], rows, 0.0)

        mom = (pref(i_hi) - pref(i_lo)).T.contiguous()
        qv = q_flat[lane].T.contiguous()
        d = qv[0] * mom[0]
        for k in range(1, K4):
            d = d + qv[k] * mom[k]
        acc[lane] = acc[lane] + d
    return acc.reshape(r_lo.shape)


def _tree_bruteforce(old, raw):
    """The range query over the raw events, no tree: Σ over events with a
    time rank in [r_lo, r_hi) and a position inside the bounds of f·q_vec."""
    _, _, r_lo, r_hi, ph, pl1, l1r, pl2, qv = old
    G, Wh, Q = r_lo.shape
    want = np.zeros((G, Wh, Q))
    for g in range(G):
        p, f = raw[g]
        rank = np.arange(len(p))
        for w in range(Wh):
            for q in range(Q):
                lo1_ok = (p > pl1[g, q]) if l1r[g, q] else (p >= pl1[g, q])
                m = ((rank >= r_lo[g, w, q]) & (rank < r_hi[g, w, q]) & (p <= ph[g, q])
                     & lo1_ok & (p >= pl2[g, q]))
                want[g, w, q] = f[m].sum(axis=0) @ qv[g, w, q]
    return want


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret", "bruteforce"])
@pytest.mark.parametrize("n_events,ks,kt,Q,Wh,empty_group", TREE_CASES)
def test_tree_query_ref_matches_reference(n_events, ks, kt, Q, Wh, empty_group, oracle):
    """Tolerance 1e-12 relative to max|want|: float64 on every side; only the
    association of ≤ 2·levels buckets of K4 products differs. The reference
    takes the old form (table copies, materialised q_vec) of the same case."""
    from repro.kernels.tree_query import tree_query_pallas

    new, npad, old, raw = _tree_case(n_events, ks, kt, Q, Wh, empty_group)
    got = tree_query_ref(*_tree_torch(new), npad=npad).numpy().transpose(0, 2, 1)
    if oracle == "bruteforce":
        want = _tree_bruteforce(old, raw)
    else:
        with jax.enable_x64(True):
            jargs = [jnp.asarray(x) for x in old]
            if oracle == "ref":
                want = np.asarray(ref_oracle.tree_query(*jargs))
            else:
                want = np.asarray(tree_query_pallas(*jargs, tq=32, interpret=True, precise=True))
    assert want.dtype == np.float64 and got.dtype == np.float64
    assert got.shape == want.shape == (3, Wh, Q)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    if empty_group is not None:
        assert not got[empty_group].any()  # no events: exact zeros


@pytest.mark.parametrize("n_events,ks,kt,Q,Wh,empty_group", TREE_CASES)
def test_tree_query_ref_matches_qvec_form(n_events, ks, kt, Q, Wh, empty_group):
    """The query vector built from qs·qt over the slot's combo columns gives
    the materialised one-hot q_vec's answer: the other combos only add ±0,
    so the two agree to 1e-15 of max|out| (bit for bit up to zero signs)."""
    new, npad, old, _ = _tree_case(n_events, ks, kt, Q, Wh, empty_group)
    got = tree_query_ref(*_tree_torch(new), npad=npad).permute(0, 2, 1)
    to = lambda x, i: torch.as_tensor(x).to(torch.int32 if i else torch.float64)  # noqa: E731
    want = _tree_query_qvec_form(*(to(x, i in (2, 3, 6)) for i, x in enumerate(old)))
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-15 * float(want.abs().max())


def test_ops_tree_query_cpu_uses_plain_version_and_counts_no_launch():
    new, npad, _, _ = _tree_case(16, 1, 1, 33, 3, None)
    targs = _tree_torch(new)
    before = ops.tree_query.launches
    got = ops.tree_query(*targs, npad=npad)
    assert ops.tree_query.launches == before  # only kernel launches count
    assert torch.equal(got, tree_query_ref(*targs, npad=npad))


@pytest.mark.parametrize("npad,k4,staged", [
    (32, 16, True),  # the berkeley ×1.0 timed entry: 6·32·17·8 = 26 112 bytes
    (64, 16, True),  # 7·64·17·8 = 60 928 bytes, the largest staged at K4 = 16
    (128, 16, False),  # 8·128·17·8 = 139 264 bytes
    (32, 484, False),  # the gaussian kernels' 4K
    (0, 16, True),  # an edge with no events stages nothing
])
def test_ops_tree_staged_rule(npad, k4, staged):
    """The one rule for staging an edge block in shared memory: its bytes,
    LVL·NPAD·(1 + 4K)·8, at most ops.TREE_STAGE_MAX."""
    nbytes = int(npad).bit_length() * npad * (1 + k4) * 8
    assert (nbytes <= ops.TREE_STAGE_MAX) == staged
    assert ops.tree_staged(npad, k4) is staged


def test_ops_tree_query_window_independence():
    """Two half-windows with the same rank intervals, half and q_t give
    bitwise identical outputs; slots whose bounds select nothing give exact
    zeros."""
    new, npad, _, _ = _tree_case(21, 2, 1, 130, 1, None)
    pf, cf, base, r_lo, r_hi, ph, pl1, l1r, pl2, qs, qt, side, half = new
    dup = lambda x, axis: np.concatenate([x, x], axis=axis)  # noqa: E731
    out = ops.tree_query(*_tree_torch((pf, cf, base, dup(r_lo, 1), dup(r_hi, 1), ph, pl1, l1r,
                                       pl2, qs, dup(qt, 0), side, dup(half, 0))), npad=npad)
    assert out.shape == (3, 130, 2)
    assert torch.equal(out[:, :, 0], out[:, :, 1])
    assert bool((out[:, ::5] == 0.0).all())
    assert bool((out != 0.0).any())


# ------------------------------------------------------- dyn_leaf_query / walk
DYN_LEAF_CASES = [
    (4, 2, 7, 1), (8, 4, 33, 3), (16, 3, 65, 2),  # the reference's sweep
    (32, 4, 130, 9),  # ragged Q above a block, W > 8
    (8, 121, 17, 2),  # K = k_s·k_t of the gaussian kernels
]


def _dyn_leaf_case(nleaf, K, Q, W, G=3):
    rng = np.random.default_rng(nleaf * 100 + Q)
    R = (nleaf + 1) * 2
    tab = np.cumsum(rng.normal(size=(G, R, W * 2 * K)), axis=1)
    leaf_lo = rng.integers(0, nleaf + 1, (G, Q))
    leaf_hi = np.maximum(rng.integers(0, nleaf + 1, (G, Q)), leaf_lo)
    side = rng.integers(0, 2, (G, Q))
    qv_l, qv_r = rng.normal(size=(G, W, Q, K)), rng.normal(size=(G, W, Q, K))
    return tab, leaf_lo, leaf_hi, side, qv_l, qv_r


def _dyn_leaf_torch(arrs):
    tab, lo, hi, side, qv_l, qv_r = arrs
    i32 = lambda x: torch.as_tensor(x).to(torch.int32)  # noqa: E731
    f64 = torch.as_tensor
    return f64(tab), i32(lo), i32(hi), i32(side), f64(qv_l), f64(qv_r)


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("nleaf,K,Q,W", DYN_LEAF_CASES)
def test_dyn_leaf_query_ref_matches_reference(nleaf, K, Q, W, oracle):
    """Tolerance 1e-12 relative to max|want| (float64, 2·K products per
    output; only their association differs)."""
    from repro.kernels.dyn_query import dyn_leaf_query_pallas

    arrs = _dyn_leaf_case(nleaf, K, Q, W)
    got = dyn_leaf_query_ref(*_dyn_leaf_torch(arrs)).numpy()
    with jax.enable_x64(True):
        jargs = [jnp.asarray(x) for x in arrs]
        if oracle == "ref":
            want = np.asarray(ref_oracle.dyn_leaf_query(*jargs))
        else:
            want = np.asarray(dyn_leaf_query_pallas(*jargs, tq=32, interpret=True))
    assert want.dtype == np.float64 and got.dtype == np.float64
    assert got.shape == want.shape == (3, W, Q)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("hq,ks,Q,W", [(2, 2, 7, 1), (3, 3, 33, 2), (4, 2, 65, 3)])
def test_dyn_node_walk_ref_matches_reference(hq, ks, Q, W, oracle):
    """Tolerance 1e-12 relative to max|want| (float64, ≤ 2·(hq+1) rows and
    k_s products per output; only their association differs)."""
    from repro.kernels.dyn_query import dyn_node_walk_pallas

    arrs, offs = _case(f"tree{hq}", Q, W, ks)
    assert offs == tree_offs(hq)
    got = dyn_node_walk_ref(*_torch_args(arrs), hq=hq).numpy()
    with jax.enable_x64(True):
        jargs = [jnp.asarray(x) for x in arrs]
        if oracle == "ref":
            want = np.asarray(ref_oracle.dyn_node_walk(*jargs, hq=hq))
        else:
            want = np.asarray(dyn_node_walk_pallas(*jargs, hq=hq, tq=32, interpret=True))
    assert want.dtype == np.float64 and got.dtype == np.float64
    assert got.shape == want.shape == (3, W, Q)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())


def test_ops_dyn_wrappers_cpu_use_plain_versions_and_count_no_launch():
    targs = _dyn_leaf_torch(_dyn_leaf_case(8, 4, 33, 3))
    wargs = _torch_args(_case("tree3", 33, 2, 3)[0])
    before = (ops.dyn_leaf_query.launches, ops.dyn_node_walk.launches, ops.fused_walk.launches)
    assert torch.equal(ops.dyn_leaf_query(*targs), dyn_leaf_query_ref(*targs))
    assert torch.equal(ops.dyn_node_walk(*wargs, hq=3), dyn_node_walk_ref(*wargs, hq=3))
    after = (ops.dyn_leaf_query.launches, ops.dyn_node_walk.launches, ops.fused_walk.launches)
    assert after == before  # only kernel launches count


def test_ops_dyn_leaf_query_window_independence():
    """Two windows with the same rows and query vectors give bitwise identical
    outputs; empty leaf ranges give exact zeros."""
    tab, lo, hi, side, qv_l, qv_r = _dyn_leaf_case(8, 4, 33, 1)
    G, R, _ = tab.shape
    tab = np.concatenate([tab.reshape(G, R, 1, -1)] * 2, axis=2).reshape(G, R, -1)  # W=2
    qv_l, qv_r = np.concatenate([qv_l, qv_l], axis=1), np.concatenate([qv_r, qv_r], axis=1)
    hi[:, ::3] = lo[:, ::3]
    out = ops.dyn_leaf_query(*_dyn_leaf_torch((tab, lo, hi, side, qv_l, qv_r)))
    assert out.shape == (3, 2, 33)
    assert torch.equal(out[:, 0], out[:, 1])
    assert bool((out[:, :, ::3] == 0.0).all())
    assert bool((out != 0.0).any())


@pytest.mark.parametrize("name", ["tree_query", "dyn_leaf_query", "dyn_node_walk"])
def test_ops_new_wrappers_never_fall_back_off_cpu(name):
    """A tensor that is not on the CPU goes to the kernel or raises — the
    plain version is never substituted (here: a device no kernel serves)."""
    args = {
        "tree_query": lambda: _tree_torch(_tree_case(5, 1, 1, 7, 1, None)[0]),
        "dyn_leaf_query": lambda: _dyn_leaf_torch(_dyn_leaf_case(4, 2, 7, 1)),
        "dyn_node_walk": lambda: _torch_args(_case("tree2", 7, 1, 2)[0]),
    }[name]()
    kw = dict(hq=2) if name == "dyn_node_walk" else dict(npad=8) if name == "tree_query" else {}
    wrapper = getattr(ops, name)
    before = (wrapper.launches, ops.fused_walk.launches)
    with pytest.raises(ValueError, match=f"{name}: unsupported device"):
        wrapper(*[t.to("meta") for t in args], **kw)
    assert (wrapper.launches, ops.fused_walk.launches) == before


def test_new_kernel_sources():
    """Each new source names the TPU kernel it replaces and exports its C
    entry point; dyn_node_walk has no source of its own (it launches
    fused_walk.cu)."""
    for name, pallas in (("tree_query", "tree_query_pallas"),
                         ("dyn_leaf_query", "dyn_leaf_query_pallas")):
        text = (_build.CSRC / f"{name}.cu").read_text()
        assert "__global__" in text and f'extern "C" int {name}_f64' in text
        assert pallas in text
    assert not (_build.CSRC / "dyn_node_walk.cu").exists()
