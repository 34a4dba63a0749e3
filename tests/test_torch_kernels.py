"""Port kernels vs the JAX package's oracles, on the CPU.

``fused_walk_ref`` and ``fused_leaf_ref`` (the plain PyTorch versions the
CUDA kernels are held against on the card) must agree with BOTH
``repro.kernels.ref`` and the Pallas kernels in interpret mode, over the
shapes of the reference's own sweeps: float64, rtol 1e-12 (only the
association of ≤ 2·levels + k_s, resp. 2·k_s·k_t, addends differs). The CUDA
kernels themselves are compiled and compared on the GPU by ``chip_smoke.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.kernels import _build, ops
from repro_torch.kernels.fused_walk import MAX_LEVELS, fused_leaf_ref, fused_walk_ref

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
