"""The port's device shortest paths vs the JAX package, on the CPU.

``minplus_matmul_ref`` (the plain version the CUDA ``minplus`` kernel is
held against on the card) must equal ``repro.kernels.ref.minplus_matmul``
and the Pallas kernel in interpret mode BITWISE over the shapes of the
reference's own sweep, float32 and float64, with +inf entries: every output
is one rounding (a + b) followed by exact minima, so no order can differ.
``minplus_bellman_ford`` must equal the reference's bitwise and bounded
Dijkstra to 1e-12. The CUDA kernel itself is compiled and compared on the
GPU by ``chip_smoke.py`` (``[minplus-kernels]``, ``[minplus]``).
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shortest_path as ref_sp
from repro.data.spatial import make_network as ref_make_network
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro_torch.core import shortest_path as sp
from repro_torch.data.spatial import make_network
from repro_torch.kernels import minplus, ops

SHAPES = [(4, 4, 4), (16, 32, 8), (65, 33, 17), (128, 128, 128)]
DTYPES = {"float32": (np.float32, torch.float32), "float64": (np.float64, torch.float64)}


def _chip_smoke():
    """``chip_smoke.py`` at the root of the repo, as a module."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _case(m, k, n, np_dt):
    """The reference sweep's inputs (tests/test_kernels_pallas.py), plus +inf
    in a row and a column of each operand."""
    rng = np.random.default_rng(m * 1000 + n)
    a = rng.uniform(0, 10, (m, k)).astype(np_dt)
    b = rng.uniform(0, 10, (k, n)).astype(np_dt)
    a[rng.integers(0, m), rng.integers(0, k)] = np.inf
    a[rng.integers(0, m), :] = np.inf
    b[:, rng.integers(0, n)] = np.inf
    b[rng.integers(0, k), rng.integers(0, n)] = np.inf
    return a, b


@pytest.mark.parametrize("oracle", ["ref", "pallas_interpret", "port_ops"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_minplus_ref_bitwise(m, k, n, dtype, oracle):
    np_dt, t_dt = DTYPES[dtype]
    a, b = _case(m, k, n, np_dt)
    got = minplus.minplus_matmul_ref(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    if oracle == "port_ops":  # the wrapper on CPU tensors: the plain version, no launch
        n0 = ops.minplus_matmul.launches
        want = ops.minplus_matmul(torch.as_tensor(a), torch.as_tensor(b)).numpy()
        assert ops.minplus_matmul.launches == n0
    else:
        with jax.enable_x64(True):
            ja, jb = jnp.asarray(a), jnp.asarray(b)
            if oracle == "ref":
                want = np.asarray(ref_oracle.minplus_matmul(ja, jb))
            else:
                want = np.asarray(ref_ops.minplus_matmul(ja, jb, tm=32, tn=32, tk=32))
    assert got.dtype == want.dtype == np_dt and got.shape == want.shape == (m, n)
    assert np.isinf(got).any()
    np.testing.assert_array_equal(got, want)


def test_minplus_ref_chunks_rows(monkeypatch):
    """The plain version works through the rows in chunks so a berkeley-size
    product never holds M·K·N candidates; chunking changes nothing."""
    a, b = _case(65, 33, 17, np.float64)
    whole = minplus.minplus_matmul_ref(torch.as_tensor(a), torch.as_tensor(b))
    monkeypatch.setattr(minplus, "REF_CHUNK_ELEMS", 33 * 17 * 4)  # 4 rows a chunk
    out = torch.full((65, 17), -1.0, dtype=torch.float64)
    got = ops.minplus_matmul(torch.as_tensor(a), torch.as_tensor(b), out=out)
    assert got is out
    assert torch.equal(got, whole)


def test_minplus_empty_inner_dimension():
    """K = 0: the minimum of nothing is +inf (the Pallas kernel pads K to one
    +inf column)."""
    a, b = torch.zeros((3, 0), dtype=torch.float64), torch.zeros((0, 4), dtype=torch.float64)
    assert torch.equal(ops.minplus_matmul(a, b), torch.full((3, 4), float("inf"),
                                                            dtype=torch.float64))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bellman_ford_matches_reference_and_dijkstra(dtype):
    """The reference's own world (make_network(30, 50, seed=7), sources 0, 3,
    11, rounds = V): bitwise equal to the reference's minplus_bellman_ford
    with and without Pallas; in f64 within 1e-12 of bounded Dijkstra."""
    np_dt, t_dt = DTYPES[dtype]
    net, rnet = make_network(30, 50, seed=7), ref_make_network(30, 50, seed=7)
    adj = net.dense_adjacency()
    np.testing.assert_array_equal(adj, rnet.dense_adjacency())
    src = np.array([0, 3, 11])
    init = np.full((3, net.n_vertices), np.inf)
    init[np.arange(3), src] = 0.0
    adj_t, init_t = torch.as_tensor(adj.astype(np_dt)), torch.as_tensor(init.astype(np_dt))
    got = sp.minplus_bellman_ford(adj_t, init_t, rounds=net.n_vertices)
    assert torch.equal(init_t, torch.as_tensor(init.astype(np_dt)))  # input untouched
    assert got.dtype == t_dt
    with jax.enable_x64(True):
        for use_pallas in (False, True):
            want = ref_sp.minplus_bellman_ford(
                jnp.asarray(adj.astype(np_dt)), jnp.asarray(init.astype(np_dt)),
                rounds=net.n_vertices, use_pallas=use_pallas)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    d_ref = sp.bounded_dijkstra(net, src, 1e18, adj=sp.adjacency_csr(net))
    if dtype == "float64":
        np.testing.assert_allclose(got.numpy(), d_ref, rtol=1e-12, atol=0)
    else:
        np.testing.assert_allclose(got.numpy(), d_ref, rtol=1e-5)


def test_bellman_ford_bounded_rounds():
    """With rounds = the largest hop depth of the bounded Dijkstra trees, the
    relaxation is exact within the radius and > radius wherever Dijkstra
    stops (the [minplus] phase of chip_smoke.py, with its ``hop_depth``, on a
    small network)."""
    import scipy.sparse.csgraph as csgraph

    net = make_network(60, 100, seed=13)
    radius = 0.5 * float(net.edge_len.sum()) / 10
    V = net.n_vertices
    dist, pred = csgraph.dijkstra(sp.adjacency_csr(net), directed=False, indices=np.arange(V),
                                  limit=radius, return_predecessors=True)
    rounds = int(_chip_smoke().hop_depth(pred).max())
    assert 1 < rounds < V
    init = np.full((V, V), np.inf)
    np.fill_diagonal(init, 0.0)
    got = sp.minplus_bellman_ford(torch.as_tensor(net.dense_adjacency()), torch.as_tensor(init),
                                  rounds).numpy()
    within = np.isfinite(dist)
    np.testing.assert_allclose(got[within], dist[within], rtol=1e-12, atol=0)
    assert (got[~within] > radius).all()
    np.testing.assert_array_equal(dist, sp.endpoint_distance_rows(net, radius))
    short = sp.minplus_bellman_ford(torch.as_tensor(net.dense_adjacency()),
                                    torch.as_tensor(init), rounds - 1).numpy()
    assert (short[within] > dist[within] * (1 + 1e-12)).any()  # one round fewer is not enough


def test_bellman_ford_takes_tensors():
    with pytest.raises(TypeError):
        sp.minplus_bellman_ford(np.zeros((2, 2)), np.zeros((1, 2)), 1)


def test_minplus_kernel_source_agrees_with_the_wrapper():
    """``minplus.TILE`` is the tile the source compiles (TM rows for each of
    TY = 8 threads, TN columns for each of TX = 8, BK), the source names the
    TPU kernel it replaces and exports the entry points the binding
    declares, and no preprocessor knob can change the build."""
    import re

    text = (Path(minplus.__file__).parent / "csrc" / "minplus.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    ty, tx = (int(v) for v in re.search(r"constexpr int TY = (\d+), TX = (\d+);", text).groups())
    assert minplus.TILE == (ty * const("TM"), tx * const("TN"), const("BK"))
    assert "minplus_matmul_pallas" in text
    for name in ("minplus_f32", "minplus_f64", "minplus_occupancy"):
        assert f'extern "C" int {name}(' in text
    assert not re.search(r"#\s*(ifndef|ifdef|if)\b", text)


@pytest.mark.parametrize("dtype,K,N,offset,vec", [
    (torch.float64, 1576, 1576, 0, True),   # the berkeley product
    (torch.float64, 6, 130, 0, True),       # K below BK, multiples of 2 doubles
    (torch.float64, 7, 130, 0, False),      # odd K: rows of a 8 bytes off 16
    (torch.float64, 6, 129, 0, False),      # odd N: rows of b likewise
    (torch.float64, 6, 130, 1, False),      # a misaligned base
    (torch.float32, 8, 64, 0, True),
    (torch.float32, 6, 64, 0, False),       # K not a multiple of 4 floats
    (torch.float32, 8, 62, 0, False),
])
def test_minplus_vec_rule(dtype, K, N, offset, vec):
    """The kernel stages with 16-byte copies only where every copy of a row
    of a or b is 16-byte aligned and wholly in or out of range."""
    a = torch.zeros(3 * K + offset, dtype=dtype)[offset:].reshape(3, K)
    b = torch.zeros((K, N), dtype=dtype)
    assert minplus.minplus_vec(a, b) is vec
