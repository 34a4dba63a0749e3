"""Plain exact TN-KDE at chosen lixels: the yardstick of ``correct``.

Independent of the program: it imports neither the JAX package nor the
PyTorch port, and takes only the network, the events and the query
parameters the harness made from the seed. It works out the lixels and the
network distances itself (scipy's Dijkstra) and sums every event in range
directly, with no index, no moments and no decomposition:

    F(q, t) = sum over events p with d(q, p) <= b_s and |t - t_p| <= b_t of
              K_s(d(q, p) / b_s) * K_t(|t - t_p| / b_t)

with the triangular kernel K(u) = 1 - u on [0, 1]. Distances follow the
paper's convention (Def. 3.4, §3.2): a lixel is the centre point of a
segment of length g along its edge (the last segment of an edge may be
shorter); an event on the lixel's own edge is |x_q - x_p| away; any other
event on edge (c, d) is min(d(q, c) + x_p, d(q, d) + len - x_p), where
d(q, v) = min(x_q + d(a, v), len_a - x_q + d(b, v)) over the lixel's edge
(a, b). Everything is float64.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse
import scipy.sparse.csgraph

__all__ = ["lixel_geometry", "exact_heat"]

KERNELS = ("triangular",)


def lixel_geometry(edge_len: np.ndarray, g: float):
    """(edge of each lixel, its centre's distance from the edge's src), in
    edge order and ascending position along each edge."""
    counts = np.ceil(edge_len / g).astype(np.int64)
    edge = np.repeat(np.arange(edge_len.shape[0], dtype=np.int64), counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    start = (np.arange(edge.shape[0], dtype=np.int64) - first) * g
    end = np.minimum(start + g, edge_len[edge])
    return edge, (start + end) / 2.0


def _graph(n_vertices, src, dst, length):
    """Symmetric CSR adjacency keeping the shortest of parallel edges (a
    plain sparse constructor would add them up)."""
    u = np.concatenate([src, dst]).astype(np.int64)
    v = np.concatenate([dst, src]).astype(np.int64)
    w = np.concatenate([length, length])
    key = u * n_vertices + v
    order = np.lexsort((w, key))
    key, w = key[order], w[order]
    first = np.ones(key.shape[0], bool)
    first[1:] = key[1:] != key[:-1]
    key, w = key[first], w[first]
    return scipy.sparse.csr_matrix((w, (key // n_vertices, key % n_vertices)),
                                   shape=(n_vertices, n_vertices))


def _pairs(ds, g, b_s, lixels):
    """For each requested lixel, every event within b_s of it on the network:
    (row in ``lixels``, event id, spatial kernel weight)."""
    src = ds.edge_src.astype(np.int64)
    dst = ds.edge_dst.astype(np.int64)
    length = ds.edge_len
    lix_edge, lix_pos = lixel_geometry(length, g)
    lixels = np.asarray(lixels, np.int64)
    a = lix_edge[lixels]
    xq = lix_pos[lixels]
    ends = np.unique(np.concatenate([src[a], dst[a]]))
    dist = scipy.sparse.csgraph.dijkstra(
        _graph(ds.n_vertices, src, dst, length), directed=False, indices=ends,
        limit=b_s + float(length.max()) + 1.0)
    row_of = {int(v): i for i, v in enumerate(ends)}
    order = np.argsort(ds.ev_edge, kind="stable")
    ptr = np.zeros(ds.n_edges + 1, np.int64)
    np.cumsum(np.bincount(ds.ev_edge, minlength=ds.n_edges), out=ptr[1:])
    rows, evs, ws = [], [], []
    for i, (e, x) in enumerate(zip(a, xq)):
        dv = np.minimum(x + dist[row_of[int(src[e])]],
                        length[e] - x + dist[row_of[int(dst[e])]])
        near = np.minimum(dv[src], dv[dst]) <= b_s
        near[e] = False
        cand = np.flatnonzero(near)
        cnt = ptr[cand + 1] - ptr[cand]
        ev = order[np.repeat(ptr[cand], cnt) + (np.arange(cnt.sum()) - np.repeat(
            np.cumsum(cnt) - cnt, cnt))]
        ce = np.repeat(cand, cnt)
        p = ds.ev_pos[ev]
        d = np.minimum(dv[src[ce]] + p, dv[dst[ce]] + length[ce] - p)
        own = order[ptr[e]:ptr[e + 1]]
        ev = np.concatenate([ev, own])
        d = np.concatenate([d, np.abs(x - ds.ev_pos[own])])
        keep = d <= b_s
        rows.append(np.full(int(keep.sum()), i, np.int64))
        evs.append(ev[keep])
        ws.append(1.0 - d[keep] / b_s)
    return np.concatenate(rows), np.concatenate(evs), np.concatenate(ws)


def exact_heat(ds, *, g: float, b_s: float, b_t: float, lixels, ts,
               spatial_kernel: str = "triangular", temporal_kernel: str = "triangular",
               device="cpu", chunk: int = 1 << 24):
    """Exact TN-KDE: ``[len(lixels), len(ts)]`` float64 (a NumPy array).

    The spatial pairs are found on the host; the temporal sums run in torch
    on ``device`` in chunks of at most ``chunk`` (pair, window) products.
    """
    import torch

    if spatial_kernel not in KERNELS or temporal_kernel not in KERNELS:
        raise ValueError(f"the reference has the kernels {KERNELS}")
    rows, evs, ws = _pairs(ds, g, b_s, lixels)
    ts = np.asarray(ts, np.float64)
    dev = torch.device(device)
    out = torch.zeros((len(lixels), ts.shape[0]), dtype=torch.float64, device=dev)
    t = torch.as_tensor(ts, device=dev)
    step = max(chunk // max(ts.shape[0], 1), 1)
    for lo in range(0, rows.shape[0], step):
        r = torch.as_tensor(rows[lo:lo + step], device=dev)
        te = torch.as_tensor(ds.ev_time[evs[lo:lo + step]], device=dev)
        w = torch.as_tensor(ws[lo:lo + step], device=dev)
        kt = (1.0 - (t[None, :] - te[:, None]).abs() / b_t).clamp_min(0.0)
        out.index_add_(0, r, kt * w[:, None])
    return out.cpu().numpy()
