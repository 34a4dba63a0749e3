"""Shortest-path substrate (paper: Dijkstra + Shortest Path Sharing, §3.2).

``bounded_dijkstra`` — exact bounded-radius Dijkstra via scipy's C
implementation (the host planning engine; the paper uses binary-heap
Dijkstra per edge endpoint). The batched min-plus relaxation on the device
is not part of this package yet (ROADMAP.md, Queue A9).

Shortest Path Sharing (SPS): all lixels on a query edge (v_a, v_b) reuse the
two endpoint distance rows d(v_a, .) and d(v_b, .) — so the per-edge cost is
two source rows, not one per lixel (Lemma 3.5).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import scipy.sparse.csgraph as csgraph

from .network import RoadNetwork

__all__ = [
    "adjacency_csr",
    "bounded_dijkstra",
    "endpoint_distance_rows",
    "candidate_edges",
]


def adjacency_csr(net: RoadNetwork) -> sp.csr_matrix:
    rows = np.concatenate([net.edge_src, net.edge_dst])
    cols = np.concatenate([net.edge_dst, net.edge_src])
    w = np.concatenate([net.edge_len, net.edge_len])
    # parallel edges: keep the minimum weight (lexsort puts the lightest first)
    order = np.lexsort((w, cols, rows))
    r, c, d = rows[order], cols[order], w[order]
    keep = np.ones(len(r), dtype=bool)
    keep[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
    return sp.csr_matrix((d[keep], (r[keep], c[keep])), shape=(net.n_vertices, net.n_vertices))


def bounded_dijkstra(
    net: RoadNetwork,
    sources: Sequence[int],
    radius: float,
    *,
    adj: Optional[sp.csr_matrix] = None,
    chunk: int = 512,
) -> np.ndarray:
    """Exact distances d(s, v) for every source s, np.inf beyond ``radius``.

    Returns float64 [len(sources), V]. Chunked so huge source sets do not
    allocate more than ``chunk`` rows at a time beyond the output itself.
    """
    adj = adjacency_csr(net) if adj is None else adj
    sources = np.asarray(sources, dtype=np.int64)
    out = np.empty((len(sources), net.n_vertices), dtype=np.float64)
    for lo in range(0, len(sources), chunk):
        idx = sources[lo : lo + chunk]
        out[lo : lo + len(idx)] = csgraph.dijkstra(
            adj, directed=False, indices=idx, limit=radius
        )
    return out


def endpoint_distance_rows(
    net: RoadNetwork, radius: float, *, adj: Optional[sp.csr_matrix] = None
) -> np.ndarray:
    """SPS precomputation: d(v, .) for every vertex, bounded by ``radius``.

    [V, V] float64 — the two rows of a query edge's endpoints are shared by all
    of its lixels (§3.2). Callers with huge V should prefer
    ``bounded_dijkstra`` on just the vertices they touch.
    """
    return bounded_dijkstra(net, np.arange(net.n_vertices), radius, adj=adj)


def candidate_edges(
    net: RoadNetwork,
    query_edge: int,
    b_s: float,
    dist_rows: np.ndarray,
) -> np.ndarray:
    """Event edges that can contribute to any lixel on ``query_edge``.

    A contribution needs d(q, v_c) <= b_s for one endpoint v_c, and
    d(q, v_c) >= d(v_a, v_c) - len_a, so edges with
    min-endpoint-distance <= b_s + len_a are a safe superset.
    ``dist_rows`` must hold the two rows for this edge's endpoints
    (shape [2, V], order (v_a, v_b)).
    """
    len_a = net.edge_len[query_edge]
    d_min = np.minimum(
        np.minimum(dist_rows[0][net.edge_src], dist_rows[0][net.edge_dst]),
        np.minimum(dist_rows[1][net.edge_src], dist_rows[1][net.edge_dst]),
    )
    return np.nonzero(d_min <= b_s + len_a)[0].astype(np.int32)
