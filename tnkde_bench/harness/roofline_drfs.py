"""The work of an exact DRFS query's tree phase, and the least time one H100
could take for it (``roofline.bound_seconds``).

Counted from what the QUERY needs, as ``roofline`` counts RFS: the atoms
are derived here from the benchmark's own network and sealed events, so the
split into blocks, padding and atoms that cover no leaf change no count.

An atom is a (lixel, event edge, spatial side) term of the exact sum, as in
``roofline.query_atoms``, but bounded by event POSITIONS, not ranks: the
streaming index's tree bisects each edge by position into 2^depth leaves of
equal length (the paper's §5). The tree phase answers the leaves an atom
covers whole, [leaf_lo, leaf_hi), by the canonical decomposition of that
leaf range (at most two nodes a level); the partially covered boundary
leaves and the pending events are the scans', not counted here.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse.csgraph

from . import roofline
from ..reference.tnkde_ref import _graph, lixel_geometry

__all__ = ["query_atom_bounds", "leaf_ranges", "query_work"]


def query_atom_bounds(ds, g: float, b_s: float, has_events, chunk: int = 256):
    """Every atom of a query over every lixel on an edge of ``has_events``
    [E] bool: (lixel, edge, side, lo, lo_open, hi). The atom holds the
    events at positions p with lo <= p <= hi, lo < p where ``lo_open``;
    side 0 through the edge's src (or right of the lixel on its own edge),
    1 through its dst (or left of it), the split of ``roofline.query_atoms``."""
    src = ds.edge_src.astype(np.int64)
    dst = ds.edge_dst.astype(np.int64)
    length = ds.edge_len
    E = length.shape[0]
    lix_edge, lix_pos = lixel_geometry(length, g)
    lix_ptr = np.searchsorted(lix_edge, np.arange(E + 1))
    graph = _graph(ds.n_vertices, src, dst, length)
    has = np.asarray(has_events, bool)
    out = []

    def add(lix, e, side, lo, lo_open, hi):
        n = e.shape[0]
        out.append((lix, e, np.full(n, side), np.broadcast_to(lo, (n,)),
                    np.full(n, lo_open), np.broadcast_to(hi, (n,))))

    for c0 in range(0, E, chunk):
        qe = np.arange(c0, min(c0 + chunk, E))
        ends, inv = np.unique(np.concatenate([src[qe], dst[qe]]), return_inverse=True)
        dist = scipy.sparse.csgraph.dijkstra(graph, directed=False, indices=ends, limit=b_s)
        for j, a in enumerate(qe):
            x = lix_pos[lix_ptr[a]:lix_ptr[a + 1]]
            lix = np.arange(lix_ptr[a], lix_ptr[a + 1])
            da, db = dist[inv[j]], dist[inv[j + qe.shape[0]]]
            near = np.minimum(np.minimum(da[src], da[dst]), np.minimum(db[src], db[dst]))
            cand = np.flatnonzero((near <= b_s) & has)
            cand = cand[cand != a]
            d_c = np.minimum(x[:, None] + da[src[cand]], (length[a] - x)[:, None] + db[src[cand]])
            d_d = np.minimum(x[:, None] + da[dst[cand]], (length[a] - x)[:, None] + db[dst[cand]])
            bp = (d_d - d_c + length[cand]) / 2.0
            L2, C2 = np.broadcast_to(lix[:, None], d_c.shape), np.broadcast_to(cand, d_c.shape)
            ok = d_c <= b_s  # through src: p <= min(b_s - d_c, bp)
            add(L2[ok], C2[ok], 0, -np.inf, False, np.minimum(b_s - d_c, bp)[ok])
            ok = d_d <= b_s  # through dst: p > bp and p >= len - (b_s - d_d)
            e = C2[ok]
            lo2 = length[e] - (b_s - d_d[ok])
            # the larger bound decides; an equal pair keeps the open one
            open_ = bp[ok] >= lo2
            lo = np.where(open_, bp[ok], lo2)
            out.append((L2[ok], e, np.ones(e.shape[0], np.int64), lo, open_, length[e]))
            if has[a]:  # its own edge: left [x - b_s, x], right (x, x + b_s]
                e = np.full(x.shape[0], a)
                add(lix, e, 1, x - b_s, False, x)
                add(lix, e, 0, x, True, x + b_s)
    cols = list(zip(*out))
    lixel, edge, side, lo, lo_open, hi = (np.concatenate(c) for c in cols)
    return (lixel.astype(np.int64), edge.astype(np.int64), side.astype(np.int64),
            lo.astype(np.float64), lo_open.astype(bool), hi.astype(np.float64))


def leaf_ranges(edge_len, edge, lo, lo_open, hi, depth: int):
    """[leaf_lo, leaf_hi) of the leaves at ``depth`` that lie whole inside
    each atom's bounds (leaf i of an edge spans [i w, (i + 1) w], w = the
    edge's length / 2^depth), empty ranges as leaf_lo = leaf_hi."""
    nleaf = 1 << depth
    w = edge_len[edge] / nleaf
    with np.errstate(invalid="ignore"):
        lo_leaf = np.where(lo_open, np.floor(lo / w) + 1.0, np.ceil(lo / w))
    lo_leaf = np.where(np.isfinite(lo), lo_leaf, 0.0)
    hi_leaf = np.where(hi >= edge_len[edge], float(nleaf), np.floor(hi / w))
    leaf_lo = np.clip(lo_leaf, 0, nleaf).astype(np.int64)
    leaf_hi = np.clip(hi_leaf, 0, nleaf).astype(np.int64)
    return leaf_lo, np.maximum(leaf_hi, leaf_lo)


def query_work(ds, cfg, W: int, sealed_edge):
    """The tree phase's account for one exact query of W windows
    (``roofline.walk_account`` over the covered leaf ranges: each distinct
    node row [W, 2 k_s] read once at the table's itemsize, the atoms'
    coefficients, their W outputs written once). ``sealed_edge`` holds the
    edge of every sealed event: an edge without one has an all-zero tree."""
    has = np.bincount(np.asarray(sealed_edge, np.int64), minlength=ds.n_edges) > 0
    _, edge, side, lo, lo_open, hi = query_atom_bounds(ds, float(cfg["g"]),
                                                       float(cfg["b_s"]), has)
    leaf_lo, leaf_hi = leaf_ranges(ds.edge_len, edge, lo, lo_open, hi, int(cfg["drfs_depth"]))
    live = leaf_lo < leaf_hi
    return roofline.walk_account(edge[live], side[live], leaf_lo[live], leaf_hi[live], W=W,
                                 k_s=roofline.KERNEL_FEATURES[cfg["spatial_kernel"]],
                                 itemsize=roofline.TABLE_ITEMSIZE[cfg["table_codec"]])
