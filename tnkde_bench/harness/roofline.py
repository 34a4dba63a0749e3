"""The work a query needs, and the least time one H100 could take for it.

Counted from what the QUERY needs, never from how the program lays it out:
the atoms are derived here from the benchmark's own network and events, so
padding, the split of atoms into packs, the number of launches and any
atom a plan adds that selects no event do not change a count, and a kernel
that fuses or re-packs is held against the same work. Adapted from the
bound arithmetic the port's smoke run used for single launches
(``fused_walk_bound`` / ``walk_work`` / ``segment_bound``).

An atom is a (lixel, event edge, spatial side) term of the exact sum: the
events of one edge that lie within ``b_s`` of the lixel and are nearer
through that side (the paper's §3.2 and §4.2: through the edge's src
endpoint, through its dst endpoint, or, on the lixel's own edge, to its
left or to its right). Its events are one interval [r_lo, r_hi) of ranks in
the edge's events sorted by position; only atoms that select an event
count. Its canonical decomposition is the bottom-up walk over a segment
tree of those ranks: the same nodes whatever size the tree is padded to.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse.csgraph

from ..reference.tnkde_ref import _graph, lixel_geometry

__all__ = ["PEAK_BYTES_PER_S", "PEAK_F64_FLOPS", "KERNEL_FEATURES", "query_atoms",
           "walk_account", "scatter_account", "query_work", "bound_seconds"]

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, float64 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F64_FLOPS = 34e12
# features a kernel's polynomial needs per event (triangular: 1 and x)
KERNEL_FEATURES = {"triangular": 2}
TABLE_ITEMSIZE = {"f64": 8, "auto": 8, "f32": 4, "bf16": 2}


def query_atoms(ds, g: float, b_s: float, chunk: int = 256):
    """The live atoms of a query over every lixel: (lixel, event edge, side,
    r_lo, r_hi), side 0 for events reached through the edge's src (or right
    of the lixel on its own edge), 1 through its dst (or left of it). An
    event at equal distance through both ends goes to src; one at the
    lixel's own position to the left."""
    src = ds.edge_src.astype(np.int64)
    dst = ds.edge_dst.astype(np.int64)
    length = ds.edge_len
    E = length.shape[0]
    lix_edge, lix_pos = lixel_geometry(length, g)
    lix_ptr = np.searchsorted(lix_edge, np.arange(E + 1))
    ev_ptr = np.zeros(E + 1, np.int64)
    np.cumsum(np.bincount(ds.ev_edge, minlength=E), out=ev_ptr[1:])
    n_ev = ev_ptr[1:] - ev_ptr[:-1]
    # every edge's events sorted by position, on one axis: edge e's span is
    # [base[e], base[e] + len_e], so one searchsorted serves every edge
    base = np.concatenate([[0.0], np.cumsum(length + 1.0)[:-1]])
    order = np.lexsort((ds.ev_pos, ds.ev_edge))
    axis = base[ds.ev_edge[order]] + ds.ev_pos[order]

    def ranks(edge, bound, side):
        b = base[edge] + np.clip(bound, -0.5, length[edge] + 0.5)
        return np.searchsorted(axis, b, side) - ev_ptr[edge]

    graph = _graph(ds.n_vertices, src, dst, length)
    has = n_ev > 0
    out = []
    for lo in range(0, E, chunk):
        qe = np.arange(lo, min(lo + chunk, E))
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
            ok = d_c <= b_s  # through src: x_p <= min(b_s - d_c, bp)
            e = C2[ok]
            out.append((L2[ok], e, 0, np.zeros(e.shape[0], np.int64),
                        ranks(e, np.minimum(b_s - d_c, bp)[ok], "right")))
            ok = d_d <= b_s  # through dst: x_p > bp and x_p >= len - (b_s - d_d)
            e = C2[ok]
            r_lo = np.maximum(ranks(e, bp[ok], "right"),
                              ranks(e, length[e] - (b_s - d_d[ok]), "left"))
            out.append((L2[ok], e, 1, r_lo, n_ev[e]))
            if has[a]:  # its own edge: left [x - b_s, x], right (x, x + b_s]
                e = np.full(x.shape[0], a)
                mid = ranks(e, x, "right")
                out.append((lix, e, 1, ranks(e, x - b_s, "left"), mid))
                out.append((lix, e, 0, mid, ranks(e, x + b_s, "right")))
    lixel = np.concatenate([o[0] for o in out])
    edge = np.concatenate([o[1] for o in out])
    side = np.concatenate([np.full(o[1].shape[0], o[2], np.int64) for o in out])
    r_lo = np.concatenate([o[3] for o in out])
    r_hi = np.concatenate([o[4] for o in out])
    live = r_lo < r_hi
    return lixel[live], edge[live], side[live], r_lo[live], r_hi[live]


def walk_account(atom_edge, side, r_lo, r_hi, *, W: int, k_s: int, itemsize: int):
    """Bytes and float64 operations of the walk and window contraction for
    one query of W windows over these atoms: each distinct (edge, level,
    node, side) row of the window table the decompositions touch, read once
    at the table's itemsize (a row holds W x 2 k_s values); each atom's k_s
    coefficients, its interval and side; its W outputs written once. One add
    per value gathered, 3 per (atom, window, feature). Atoms are live
    (r_lo < r_hi), as ``query_atoms`` gives them."""
    l = r_lo.astype(np.int64)
    r = r_hi.astype(np.int64)
    e = atom_edge.astype(np.int64)
    s = side.astype(np.int64)
    n_live = int(l.shape[0])
    keys, emitted, lev = [], 0, 0
    while l.shape[0]:
        for left in (True, False):
            emit = (l < r) & (((l if left else r) & 1) == 1)
            node = (l if left else r - 1)[emit]
            keys.append((((e[emit] << 6) + lev) << 40) + (node << 1) + s[emit])
            emitted += int(emit.sum())
            if left:
                l = np.where(emit, l + 1, l)
            else:
                r = np.where(emit, r - 1, r)
        l, r = l >> 1, r >> 1
        go = l < r
        l, r, e, s = l[go], r[go], e[go], s[go]
        lev += 1
    distinct = int(np.unique(np.concatenate(keys)).shape[0]) if keys else 0
    row_values = W * 2 * k_s
    nbytes = distinct * row_values * itemsize + n_live * (k_s * 8 + 12) + n_live * W * 8
    flops = emitted * row_values + n_live * W * 3 * k_s
    return dict(bytes=nbytes, flops=flops, rows_distinct=distinct, rows_emitted=emitted,
                atoms_live=n_live)


def scatter_account(atom_lixel, *, W: int):
    """Bytes and adds of adding every atom's W values onto its lixel: each
    row read once with its lixel index, each touched (lixel, window) written
    once; one add per (atom, window)."""
    m = int(atom_lixel.shape[0])
    u = int(np.unique(atom_lixel).shape[0])
    return dict(bytes=m * W * 8 + m * 8 + u * W * 8, flops=m * W, rows=m, lixels=u)


def query_work(ds, cfg, W: int):
    """Both kernels' accounts for one query of W windows under a
    configuration (its ``g``, ``b_s``, spatial kernel and table codec)."""
    lixel, edge, side, r_lo, r_hi = query_atoms(ds, float(cfg["g"]), float(cfg["b_s"]))
    walk = walk_account(edge, side, r_lo, r_hi, W=W,
                        k_s=KERNEL_FEATURES[cfg["spatial_kernel"]],
                        itemsize=TABLE_ITEMSIZE[cfg["table_codec"]])
    return {"fused_walk": walk, "segment_add": scatter_account(lixel, W=W)}


def bound_seconds(account) -> float:
    """The larger of bytes over the peak bandwidth and operations over the
    peak float64 rate."""
    return max(account["bytes"] / PEAK_BYTES_PER_S, account["flops"] / PEAK_F64_FLOPS)
