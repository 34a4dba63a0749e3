"""Frozen copy of the Table-3 replica generator (``repro_torch.data.spatial``).

The benchmark makes its own inputs from ``--seed`` so that a later change to
the program's generator cannot change the yardstick. This file is that
generator as it stood when the benchmark was defined, returning plain NumPy
arrays: the harness hands the same arrays to the program (wrapped in its
``RoadNetwork`` / ``Events``) and to the plain reference. A CPU test holds
it bit for bit against the program's ``make_dataset``.

``reorder`` gives a run its own inputs from ``--seed`` without changing the
work: the same network and events with vertex and edge ids permuted, edge
directions flipped, events in another order and the time axis shifted by
whole days. (Drawn anew, the hotspots move, and with them how deep the
busiest edges' trees are: the work of a query changed with the seed.)

Networks are grid-perturbed and connected, with |V|, |E| and N of the
paper's Table 3 at a given ``scale``; events cluster around hotspot edges
and around two daily rush-hour peaks over 90 days.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Dataset", "make_dataset", "reorder"]


@dataclasses.dataclass
class Dataset:
    n_vertices: int
    edge_src: np.ndarray  # int32 [E]
    edge_dst: np.ndarray  # int32 [E]
    edge_len: np.ndarray  # float64 [E], metres
    ev_edge: np.ndarray  # int32 [N]
    ev_pos: np.ndarray  # float64 [N], metres from the edge's src
    ev_time: np.ndarray  # float64 [N], seconds

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def n_events(self) -> int:
        return int(self.ev_edge.shape[0])

    @property
    def t_min(self) -> float:
        return float(self.ev_time.min())

    @property
    def t_span(self) -> float:
        return float(self.ev_time.max() - self.ev_time.min())


def _network(n_vertices: int, n_edges: int, seed: int):
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_vertices)))
    n = n_vertices
    xy = np.stack(
        np.meshgrid(np.arange(side, dtype=np.float64), np.arange(side, dtype=np.float64)),
        axis=-1,
    ).reshape(-1, 2)[:n]
    xy = xy * 150.0 + rng.normal(0, 25.0, size=(n, 2))  # ~150 m blocks

    def vid(r, c):
        return r * side + c

    src, dst = [], []
    for r in range(side):
        for c in range(side):
            v = vid(r, c)
            if v >= n:
                continue
            if c + 1 < side and vid(r, c + 1) < n:
                src.append(v)
                dst.append(vid(r, c + 1))
            if r + 1 < side and vid(r + 1, c) < n:
                src.append(v)
                dst.append(vid(r + 1, c))
    src = np.array(src, np.int64)
    dst = np.array(dst, np.int64)
    have = len(src)
    if have > n_edges:
        # drop random grid edges but keep a spanning structure: every row
        # edge and every column-0 edge
        keep_mask = np.ones(have, bool)
        is_tree = np.zeros(have, bool)
        for i, (s, d) in enumerate(zip(src, dst)):
            if d == s + 1:
                is_tree[i] = True
            elif s % side == 0 and d % side == 0:
                is_tree[i] = True
        droppable = np.nonzero(~is_tree)[0]
        n_drop = min(have - n_edges, len(droppable))
        drop = rng.choice(droppable, size=n_drop, replace=False)
        keep_mask[drop] = False
        src, dst = src[keep_mask], dst[keep_mask]
    else:
        extra = n_edges - have
        if extra > 0:
            a = rng.integers(0, n, size=extra * 3)
            off = rng.integers(1, 4, size=extra * 3) * np.where(
                rng.random(extra * 3) < 0.5, 1, side
            )
            b = (a + off) % n
            ok = a != b
            a, b = a[ok][:extra], b[ok][:extra]
            src = np.concatenate([src, a])
            dst = np.concatenate([dst, b])
    lens = np.linalg.norm(xy[src] - xy[dst], axis=1)
    lens = np.maximum(lens * rng.uniform(1.0, 1.3, size=len(lens)), 30.0)
    return n, src.astype(np.int32), dst.astype(np.int32), lens.astype(np.float64)


def _events(edge_len: np.ndarray, n_events: int, seed: int, n_hotspots: int = 8,
            span_days: float = 90.0):
    rng = np.random.default_rng(seed + 1)
    E = edge_len.shape[0]
    hotspots = rng.integers(0, E, size=max(n_hotspots, 1))
    w = np.full(E, 1.0)
    for h in hotspots:
        idx = np.arange(E)
        w += 40.0 * np.exp(-((idx - h) ** 2) / (2 * (E * 0.01 + 1) ** 2))
    w /= w.sum()
    eid = rng.choice(E, size=n_events, p=w)
    pos = rng.random(n_events) * edge_len[eid]
    day = rng.integers(0, max(int(span_days), 1), size=n_events).astype(np.float64)
    peak = np.where(rng.random(n_events) < 0.5, 8.5, 17.5)
    tod = rng.normal(peak, 1.5) % 24.0
    time = day * 86400.0 + tod * 3600.0
    return eid.astype(np.int32), pos.astype(np.float64), time.astype(np.float64)


def make_dataset(table3: dict, scale: float, seed: int) -> Dataset:
    """Scaled replica of a Table-3 dataset, a pure function of the seed.
    ``table3`` is a configuration's ``{"V": |V|, "E": |E|, "N": N}``."""
    v, e, n = int(table3["V"]), int(table3["E"]), int(table3["N"])
    nv = max(int(v * scale), 16)
    ne_target = max(int(e * scale), nv)
    nn = max(int(n * scale), 64)
    n_vertices, src, dst, lens = _network(nv, ne_target, seed)
    eid, pos, time = _events(lens, nn, seed)
    return Dataset(n_vertices, src, dst, lens, eid, pos, time)


def reorder(ds: Dataset, rng) -> Dataset:
    """The same network and events under new ids, directions, event order
    and a time shift of 0-3649 whole days, drawn from ``rng``."""
    V, E, N = ds.n_vertices, ds.n_edges, ds.n_events
    vperm = rng.permutation(V)
    eperm = rng.permutation(E)  # new edge i is old edge eperm[i]
    flip = rng.random(E) < 0.5
    src = np.where(flip, ds.edge_dst, ds.edge_src)
    dst = np.where(flip, ds.edge_src, ds.edge_dst)
    new_id = np.empty(E, np.int64)
    new_id[eperm] = np.arange(E)
    order = rng.permutation(N)
    old_edge = ds.ev_edge[order]
    pos = ds.ev_pos[order]
    pos = np.where(flip[old_edge], ds.edge_len[old_edge] - pos, pos)
    shift = float(rng.integers(0, 3650)) * 86400.0
    return Dataset(V, vperm[src[eperm]].astype(np.int32), vperm[dst[eperm]].astype(np.int32),
                   ds.edge_len[eperm].copy(), new_id[old_edge].astype(np.int32), pos,
                   ds.ev_time[order] + shift)
