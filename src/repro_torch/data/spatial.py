"""Synthetic road networks + spatiotemporal events, calibrated to the paper.

The paper's datasets (Table 3) are OSM road networks with municipal event
feeds. The generator needs no download: it makes grid-perturbed networks
whose shape statistics match Table 3 — |V|, |E|, N and the events-per-edge
ratio N/|E| — at a configurable ``scale``. Edge lengths follow the paper's
reported 100m–200m average. Events cluster around hotspot edges (spatially)
and around daily rush-hour peaks (temporally), so KDE heatmaps have the
banded structure of Figure 1/22.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.events import Events
from ..core.network import RoadNetwork

__all__ = ["make_network", "make_events", "make_dataset", "DATASETS"]

# Table 3 of the paper: |V|, |E|, N
DATASETS = {
    "berkeley": (1576, 4378, 735_366),
    "johns_creek": (3074, 3471, 979_072),
    "san_francisco": (9700, 16008, 5_379_023),
    "new_york": (55765, 92229, 38_400_730),
}


def make_network(n_vertices: int, n_edges: int, seed: int = 0) -> RoadNetwork:
    """Grid-perturbed connected network with ~n_edges edges.

    Start from a spanning grid (guarantees connectivity), then add random
    chords between nearby grid nodes until the edge budget is met.
    """
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
        # drop random grid edges but keep a spanning tree (row snake + column 0)
        keep_mask = np.ones(have, bool)
        is_tree = np.zeros(have, bool)
        # mark a simple spanning structure: all edges in column 0 + all row edges
        for i, (s, d) in enumerate(zip(src, dst)):
            if d == s + 1:  # row edge
                is_tree[i] = True
            elif s % side == 0 and d % side == 0:  # column-0 edge
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
    return RoadNetwork(n_vertices=n, edge_src=src, edge_dst=dst, edge_len=lens)


def make_events(
    net: RoadNetwork,
    n_events: int,
    seed: int = 0,
    n_hotspots: int = 8,
    span_days: float = 90.0,
) -> Events:
    """Spatially hotspot-clustered, temporally rush-hour-peaked events."""
    rng = np.random.default_rng(seed + 1)
    E = net.n_edges
    hotspots = rng.integers(0, E, size=max(n_hotspots, 1))
    # edge sampling weights: background + hotspot boosts on "nearby" edge ids
    w = np.full(E, 1.0)
    for h in hotspots:
        idx = np.arange(E)
        w += 40.0 * np.exp(-((idx - h) ** 2) / (2 * (E * 0.01 + 1) ** 2))
    w /= w.sum()
    eid = rng.choice(E, size=n_events, p=w)
    pos = rng.random(n_events) * net.edge_len[eid]
    # time: uniform day index x rush-hour bimodal time-of-day
    day = rng.integers(0, max(int(span_days), 1), size=n_events).astype(np.float64)
    peak = np.where(rng.random(n_events) < 0.5, 8.5, 17.5)
    tod = rng.normal(peak, 1.5) % 24.0
    time = day * 86400.0 + tod * 3600.0
    return Events(edge_id=eid, pos=pos, time=time)


def make_dataset(
    name: str, scale: float = 1.0, seed: int = 0
) -> Tuple[RoadNetwork, Events, dict]:
    """Scaled replica of a Table-3 dataset. Returns (net, events, meta)."""
    v, e, n = DATASETS[name]
    nv = max(int(v * scale), 16)
    ne_target = max(int(e * scale), nv)
    nn = max(int(n * scale), 64)
    net = make_network(nv, ne_target, seed=seed)
    ev = make_events(net, nn, seed=seed)
    meta = {
        "name": name,
        "scale": scale,
        "V": net.n_vertices,
        "E": net.n_edges,
        "N": ev.n,
        "N_over_E": ev.n / max(net.n_edges, 1),
        "table3": {"V": v, "E": e, "N": n, "N_over_E": n / e},
    }
    return net, ev, meta
