"""Query planning: turn (query edge, candidate event edges) into flat "atom"
arrays that any aggregation index can answer.

One *atom* = the contribution of one (lixel, event-edge, spatial-side) triple,
restricted to a position interval on the event edge. The four geometric cases
(§3.2, §4.2 Eq. 5 and the same-edge split) all reduce to interval selections
on the position-sorted events of the event edge:

  via-v_c   : x_p <= min(b_s - d(q,v_c), breakpoint)                 (prefix)
  via-v_d   : x_p >  breakpoint  AND  x_p >= len_e - (b_s - d(q,v_d)) (suffix)
  same-left : x_q - b_s <= x_p <= x_q        (distance = x_q - x_p)
  same-right: x_q <  x_p <= x_q + b_s        (distance = x_p - x_q)

with breakpoint = (d(q,v_d) - d(q,v_c) + len_e)/2 (ties go to v_c).

Each atom carries the spatial query vector Q_s evaluated at the right
(possibly negative) argument so that, paired with the stored event features
(ψ_c for via-v_c/same-right, ψ_d for via-v_d/same-left), the dot product is
exactly K_s(d(q,p)/b_s) summed over the selected events — no parity
bookkeeping (see kernels_math.py docstring).

Shortest Path Sharing (§3.2): all lixels of a query edge reuse the two
endpoint distance rows, so d(q, v_c) = min(x_q + d(v_a,v_c),
len_a - x_q + d(v_b,v_c)) is pure arithmetic per lixel.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .aggregation import MomentContext
from .events import EdgeEvents
from .network import Lixels, RoadNetwork

__all__ = ["EdgeGeometry", "AtomSet", "build_edge_geometry", "build_atoms"]

INF = np.float64(np.inf)


@dataclasses.dataclass
class EdgeGeometry:
    """Window-independent geometry for one query edge a (SPS-shared)."""

    a: int
    lix_base: int  # global index of this edge's first lixel
    x: np.ndarray  # [l_a] lixel center positions along a
    len_a: float
    cand: np.ndarray  # [nc] candidate event edges, a excluded, all with events
    # endpoint distances, [l_a, nc]
    d_c: np.ndarray
    d_d: np.ndarray
    # d(v_a/v_b -> v_c/v_d) rows used (for LS): [4, nc] = (a_c, a_d, b_c, b_d)
    end_d: np.ndarray
    len_e: np.ndarray  # [nc]
    self_has_events: bool


def build_edge_geometry(
    net: RoadNetwork,
    lix: Lixels,
    ee: EdgeEvents,
    a: int,
    b_s: float,
    dist_rows_ab: np.ndarray,
    candidates: Optional[np.ndarray] = None,
) -> EdgeGeometry:
    """dist_rows_ab: [2, V] bounded-Dijkstra rows for (v_a, v_b) of edge a."""
    lo, hi = int(lix.edge_ptr[a]), int(lix.edge_ptr[a + 1])
    x = lix.pos[lo:hi]
    len_a = float(net.edge_len[a])
    if candidates is None:
        d_min = np.minimum(
            np.minimum(dist_rows_ab[0][net.edge_src], dist_rows_ab[0][net.edge_dst]),
            np.minimum(dist_rows_ab[1][net.edge_src], dist_rows_ab[1][net.edge_dst]),
        )
        candidates = np.nonzero(d_min <= b_s + len_a)[0]
    candidates = np.asarray(candidates, dtype=np.int64)
    counts = ee.ptr[candidates + 1] - ee.ptr[candidates]
    cand = candidates[(candidates != a) & (counts > 0)]
    vc = net.edge_src[cand]
    vd = net.edge_dst[cand]
    a_c = dist_rows_ab[0][vc]
    a_d = dist_rows_ab[0][vd]
    b_c = dist_rows_ab[1][vc]
    b_d = dist_rows_ab[1][vd]
    d_c = np.minimum(x[:, None] + a_c[None, :], (len_a - x)[:, None] + b_c[None, :])
    d_d = np.minimum(x[:, None] + a_d[None, :], (len_a - x)[:, None] + b_d[None, :])
    return EdgeGeometry(
        a=a,
        lix_base=lo,
        x=x,
        len_a=len_a,
        cand=cand,
        d_c=d_c,
        d_d=d_d,
        end_d=np.stack([a_c, a_d, b_c, b_d]),
        len_e=net.edge_len[cand],
        self_has_events=ee.count(a) > 0,
    )


@dataclasses.dataclass
class AtomSet:
    """Flat window-independent atoms. M atoms over k_s spatial features.

    side_feat: 0 -> event features ψ_c, 1 -> ψ_d.
    Selection interval on the event edge's position-sorted events:
      idx_hi  = searchsorted(pos, pos_hi, 'right')
      idx_lo  = max(searchsorted(pos, pos_lo1, lo1 side),
                    searchsorted(pos, pos_lo2, 'left'))
      events selected: ranks [idx_lo, idx_hi)
    """

    lixel: np.ndarray  # int64 [M] global lixel id
    edge: np.ndarray  # int64 [M] event edge
    side_feat: np.ndarray  # int8 [M]
    qs: np.ndarray  # float64 [M, k_s]
    pos_hi: np.ndarray  # float64 [M]
    pos_lo1: np.ndarray  # float64 [M]
    lo1_right: np.ndarray  # bool [M]
    pos_lo2: np.ndarray  # float64 [M]

    @property
    def m(self) -> int:
        return int(self.lixel.shape[0])

    def take(self, sel: np.ndarray) -> "AtomSet":
        """Row subset (fancy-index every field)."""
        return AtomSet(
            lixel=self.lixel[sel],
            edge=self.edge[sel],
            side_feat=self.side_feat[sel],
            qs=self.qs[sel],
            pos_hi=self.pos_hi[sel],
            pos_lo1=self.pos_lo1[sel],
            lo1_right=self.lo1_right[sel],
            pos_lo2=self.pos_lo2[sel],
        )

    @staticmethod
    def concat(parts: Sequence["AtomSet"]) -> "AtomSet":
        parts = [p for p in parts if p.m]
        if not parts:
            return _empty_atoms(1)
        return AtomSet(
            lixel=np.concatenate([p.lixel for p in parts]),
            edge=np.concatenate([p.edge for p in parts]),
            side_feat=np.concatenate([p.side_feat for p in parts]),
            qs=np.concatenate([p.qs for p in parts]),
            pos_hi=np.concatenate([p.pos_hi for p in parts]),
            pos_lo1=np.concatenate([p.pos_lo1 for p in parts]),
            lo1_right=np.concatenate([p.lo1_right for p in parts]),
            pos_lo2=np.concatenate([p.pos_lo2 for p in parts]),
        )


def _empty_atoms(k_s: int) -> AtomSet:
    z = np.zeros(0)
    return AtomSet(
        lixel=np.zeros(0, np.int64),
        edge=np.zeros(0, np.int64),
        side_feat=np.zeros(0, np.int8),
        qs=np.zeros((0, k_s)),
        pos_hi=z,
        pos_lo1=z,
        lo1_right=np.zeros(0, bool),
        pos_lo2=z,
    )


def build_atoms(
    geom: EdgeGeometry,
    ctx: MomentContext,
    cand_mask: Optional[np.ndarray] = None,
) -> AtomSet:
    """Window-independent atoms for one query edge.

    cand_mask: optional bool [nc] — which candidates to expand (Lixel Sharing
    removes dominated / out-of-bandwidth edges before this step).
    """
    ks, b_s = ctx.ks, ctx.b_s
    l_a = geom.x.shape[0]
    nc = geom.cand.shape[0]
    parts = []
    if nc:
        mask = np.ones(nc, bool) if cand_mask is None else np.asarray(cand_mask, bool)
        d_c = geom.d_c[:, mask]
        d_d = geom.d_d[:, mask]
        cand = geom.cand[mask]
        len_e = geom.len_e[mask]
        ncm = cand.shape[0]
        if ncm:
            bp = (d_d - d_c + len_e[None, :]) / 2.0
            lix = geom.lix_base + np.arange(l_a, dtype=np.int64)
            lix2 = np.broadcast_to(lix[:, None], (l_a, ncm))
            edge2 = np.broadcast_to(cand[None, :], (l_a, ncm))
            sig = np.broadcast_to((len_e / b_s)[None, :], (l_a, ncm))

            # --- via v_c ---------------------------------------------------
            ok = d_c <= b_s
            if ok.any():
                sel = np.nonzero(ok.ravel())[0]
                parts.append(
                    AtomSet(
                        lixel=lix2.ravel()[sel],
                        edge=edge2.ravel()[sel],
                        side_feat=np.zeros(len(sel), np.int8),
                        qs=ks.q_vec((d_c.ravel()[sel]) / b_s, sig.ravel()[sel]),
                        pos_hi=np.minimum(b_s - d_c, bp).ravel()[sel],
                        pos_lo1=np.full(len(sel), -INF),
                        lo1_right=np.zeros(len(sel), bool),
                        pos_lo2=np.full(len(sel), -INF),
                    )
                )
            # --- via v_d ---------------------------------------------------
            ok = d_d <= b_s
            if ok.any():
                sel = np.nonzero(ok.ravel())[0]
                len_flat = np.broadcast_to(len_e[None, :], (l_a, ncm)).ravel()[sel]
                parts.append(
                    AtomSet(
                        lixel=lix2.ravel()[sel],
                        edge=edge2.ravel()[sel],
                        side_feat=np.ones(len(sel), np.int8),
                        qs=ks.q_vec((d_d.ravel()[sel]) / b_s, sig.ravel()[sel]),
                        pos_hi=np.full(len(sel), INF),
                        pos_lo1=bp.ravel()[sel],  # exclusive: ties go to v_c
                        lo1_right=np.ones(len(sel), bool),
                        pos_lo2=len_flat - (b_s - d_d.ravel()[sel]),
                    )
                )
    # --- same-edge events --------------------------------------------------
    if geom.self_has_events and l_a:
        lix = geom.lix_base + np.arange(l_a, dtype=np.int64)
        edge = np.full(l_a, geom.a, np.int64)
        sig_a = np.full(l_a, geom.len_a / b_s)
        x = geom.x
        # left of q: distance x_q - x_p, features ψ_d, Q at (x_q - len_a)/b_s
        parts.append(
            AtomSet(
                lixel=lix,
                edge=edge,
                side_feat=np.ones(l_a, np.int8),
                qs=ks.q_vec((x - geom.len_a) / b_s, sig_a),
                pos_hi=x.astype(np.float64),
                pos_lo1=x - b_s,
                lo1_right=np.zeros(l_a, bool),
                pos_lo2=np.full(l_a, -INF),
            )
        )
        # right of q: distance x_p - x_q, features ψ_c, Q at -x_q/b_s
        parts.append(
            AtomSet(
                lixel=lix,
                edge=edge,
                side_feat=np.zeros(l_a, np.int8),
                qs=ks.q_vec(-x / b_s, sig_a),
                pos_hi=x + b_s,
                pos_lo1=x.astype(np.float64),  # exclusive (x_p == x_q is "left")
                lo1_right=np.ones(l_a, bool),
                pos_lo2=np.full(l_a, -INF),
            )
        )
    return AtomSet.concat(parts) if parts else _empty_atoms(ctx.k_s)
