"""Aggregate Distance Augmentation (ADA) baseline — the state of the art the
paper compares against (§3.2, [Chan et al., VLDB'21]).

Per query time window, ADA (as used in the paper's experiments, §8.2):
  1. filters events to [t - b_t, t + b_t] and weights each by the *exact*
     temporal kernel value w_i = K_t(|t - t_i| / b_t)  (a scalar — no
     temporal decomposition needed because the index is rebuilt per window);
  2. builds a per-edge linear index: events sorted by position with inclusive
     prefix sums of w_i-weighted spatial features (both ψ_c and ψ_d sides);
  3. answers each lixel with binary searches into that single sorted run.

The per-window rebuild is exactly the cost RFS amortizes away — reproduced
faithfully so Figures 14/16 can be replicated.

Host NumPy only, as in the reference package (``repro.core.ada``), of which
this module is a copy over this package's own host modules: ADA has no
device code.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .aggregation import (
    MomentContext,
    segmented_cumsum,
    segmented_searchsorted,
    window_rank_ranges,
)
from .events import EdgeEvents
from .network import RoadNetwork
from .plan import AtomSet

__all__ = ["AggregateDistanceIndex"]


class AggregateDistanceIndex:
    def __init__(self, net: RoadNetwork, ee: EdgeEvents, ctx: MomentContext):
        self.net = net
        self.ee = ee
        self.ctx = ctx
        self._cache: Dict[float, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        self.index_bytes = 0

    # ------------------------------------------------------------ indexing
    def build_window(self, t: float):
        """Filter + sort + aggregate for one window (cached per t)."""
        if t in self._cache:
            return self._cache[t]
        net, ee, ctx = self.net, self.ee, self.ctx
        E = net.n_edges
        edges = np.arange(E, dtype=np.int64)
        lo, mid, hi = window_rank_ranges(ee, edges, t, ctx.b_t)
        counts = (hi - lo).astype(np.int64)
        ptr = np.zeros(E + 1, dtype=np.int64)
        np.cumsum(counts, out=ptr[1:])
        n_sel = int(ptr[-1])
        if n_sel == 0:
            empty = (ptr, np.zeros(0), np.zeros((0, 2, ctx.k_s)))
            self._cache[t] = empty
            return empty
        # absolute indices of selected events (contiguous per edge, time order)
        sel = (
            np.repeat(ee.ptr[:-1] + lo, counts)
            + np.arange(n_sel)
            - np.repeat(ptr[:-1], counts)
        )
        edge_of = np.repeat(edges, counts)
        pos = ee.pos[sel]
        time = ee.time[sel]
        w = ctx.kt(np.abs(t - time) / ctx.b_t)
        lens = net.edge_len[edge_of]
        sig = lens / ctx.b_s
        psi_c = ctx.ks.e_vec(pos / lens, sig)  # [n_sel, k_s]
        psi_d = ctx.ks.e_vec(1.0 - pos / lens, sig)
        feats = w[:, None, None] * np.stack([psi_c, psi_d], axis=1)
        order = np.lexsort((pos, edge_of))
        pos_s = pos[order]
        cs = segmented_cumsum(feats[order], ptr)
        built = (ptr, pos_s, cs)
        self._cache[t] = built
        self.index_bytes = max(self.index_bytes, pos_s.nbytes + cs.nbytes)
        return built

    # -------------------------------------------------------------- queries
    def eval_atoms(self, atoms: AtomSet, t: float, **_) -> np.ndarray:
        M = atoms.m
        if M == 0:
            return np.zeros(0)
        ptr, pos_s, cs = self.build_window(t)
        seg_lo = ptr[atoms.edge]
        seg_hi = ptr[atoms.edge + 1]
        i_hi = segmented_searchsorted(pos_s, seg_lo, seg_hi, atoms.pos_hi, np.ones(M, bool))
        i_lo1 = segmented_searchsorted(pos_s, seg_lo, seg_hi, atoms.pos_lo1, atoms.lo1_right)
        i_lo2 = segmented_searchsorted(pos_s, seg_lo, seg_hi, atoms.pos_lo2, np.zeros(M, bool))
        i_lo = np.maximum(i_lo1, i_lo2)
        i_hi = np.maximum(i_hi, i_lo)
        side = atoms.side_feat.astype(np.int64)

        def pref(i):
            v = cs[np.maximum(i - 1, 0), side]
            return np.where((i > seg_lo)[:, None], v, 0.0)

        mom = pref(i_hi) - pref(i_lo)
        return np.einsum("mk,mk->m", atoms.qs, mom)

    # LS support: whole-edge totals with the temporal weight already folded in
    def dominated_moments(self, edges_req: np.ndarray, t: float, side: int) -> np.ndarray:
        """[n, k_s] spatial moments: F_e(q) = Q_s(d(q, v_side)) · M (§6.2)."""
        ptr, pos_s, cs = self.build_window(t)
        edges_req = np.asarray(edges_req, dtype=np.int64)
        lo = ptr[edges_req]
        hi = ptr[edges_req + 1]
        val = cs[np.maximum(hi - 1, 0), side]
        return np.where((hi > lo)[:, None], val, 0.0)
