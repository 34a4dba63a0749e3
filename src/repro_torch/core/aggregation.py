"""Shared aggregation machinery for ADA / RFS / DRFS.

Everything a TN-KDE index needs reduces to three primitives, all implemented
here once, branch-free and batched (the same algorithm the device
engines run; see ``repro_torch.kernels``):

1. ``segmented_searchsorted`` — vectorized binary search inside ragged
   segments of one flat sorted array.
2. ``build_event_moments`` — the per-event feature block Φ[combo, K] from
   §3.3/§7: combo enumerates (spatial side: from-v_c / from-v_d) x (temporal
   orientation: left / right window half), K = k_s * k_t.
3. ``window_rank_ranges`` — per-edge (rank_lo, rank_mid, rank_hi) of a time
   window [t-b_t, t+b_t] split at t (the paper's "doubled aggregations").

Combo layout (used everywhere):
    0 = (ψ_c, left)    1 = (ψ_c, right)    2 = (ψ_d, left)    3 = (ψ_d, right)

where ψ_c = e_vec(x_p / len_e)  (distance measured from v_c, scaled)
      ψ_d = e_vec((len_e - x_p) / len_e)
      left  temporal features  = e_vec((t_max - t_i) / span)
      right temporal features  = e_vec((t_i - t_min) / span)
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .events import EdgeEvents
from .kernels_math import DecomposableKernel
from .network import RoadNetwork

__all__ = [
    "MomentContext",
    "build_event_moments",
    "segmented_searchsorted",
    "window_rank_ranges",
    "window_rank_ranges_multi",
    "next_pow2",
    "N_COMBOS",
]

N_COMBOS = 4


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class MomentContext:
    """Static data shared by all indexes built over one event set."""

    ks: DecomposableKernel  # spatial kernel
    kt: DecomposableKernel  # temporal kernel
    b_s: float
    b_t: float
    t_min: float
    t_max: float
    t_span: float
    k_s: int
    k_t: int

    @property
    def K(self) -> int:
        return self.k_s * self.k_t

    @property
    def sigma_t(self) -> float:
        return self.t_span / self.b_t

    # query-side temporal coefficient vectors for a window centred at t
    def qt_left(self, t: float) -> np.ndarray:
        return self.kt.q_vec(np.float64((t - self.t_max) / self.b_t), self.sigma_t)

    def qt_right(self, t: float) -> np.ndarray:
        return self.kt.q_vec(np.float64((self.t_min - t) / self.b_t), self.sigma_t)


def build_event_moments(
    net: RoadNetwork,
    ee: EdgeEvents,
    ks: DecomposableKernel,
    kt: DecomposableKernel,
    b_s: float,
    b_t: float,
) -> Tuple[MomentContext, np.ndarray]:
    """Per-event feature block Φ: float64 [N, 4, k_s*k_t].

    Events stay in EdgeEvents order (grouped by edge, time-sorted within).
    """
    t_span = max(ee.t_max - ee.t_min, 1e-12)
    ctx = MomentContext(
        ks=ks,
        kt=kt,
        b_s=float(b_s),
        b_t=float(b_t),
        t_min=ee.t_min,
        t_max=ee.t_max,
        t_span=t_span,
        k_s=ks.n_features,
        k_t=kt.n_features,
    )
    n = ee.n
    if n == 0:
        return ctx, np.zeros((0, N_COMBOS, ctx.K), dtype=np.float64)

    counts = np.diff(ee.ptr)
    edge_of_event = np.repeat(np.arange(net.n_edges, dtype=np.int64), counts)
    lens = net.edge_len[edge_of_event]
    u_c = ee.pos / lens  # in [0, 1]
    u_d = 1.0 - u_c
    sig_s = lens / b_s  # event-side spatial scale (per edge)

    psi_c = ks.e_vec(u_c, sig_s)  # [N, k_s]
    psi_d = ks.e_vec(u_d, sig_s)
    v_l = (ee.t_max - ee.time) / t_span
    v_r = (ee.time - ee.t_min) / t_span
    tau_l = kt.e_vec(v_l, ctx.sigma_t)  # [N, k_t]
    tau_r = kt.e_vec(v_r, ctx.sigma_t)

    def outer(a, b):
        return (a[:, :, None] * b[:, None, :]).reshape(n, -1)

    phi = np.stack(
        [outer(psi_c, tau_l), outer(psi_c, tau_r), outer(psi_d, tau_l), outer(psi_d, tau_r)],
        axis=1,
    )
    return ctx, phi


def segmented_cumsum(x: np.ndarray, ptr: np.ndarray) -> np.ndarray:
    """Inclusive cumulative sum restarting at each segment boundary.

    x: [n, ...]; ptr: [S+1] segment offsets (ascending, ptr[-1] == n).
    """
    if x.shape[0] == 0:
        return x.copy()
    cs = np.cumsum(x, axis=0)
    starts = np.asarray(ptr[:-1], dtype=np.int64)
    seg_off = np.zeros((len(starts),) + x.shape[1:], dtype=cs.dtype)
    nz = starts > 0
    seg_off[nz] = cs[starts[nz] - 1]
    counts = np.diff(ptr)
    return cs - np.repeat(seg_off, counts, axis=0)


def segmented_searchsorted(
    vals: np.ndarray,
    seg_lo: np.ndarray,
    seg_hi: np.ndarray,
    query: np.ndarray,
    right: np.ndarray,
) -> np.ndarray:
    """Vectorized searchsorted within ragged segments of one flat array.

    For each i, returns the insertion index (absolute, in [seg_lo[i],
    seg_hi[i]]) of query[i] into the ascending slice vals[seg_lo[i]:seg_hi[i]],
    with 'right' bisection where right[i] else 'left'.

    Branch-free fixed-trip binary search — the loop ``torch_engine._seg_search``
    repeats on device tensors.
    """
    lo = np.asarray(seg_lo, dtype=np.int64).copy()
    hi = np.asarray(seg_hi, dtype=np.int64).copy()
    q = np.asarray(query)
    right = np.asarray(right, dtype=bool)
    max_len = int(np.max(hi - lo, initial=0))
    if max_len <= 0:
        return lo
    for _ in range(int(np.ceil(np.log2(max_len + 1))) + 1):
        mid = (lo + hi) >> 1
        active = lo < hi
        m = np.where(active, mid, 0)
        v = vals[m]
        go_right = np.where(right, v <= q, v < q) & active
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(go_right | ~active, hi, mid)
    return lo


def window_rank_ranges(
    ee: EdgeEvents, edges: np.ndarray, t: float, b_t: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per requested edge: event-rank bounds (lo, mid, hi) of the window
    [t - b_t, t + b_t] split at t: left half = [lo, mid), right = [mid, hi).

    Ranks are *local* to the edge (0-based within its time-sorted slice).
    """
    edges = np.asarray(edges, dtype=np.int64)
    lo_abs = ee.ptr[edges]
    hi_abs = ee.ptr[edges + 1]
    n = len(edges)
    qlo = np.full(n, t - b_t)
    qmid = np.full(n, t)
    qhi = np.full(n, t + b_t)
    r_lo = segmented_searchsorted(ee.time, lo_abs, hi_abs, qlo, np.zeros(n, bool))
    r_mid = segmented_searchsorted(ee.time, lo_abs, hi_abs, qmid, np.ones(n, bool))
    r_hi = segmented_searchsorted(ee.time, lo_abs, hi_abs, qhi, np.ones(n, bool))
    return (r_lo - lo_abs, r_mid - lo_abs, r_hi - lo_abs)


def window_rank_ranges_multi(
    ee: EdgeEvents, edges: np.ndarray, ts: np.ndarray, b_t: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``window_rank_ranges`` batched over W window centers in one sweep.

    edges: [n], ts: [W] → each of (lo, mid, hi) is [W, n]. One vectorized
    searchsorted pass over all W·n (edge, window) pairs instead of a Python
    loop over windows — the multiple-temporal-KDE shape of §8.2.
    """
    edges = np.asarray(edges, dtype=np.int64)
    ts = np.asarray(ts, dtype=np.float64)
    n, W = len(edges), len(ts)
    lo_abs = np.tile(ee.ptr[edges], W)
    hi_abs = np.tile(ee.ptr[edges + 1], W)
    t_rep = np.repeat(ts, n)
    r_lo = segmented_searchsorted(ee.time, lo_abs, hi_abs, t_rep - b_t, np.zeros(W * n, bool))
    r_mid = segmented_searchsorted(ee.time, lo_abs, hi_abs, t_rep, np.ones(W * n, bool))
    r_hi = segmented_searchsorted(ee.time, lo_abs, hi_abs, t_rep + b_t, np.ones(W * n, bool))
    shape = (W, n)
    return (
        (r_lo - lo_abs).reshape(shape),
        (r_mid - lo_abs).reshape(shape),
        (r_hi - lo_abs).reshape(shape),
    )
