"""The window-table fold of the packed RFS executors: every node's q_t-folded
paired window values, ``[R·2, W, 2k_s]``.

Per (boundary, window, node) the three window boundaries (lo: ``v < q``;
mid and hi: ``v <= q``) are binary-searched in the node's time-sorted run
``[s_lo, s_lo + 2^ℓ)`` of the packed forest, the raw-Φ prefix rows before
them are differenced node-locally (left half = P(mid) − P(lo) on combos
(0, 2), right half = P(hi) − P(mid) on combos (1, 3)), each difference is
contracted with the half's temporal vector q_t (t = 0 first, then each
further t added in turn), and the two sides' ``[k_s left | k_s right]``
rows are packed with the W axis inside the row — the layout the walk
(``torch_engine.packed_walk``) and the fused kernel read in place. All of
it in float64; a narrow table codec rounds only the finished values.

``csrc/fold_tables.cu`` computes it on the card in one launch a fold (every
level at once, the table written once in the codec's fold dtype). It was
added by the port and replaces no TPU kernel: the reference folds with
jitted ``jnp`` (``repro.core.jax_engine``). This module holds the plain
PyTorch version (:func:`fold_node_tables_ref`, the level-by-level chunked
loop over :func:`fold_level`, which the DRFS exact fold
``torch_engine.dyn_node_tables`` calls on its own layout), the branch-free
search both share with the engine's other executors (:func:`seg_search`)
and the ``ctypes`` binding. The launching wrapper, with its checks and
launch count, is :func:`repro_torch.kernels.ops.fold_node_tables`.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["FOLD_CHUNK", "MAX_LEVELS", "take", "seg_search", "fold_level",
           "window_boundaries", "fold_node_tables_ref", "fold_tables_library"]

# node rows the plain version folds per step: bounds its transient
# [3, W, chunk, 4, K] prefix gather (the level-0 fold of a full-size forest
# would otherwise materialise several GB at once)
FOLD_CHUNK = 1 << 18
# levels csrc/fold_tables.cu takes (its constant of the same name): runs of
# up to 2^30 events, so a rank inside a run fits an int
MAX_LEVELS = 31


def take(table, idx):
    """``table[idx]`` with idx clamped into [0, len - 1], as jnp gathers clamp."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def seg_search(vals, seg_lo, seg_hi, q, right, steps: int):
    """Branch-free binary search of q within vals[seg_lo:seg_hi], batched
    over arbitrary leading dims (all args broadcast to a common shape).
    ``steps`` fixed trips; a finished lane (lo == hi) reads vals[0] and
    keeps its state, so ±inf pads search to the segment end. The gather is
    clamped into ``vals`` (as jnp gathers clamp): the dead lanes of the
    search executors may hold bounds outside the table, and their answers
    are masked off."""
    lo, hi, q, right = torch.broadcast_tensors(seg_lo, seg_hi, q, right)
    lo, hi = lo.clone(), hi.clone()
    zero = torch.zeros((), dtype=lo.dtype, device=lo.device)
    for _ in range(steps):
        live = lo < hi
        mid = (lo + hi) >> 1
        v = take(vals, torch.where(live, mid, zero))
        go = torch.where(right, v <= q, v < q) & live
        lo, hi = torch.where(go, mid + 1, lo), torch.where(go | ~live, hi, mid)
    return lo


def fold_level(time_tab, cum_tab, s_lo, s_hi, t_b, right_b, qtl, qtr,
               steps: int, k_t: int, out_dtype=None):
    """One level's q_t-folded paired node values: [NL·2, W, 2k_s].

    Per (boundary, window, node) binary search in the node's time-sorted run
    [s_lo, s_hi), raw-Φ prefix difference (node-local rounding), combo slice
    per side/half, q_t contraction, and the paired [k_s left | k_s right] row
    packing with W inside the row — exactly the layout the walk and the
    fused kernel consume. All of it in f64; ``out_dtype`` (the codec's fold
    dtype) casts only the finished values.
    """
    NL = s_lo.shape[0]
    W = qtl.shape[0]
    K = cum_tab.shape[-1]
    k_s = K // k_t
    i_b = seg_search(
        time_tab, s_lo[None, None], s_hi[None, None],
        t_b[..., None], right_b[..., None], steps,
    )  # [3, W, NL]

    def pref(i, combos):
        v = cum_tab[:, combos][(i - 1).clamp_min(0)]  # [W, NL, 2, K]
        return torch.where((i > s_lo[None])[..., None, None], v, 0.0)

    # combos (0, 2) = (ψ_c, ψ_d) × left half; (1, 3) = the same × right half
    left = (pref(i_b[1], slice(0, None, 2)) - pref(i_b[0], slice(0, None, 2)))
    right = (pref(i_b[2], slice(1, None, 2)) - pref(i_b[1], slice(1, None, 2)))
    left = left.reshape(W, NL, 2, k_s, k_t)
    right = right.reshape(W, NL, 2, k_s, k_t)
    vl = left[..., 0] * qtl[:, None, None, None, 0]
    vr = right[..., 0] * qtr[:, None, None, None, 0]
    for t in range(1, k_t):
        vl = vl + left[..., t] * qtl[:, None, None, None, t]
        vr = vr + right[..., t] * qtr[:, None, None, None, t]
    vv = torch.cat([vl, vr], dim=-1)  # [W, NL, 2, 2k_s]
    out = vv.permute(1, 2, 0, 3).reshape(NL * 2, W, 2 * k_s)
    return out if out_dtype is None else out.to(out_dtype)


def window_boundaries(t_lo, t_hi):
    """(t_b [3, W], right_b [3, W]): the (lo, mid, hi) time boundaries per
    window centre of the paired half-window layout (entry 2w the left half
    of centre w, 2w + 1 its right half) — mid is shared by both halves, so W
    centres carry 3 rank boundaries instead of 4; lo counts ``v < q``, mid
    and hi ``v <= q``."""
    W = t_lo.shape[0] // 2
    t_b = torch.stack([t_lo[0::2], t_hi[0::2], t_hi[1::2]])
    right_b = torch.zeros((3, W), dtype=torch.bool, device=t_b.device)
    right_b[1:] = True
    return t_b, right_b


def fold_node_tables_ref(time_tab, cum_tab, starts, t_lo, t_hi, qt, *, lvl_ptr, steps, k_t,
                         out_dtype=None):
    """The plain version of the fold: ``[R·2, W, 2k_s]`` in ``out_dtype``
    (float64 if None).

    ``starts [R]`` the flat time-table offset of every node's run,
    level-major (level ℓ's nodes are ``starts[lvl_ptr[ℓ]:lvl_ptr[ℓ+1]]``,
    runs of 2^ℓ), ``t_lo/t_hi [2W]`` and ``qt [2W, k_t]`` the paired
    half-window batch, ``steps[ℓ]`` level ℓ's search trips. Folds
    ``FOLD_CHUNK`` nodes at a time (same values, bounded transient memory),
    casting each chunk before the concatenation.
    """
    t_b, right_b = window_boundaries(t_lo, t_hi)
    qtl, qtr = qt[0::2], qt[1::2]
    parts = []
    for lev in range(len(lvl_ptr) - 1):
        ns = starts[lvl_ptr[lev]:lvl_ptr[lev + 1]]
        for c0 in range(0, ns.shape[0], FOLD_CHUNK):
            s_lo = ns[c0 : c0 + FOLD_CHUNK]
            parts.append(fold_level(time_tab, cum_tab, s_lo, s_lo + (1 << lev), t_b, right_b,
                                    qtl, qtr, int(steps[lev]), k_t, out_dtype))
    return torch.cat(parts, dim=0)


def fold_tables_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/fold_tables.cu``, built at first use, with the
    argument types of its entries (one per fold dtype) set."""
    from ._build import load_library

    lib = load_library("fold_tables", verbose=verbose)
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for suffix in ("f64", "f32", "bf16"):
        fn = getattr(lib, f"fold_tables_{suffix}")
        if fn.argtypes is None:
            fn.argtypes = [p, ll, p, p, ll, p, p, i, p, p, p, p, i, i, i, i, p]
            fn.restype = i
    return lib
