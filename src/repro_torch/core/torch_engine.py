"""PyTorch port of the packed-plan RFS query engine (``repro.core.jax_engine``).

Same algorithm as rfs.RangeForest, expressed as plain functions on torch
tensors over the flat position-major tables, float64 throughout. No jit:
PyTorch runs eagerly, so the fixed-trip loops of the reference are Python
loops of branch-free tensor steps.

Window batching (the paper's multiple temporal KDE scenario, §8.2): one call
answers all W query windows. Each window center t contributes two *half
windows* ([t-b_t, t] and (t, t+b_t], the "doubled aggregations" of §3.3), so
the :class:`WindowBatch` has Wh = 2·W rows. Everything that does not depend
on the window — the atom's three position bounds, its spatial coefficient
vector q_s, its edge block — is stored once per atom.

The **packed-plan** executor (:class:`PackedForest` / :func:`packed_walk`,
DESIGN.md §7): a position-major transpose of the merge tree whose per-node
window values are q_t-folded once per (snapshot, window batch) at node-count
scale (:func:`packed_node_tables`, on the card one kernel launch), leaving
the per-atom walk one paired gather per level with window-independent [M]
state. The ``fused`` executor replaces that walk with one CUDA launch
(``repro_torch.kernels.fused_walk``) over the same tables. The ``kernel``
executor reads the time-major RangeForest tables instead
(:class:`FlatForest`): its window-side state is the [3, W, E] time-rank
table of :func:`rank_boundaries`, and its flush is one ``tree_query``
launch (``repro_torch.kernels.tree_query``).

The **DRFS** half (:class:`FlatDynamicForest`, :func:`dyn_window_tables`,
:func:`dyn_node_tables`, :func:`eval_atoms_dyn`) serves the streaming index
of ``drfs.DynamicRangeForest``: leaf-prefix tables (quantized mode) or
complete-tree node values (exact mode) per (structure epoch, window batch),
plus masked scans of the partially covered boundary leaves and of the
pending buffers.

Differences from the reference that matter to a reader:

* out-of-range gathers raise in torch where jnp clamps, so every
  ``clamp_min(i − 1, 0)`` / ``where(lo < hi, mid, 0)`` / ``clamp(…, 0, R2−1)``
  of the reference is kept;
* index state is int64 (what torch indexing takes natively); the rank
  intervals handed to the kernel are int32, converted once at pack time;
* contractions over the small feature axes are unrolled multiply-adds, not
  ``einsum``/``matmul``: elementwise kernels do the same arithmetic for
  every output element, so duplicate window centers come out bitwise
  identical on the GPU as well;
* a :class:`TableCodec` narrows only what the window tables *store*
  (float32 / bfloat16 rows); every executor widens each gathered row to
  float64 before it adds anything, where the reference computes in the
  table's dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import fold_tables, ops
from ..kernels.fold_tables import fold_level, seg_search, take, window_boundaries

__all__ = [
    "FlatAtoms",
    "FlatDynamicForest",
    "FlatForest",
    "PackedForest",
    "TableCodec",
    "WindowBatch",
    "dyn_node_base",
    "dyn_node_tables",
    "dyn_window_tables",
    "eval_atoms_dyn",
    "eval_atoms_flat",
    "eval_atoms_packed",
    "packed_forest_from_numpy",
    "packed_node_tables",
    "packed_root_ranks",
    "packed_walk",
    "rank_boundaries",
]

# fold   = dtype of the q_t-folded node-value tables (nodeval rows)
# moment = dtype of the leaf-prefix moment tables (quantized DRFS lcum)
# rtol   = build-time round-trip tolerance vs the f64 host tables; a table
#          whose cast loses more than this falls back to f64
_CODEC_PRESETS = {
    "f64": dict(fold=None, moment=None, rtol=0.0),
    "f32": dict(fold=torch.float32, moment=torch.float32, rtol=1e-5),
    "bf16": dict(fold=torch.bfloat16, moment=torch.float32, rtol=2e-2),
}


class TableCodec:
    """Storage dtype of the window tables the executors gather from (the
    reference's ``jax_engine.TableCodec``, DESIGN.md §12).

    * **fold tables** (q_t-folded node values: :func:`packed_node_tables`,
      :func:`dyn_node_tables`) are stored in ``fold_dtype``; the fold itself
      runs in f64 and only the finished values are cast;
    * **moment prefixes** (quantized DRFS leaf runs, :func:`dyn_window_tables`)
      are *delta-encoded*: the per-leaf window values are quantized to
      ``moment_dtype`` first, the prefix is summed in f64 over the quantized
      deltas, and the finished table is cast — a prefix difference recovers
      the quantized per-leaf value instead of cancelling two large prefixes.

    The reference's ``pack_index`` (int32 metadata under the narrow presets,
    called nowhere there) has no counterpart: the port's window-table
    metadata is int32 where its readers take int32 whatever the codec.
    The ``f64`` preset (``'auto'``) is the identity: the tables of the
    uncompressed layout, bit for bit. The narrow presets are validated at
    build (:meth:`validate`) against the f64 host moments; a codec whose
    round trip fails falls back to f64 in place and says why in
    ``fallback_reason``. What the port computes from the stored values is
    float64 in every executor (each gathered row is widened when it is
    loaded), where the reference computes in the table's dtype.
    """

    __slots__ = ("name", "fold_dtype", "moment_dtype", "rtol", "fallback_reason")

    def __init__(self, name="auto"):
        if isinstance(name, TableCodec):
            name = name.name
        name = "f64" if name in ("auto", None) else str(name)
        if name not in _CODEC_PRESETS:
            raise ValueError(
                f"unknown table codec {name!r}; pick from {sorted(_CODEC_PRESETS)} or 'auto'"
            )
        p = _CODEC_PRESETS[name]
        self.name = name
        self.fold_dtype = p["fold"]
        self.moment_dtype = p["moment"]
        self.rtol = p["rtol"]
        self.fallback_reason = None

    @property
    def is_identity(self) -> bool:
        return self.fold_dtype is None and self.moment_dtype is None

    @property
    def fold_itemsize(self) -> int:
        return 8 if self.fold_dtype is None else self.fold_dtype.itemsize

    @property
    def moment_itemsize(self) -> int:
        return 8 if self.moment_dtype is None else self.moment_dtype.itemsize

    def validate(self, host_moments) -> bool:
        """Build-time round-trip check of a moment table against f64.

        Casts the f64 host prefix moments through the narrowest storage
        dtype this codec uses and measures the relative round-trip error at
        the table's own scale. On failure (overflow to inf, or an error above
        the preset's tolerance) the codec degrades IN PLACE to the identity
        f64 layout and records ``fallback_reason``.
        """
        if self.is_identity:
            return True
        host = torch.from_numpy(np.ascontiguousarray(host_moments, dtype=np.float64))
        narrow = self.fold_dtype or self.moment_dtype
        rt = host.to(narrow).to(torch.float64)
        scale = (float(host.abs().max()) if host.numel() else 0.0) or 1.0
        err = (float((rt - host).abs().max()) if host.numel() else 0.0) / scale
        name = str(narrow).removeprefix("torch.")
        if not bool(torch.isfinite(rt).all()):
            self.fallback_reason = f"{name} overflow in moment table"
        elif err > self.rtol:
            self.fallback_reason = f"round-trip error {err:.3e} > rtol {self.rtol:.1e} for {name}"
        else:
            return True
        self.name = "f64"
        self.fold_dtype = self.moment_dtype = None
        self.rtol = 0.0
        return False

    def __repr__(self):
        return f"TableCodec({self.name!r})"


class FlatForest(NamedTuple):
    """Time-major flat merge-tree tables for a set of edges (see
    rfs.RangeForest): the layout of the ``kernel`` executor, whose per-edge
    grouped ``tree_query`` tables are slices of ``pos_flat``/``cum_flat``,
    and whose per-window time ranks come from :func:`rank_boundaries`."""

    pos_flat: torch.Tensor  # [T] position-sorted bucket tables (+inf pad)
    cum_flat: torch.Tensor  # [T, 4, K] inclusive per-bucket prefix moments
    edge_base: torch.Tensor  # [E] i64 flat offset of each edge's block
    n_pad: torch.Tensor  # [E] i64 padded event count (power of two; 0 = no events)
    n_lev: torch.Tensor  # [E] i64 level count (log2(n_pad) + 1; 0 = no events)
    time_flat: torch.Tensor  # [N] per-edge time-sorted event times
    time_ptr: torch.Tensor  # [E+1] i64 event offsets
    bridge: torch.Tensor  # [T] i32 left-child counts (zeros if not built)


class FlatAtoms(NamedTuple):
    """Flattened window-INDEPENDENT atoms (see plan.AtomSet)."""

    lixel: torch.Tensor  # [M] i64 output index
    edge: torch.Tensor  # [M] i64
    side_feat: torch.Tensor  # [M] i32 in {0, 1}: event features ψ_c / ψ_d
    qs: torch.Tensor  # [M, k_s] spatial coefficient vector
    pos_hi: torch.Tensor  # [M]
    pos_lo1: torch.Tensor  # [M]
    lo1_right: torch.Tensor  # [M] bool
    pos_lo2: torch.Tensor  # [M]
    valid: torch.Tensor  # [M] bool (padding mask)


class FlatDynamicForest(NamedTuple):
    """Flat position-bisection tree tables for DRFS (see drfs.DynamicRangeForest).

    Level-major packing: level d of the depth-(Lv-1) tree owns the slice
    [d·Np, d·Np + N) of every per-event table (Np = padded event capacity).
    ``node_ptr`` concatenates the per-level node CSRs (level d contributes
    E·2^d + 1 entries starting at offset E·(2^d − 1) + d; values are
    level-local in [0, N]). Events inside a node are time-sorted and carry
    inclusive prefix sums of Φ, so a query needs no position searches at
    all — the bisection structure resolves position, and only the *time*
    boundaries are binary-searched, once per (window, node) in
    :func:`dyn_window_tables` / :func:`dyn_node_tables`.

    The pending (unsealed) buffers ride along as a per-edge CSR sorted by
    (edge, time); queries scan them with a masked fixed-trip loop so
    ``insert -> query`` never waits for a rebuild.
    """

    time_lvl: torch.Tensor  # [Lv*Np] per-node time-sorted event times (+inf pad)
    pos_lvl: torch.Tensor  # [Lv*Np] event positions, same order
    cum_lvl: torch.Tensor  # [Lv*Np, 4, K] per-node inclusive prefix moments
    node_ptr: torch.Tensor  # [sum_d E*2^d + Lv] i64 concatenated per-level node CSRs
    edge_len: torch.Tensor  # [E]
    pend_ptr: torch.Tensor  # [E+1] i64 pending CSR by edge
    pend_pos: torch.Tensor  # [Pp]
    pend_time: torch.Tensor  # [Pp]
    pend_phi: torch.Tensor  # [Pp, 4, K]


class PackedForest(NamedTuple):
    """Position-major merge-tree tables — the packed-plan layout (DESIGN §7).

    Level ℓ buckets 2^ℓ consecutive POSITION-ranks of an edge; inside a
    bucket events are TIME-sorted and carry inclusive prefix sums of the raw
    moment block Φ. The per-query binary searches therefore run on the
    per-node axis: the time boundaries of a window batch are resolved once
    per (boundary, window, node) in :func:`packed_node_tables` — O(nodes)
    work, already contracted with q_t — and an atom only converts its three
    position bounds to a rank interval at the root
    (:func:`packed_root_ranks`, window-independent, cached in the plan) and
    walks the canonical ≤2-nodes-per-level decomposition gathering finished
    per-node values (:func:`packed_walk`, or the fused kernel).

    ``node_base[e, lev]`` maps (edge, walk level, bucket) to the flat node
    index of the value tables: id = node_base[e, lev] + bucket.
    """

    pm_pos: torch.Tensor  # [P] per-edge position-sorted values (+inf pad)
    pos_base: torch.Tensor  # [E] i64 flat offset of each edge's pm_pos block
    pm_time: torch.Tensor  # [T] level-major bucket tables, time-sorted
    pm_cum: torch.Tensor  # [T, 4, K] inclusive prefix moments (bucket-local)
    edge_base: torch.Tensor  # [E] i64 flat offset of each edge's level block
    n_pad: torch.Tensor  # [E] i64 padded event count (power of two; 0 = empty)
    n_lev: torch.Tensor  # [E] i64 level count
    node_base: torch.Tensor  # [E, Lmax] i64 flat node-id base per walk level


class WindowBatch(NamedTuple):
    """Per-half-window query tables: Wh = 2 · n_window_centers entries."""

    t_lo: torch.Tensor  # [Wh] window-half lower time bound
    t_hi: torch.Tensor  # [Wh] upper bound (always inclusive)
    lo_right: torch.Tensor  # [Wh] bool: lower bound exclusive? (right halves)
    half: torch.Tensor  # [Wh] i32 temporal orientation (0 = left, 1 = right)
    qt: torch.Tensor  # [Wh, k_t] temporal coefficient vector


def packed_forest_from_numpy(host: dict, device):
    """Upload ``build_packed_host_tables`` output: ``(PackedForest, meta)``.

    ``host`` is exactly the dict of numpy arrays that function returns
    (``pm_pos, pos_base, pm_time, pm_cum, edge_base, n_pad, n_lev,
    node_base, node_starts, n_nodes, steps_per_level``) — from this package
    or from the reference's ``repro.core.rfs.build_packed_host_tables``, so
    index state built there can be served here. Float tables become float64
    tensors, index tables int64. ``meta`` carries the node starts (one flat
    level-major tensor, ``starts``, and its host level offsets, ``lvl_ptr``),
    the [Lmax, E] walk-level node bases, the per-level search trip counts and
    the node count.
    """
    dev = torch.device(device)

    def f64(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.float64), device=dev)

    def i64(x):
        return torch.as_tensor(np.ascontiguousarray(x, dtype=np.int64), device=dev)

    pf = PackedForest(
        pm_pos=f64(host["pm_pos"]),
        pos_base=i64(host["pos_base"]),
        pm_time=f64(host["pm_time"]),
        pm_cum=f64(host["pm_cum"]),
        edge_base=i64(host["edge_base"]),
        n_pad=i64(host["n_pad"]),
        n_lev=i64(host["n_lev"]),
        node_base=i64(host["node_base"]),
    )
    meta = dict(
        # every node's run start, level-major, flat: level ℓ's nodes are
        # starts[lvl_ptr[ℓ]:lvl_ptr[ℓ+1]]
        starts=i64(np.concatenate(host["node_starts"])),
        lvl_ptr=tuple(np.cumsum([0] + [len(s) for s in host["node_starts"]]).tolist()),
        # walk-level -> node base, transposed for per-level row indexing
        node_base_lvl=i64(np.asarray(host["node_base"]).T),
        steps_per_level=tuple(int(s) for s in host["steps_per_level"]),
        n_nodes=int(host["n_nodes"]),
    )
    return pf, meta


def rank_boundaries(forest: FlatForest, wb: WindowBatch, *, search_steps: int):
    """Per-(boundary, window, edge) time-rank boundaries: [3, W, E] i32.

    The (lo, mid, hi) ranks of every window center against every edge's
    time-sorted events — independent of atoms, so the plan computes them
    once per (snapshot, window batch) and every flush re-uses them.
    """
    tp = forest.time_ptr
    s_lo = tp[:-1][None, None, :]
    t_b, right_b = window_boundaries(wb.t_lo, wb.t_hi)
    r_b = seg_search(forest.time_flat, s_lo, tp[1:][None, None, :],
                     t_b[..., None], right_b[..., None], search_steps) - s_lo
    return r_b.to(torch.int32)


# ======================================================= search / cascade
# The two time-major executors of the reference (``executor='search'`` and
# ``'cascade'``): plain torch on the flat forest, no kernel. Every gather
# index is clamped into its table where the reference's gathers clamp
# (lanes whose answer is masked off may point past a table's end).
def _pref_diff(table, combo, seg_lo, i_lo, i_hi, on):
    """Masked per-bucket moment difference prefix(i_hi) − prefix(i_lo): [..., C].

    ``table [T, n_combo, C]``; seg_lo/i_lo/i_hi/on broadcast to a common
    shape, ``combo`` into the gather. The hi and lo prefix rows ride one
    stacked gather. Emits moment vectors: the engines accumulate them across
    levels and contract with q_s ⊗ q_t once at the end."""
    i_hi = torch.maximum(i_hi, i_lo)
    ii = torch.stack(torch.broadcast_tensors(i_hi, i_lo))  # [2, ...]
    row = (ii - 1).clamp(0, table.shape[0] - 1)
    v = table[row, combo.expand(ii.shape[1:])[None].expand(ii.shape)]  # [2, ..., C]
    v = torch.where((ii > seg_lo[None])[..., None], v, 0.0)
    return torch.where(on[..., None], v[0] - v[1], 0.0)


def _contract(mom, qs, qt):
    """Factored query contraction Σ_(s,t) (q_s[m, s]·q_t[w, t])·mom[w, m, s, t]:
    [W', M] from ``mom [W', M, k_s·k_t]``, ``qs [M, k_s]``, ``qt [W', k_t]``.
    Unrolled multiply-adds in a fixed (s, t) order, s-major (see the module
    note on duplicate window centers)."""
    k_s, k_t = qs.shape[1], qt.shape[1]
    m4 = mom.reshape(mom.shape[:-1] + (k_s, k_t))
    val = None
    for s in range(k_s):
        for t in range(k_t):
            term = (qs[None, :, s] * qt[:, None, t]) * m4[..., s, t]
            val = term if val is None else val + term
    return val


def _engine_search(forest: FlatForest, atoms: FlatAtoms, wb: WindowBatch, combo, r_lo, r_hi,
                   *, max_levels: int, search_steps: int):
    """Canonical ≤2-buckets-per-level decomposition with three position
    searches per bucket (the reference's ``executor='search'``): [Wh, M].

    Per level the left bucket ``l`` and the right bucket ``r − 1`` are
    searched together (their bounds do not depend on each other's emission)
    in one stacked search of ``min(search_steps, lev + 1)`` trips — a bucket
    of 2^lev rows needs no more, and the trips beyond are no-ops — and
    added in the reference's order (left, then right)."""
    Wh, M = r_lo.shape
    eid = atoms.edge
    base = forest.edge_base[eid][None]
    npad = forest.n_pad[eid][None]
    q = torch.stack([atoms.pos_hi, atoms.pos_lo1, atoms.pos_lo2])[:, None, None]  # [3,1,1,M]
    ones = torch.ones_like(atoms.lo1_right)
    right = torch.stack([ones, atoms.lo1_right, ~ones])[:, None, None]
    K = forest.cum_flat.shape[-1]
    mom = torch.zeros((Wh, M, K), dtype=forest.cum_flat.dtype, device=eid.device)
    l = r_lo.to(torch.int64)
    r = r_hi.to(torch.int64)
    for lev in range(max_levels):
        b = torch.stack([l, r - 1])  # [2, Wh, M]
        seg_lo = base + lev * npad + (b << lev)
        seg_hi = seg_lo + (1 << lev)
        i = seg_search(forest.pos_flat, seg_lo[None], seg_hi[None], q, right,
                       min(search_steps, lev + 1))  # [3, 2, Wh, M]
        i_lo = torch.maximum(i[1], i[2])
        active = l < r
        emit_l = active & ((l & 1) == 1)
        mom = mom + _pref_diff(forest.cum_flat, combo, seg_lo[0], i_lo[0], i[0][0], emit_l)
        l = torch.where(emit_l, l + 1, l)
        emit_r = (l < r) & ((r & 1) == 1)
        mom = mom + _pref_diff(forest.cum_flat, combo, seg_lo[1], i_lo[1], i[0][1], emit_r)
        r = torch.where(emit_r, r - 1, r)
        l, r = l >> 1, r >> 1
    return _contract(mom, atoms.qs, wb.qt)


def _engine_cascade(forest: FlatForest, atoms: FlatAtoms, wb: WindowBatch, ranks, *,
                    max_levels: int, search_steps: int):
    """Prefix-path walks over the cascade bridges, one per window BOUNDARY
    (the reference's ``executor='cascade'``): [Wh, M].

    Each center w contributes three rank boundaries (lo, mid, hi); the
    half-window aggregates are prefix differences, left = G(mid) − G(lo) and
    right = G(hi) − G(mid). The position bounds are binary-searched once per
    atom in the root bucket (window independent; the two lower bounds
    collapse to one rank there), and each walk step pays two bridge gathers
    and one paired prefix-moment gather (``cum`` viewed as [T, side, 2K]).
    G(k) emits the fully covered left children along the path of rank k,
    plus the root when k == npad and the leaf itself when the path bottoms
    out on an odd rank."""
    Wh = wb.t_lo.shape[0]
    W = Wh // 2
    M = atoms.edge.shape[0]
    K = forest.cum_flat.shape[-1]
    dev = atoms.edge.device
    eid = atoms.edge
    base = forest.edge_base[eid]  # [M]
    npad = forest.n_pad[eid]
    nlev = forest.n_lev[eid]
    top = (nlev - 1).clamp_min(0)
    k = ranks[:, :, eid].to(torch.int64)  # [3, W, M]

    # ---- window-independent: root-bucket position searches ---------------
    root_lo = base + top * npad
    q = torch.stack([atoms.pos_hi, atoms.pos_lo1, atoms.pos_lo2])
    ones = torch.ones(M, dtype=torch.bool, device=dev)
    right = torch.stack([ones, atoms.lo1_right, ~ones])
    j = seg_search(forest.pos_flat, root_lo[None], (root_lo + npad)[None], q, right,
                   search_steps)  # [3, M]
    root_loc = torch.stack([j[0], torch.maximum(j[1], j[2])]) - root_lo[None]  # [2, M]

    cum2 = forest.cum_flat.reshape(-1, 2, 2 * K)
    side = atoms.side_feat.to(torch.int64)[None, None]  # [1, 1, M]
    npb = npad[None, None]
    bsb = base[None, None]
    full0 = (npb > 0) & (k == npb)
    s_root = root_lo[None, None]
    mom = _pref_diff(cum2, side, s_root, s_root + root_loc[1][None, None],
                     s_root + root_loc[0][None, None], full0)  # [3, W, M, 2K]
    zero = torch.zeros((3, W, M), dtype=torch.int64, device=dev)
    lev = top[None, None] + zero
    node = zero
    loc = root_loc[:, None, None, :] + zero[None]  # [2, 3, W, M] local (hi, lo) ranks
    active = (npb > 0) & (k > 0) & ~full0
    one = torch.ones_like(lev)
    for _ in range(max_levels):
        a0 = node << lev
        active = active & (k > a0)  # the boundary landed on a node edge: done
        half = (one << lev) >> 1
        go_right = active & (lev > 0) & (k >= a0 + half)
        nf = bsb + lev * npb + a0  # the parent bucket's flat offset
        bl = torch.where(loc > 0, take(forest.bridge, nf[None] + (loc - 1).clamp_min(0)), 0)
        bl = bl.to(torch.int64)
        emit_leaf = active & (lev == 0)
        on = go_right | emit_leaf
        s_emit = torch.where(emit_leaf, nf, nf - npb)  # the left child starts at a0
        hi_loc = torch.where(emit_leaf, loc[0], bl[0])
        lo_loc = torch.where(emit_leaf, loc[1], bl[1])
        mom = mom + _pref_diff(cum2, side, s_emit, s_emit + lo_loc, s_emit + hi_loc, on)
        desc = active & (lev > 0)
        loc = torch.where(desc[None], torch.where(go_right[None], loc - bl, bl), loc)
        node = torch.where(desc, (node << 1) + go_right.to(torch.int64), node)
        lev = torch.where(desc, lev - 1, lev)
        active = active & ~emit_leaf
    val_l = _contract((mom[1] - mom[0])[..., :K], atoms.qs, wb.qt[0::2])
    val_r = _contract((mom[2] - mom[1])[..., K:], atoms.qs, wb.qt[1::2])
    return torch.stack([val_l, val_r], dim=1).reshape(Wh, M)


def eval_atoms_flat(forest: FlatForest, atoms: FlatAtoms, wb: WindowBatch, ranks, *,
                    max_levels: int, search_steps: int, cascade: bool = False):
    """Per-atom aggregated Q·A for every half-window over the time-major
    flat forest (the ``search`` / ``cascade`` executors): [Wh, M].

    Callers fold the two halves of each center and scatter the M axis onto
    lixels. Requires the paired ``make_window_batch`` row layout; ``ranks``
    is the :func:`rank_boundaries` table [3, W, E] of the window batch."""
    if cascade:
        acc = _engine_cascade(forest, atoms, wb, ranks, max_levels=max_levels,
                              search_steps=search_steps)
    else:
        Wh = wb.t_lo.shape[0]
        M = atoms.edge.shape[0]
        k = ranks[:, :, atoms.edge].to(torch.int64)  # [3, W, M]
        r_lo = torch.stack([k[0], k[1]], dim=1).reshape(Wh, M)
        r_hi = torch.stack([k[1], k[2]], dim=1).reshape(Wh, M)
        combo = atoms.side_feat.to(torch.int64)[None, :] * 2 + wb.half.to(torch.int64)[:, None]
        acc = _engine_search(forest, atoms, wb, combo, r_lo, r_hi, max_levels=max_levels,
                             search_steps=search_steps)
    return torch.where(atoms.valid[None, :], acc, 0.0)


def packed_root_ranks(pf: PackedForest, atoms: FlatAtoms, *, search_steps: int):
    """Window-independent position-rank interval [r_lo, r_hi) per atom: [M] i32.

    The packed executor's only per-atom searches: the three position bounds
    are resolved against the edge's position-sorted root row in ONE batched
    search (stacked bound axis) and collapse to two ranks. Cached inside the
    plan's atom blocks, so steady-state flushes pay no searches at all.
    Padded atoms (pos_hi = −inf, pos_lo* = +inf) come out with r_lo == r_hi.
    """
    M = atoms.edge.shape[0]
    dev = atoms.edge.device
    eid = atoms.edge
    s_lo = pf.pos_base[eid]
    s_hi = s_lo + pf.n_pad[eid]
    q = torch.stack([atoms.pos_hi, atoms.pos_lo1, atoms.pos_lo2])
    right = torch.stack(
        [
            torch.ones(M, dtype=torch.bool, device=dev),
            atoms.lo1_right,
            torch.zeros(M, dtype=torch.bool, device=dev),
        ]
    )
    j = seg_search(pf.pm_pos, s_lo[None], s_hi[None], q, right, search_steps) - s_lo[None]
    r_hi = j[0]
    r_lo = torch.minimum(torch.maximum(j[1], j[2]), r_hi)
    return r_lo.to(torch.int32), r_hi.to(torch.int32)


def packed_node_tables(
    pf: PackedForest,
    wb: WindowBatch,
    starts: torch.Tensor,
    *,
    lvl_ptr: tuple,
    steps_per_level: tuple,
    k_t: int,
    out_dtype=None,
):
    """q_t-folded paired window values of EVERY position-rank node: [R·2, W, C].

    ``starts`` holds the flat pm_time offset of every node's time-sorted run,
    level-major: level ℓ's nodes, runs of 2^ℓ, are
    ``starts[lvl_ptr[ℓ]:lvl_ptr[ℓ+1]]`` (``packed_forest_from_numpy``'s meta). Per node
    the three window boundaries are binary-searched in the run — O(nodes)
    total, NOT O(atoms) — the raw-Φ prefix rows are differenced node-locally
    and contracted with the temporal query vectors immediately, so the walk
    gathers finished values. Row (node, side) = [k_s left-half | k_s right],
    with the W axis inside the row: one walk gather moves every window's
    value for a node at once. Node ids follow ``pf.node_base`` level-major.
    The fold is :func:`repro_torch.kernels.ops.fold_node_tables`: on the card
    one launch for every level, writing the table once in ``out_dtype`` (the
    codec's fold dtype); on the CPU its plain version, ``FOLD_CHUNK`` nodes
    at a time (same values, bounded transient memory), each chunk cast before
    the concatenation, so the whole f64 table is never held beside its
    narrow copy.
    """
    return ops.fold_node_tables(pf.pm_time, pf.pm_cum, starts, wb.t_lo, wb.t_hi, wb.qt,
                                lvl_ptr=lvl_ptr, steps=steps_per_level, k_t=k_t,
                                out_dtype=out_dtype)


def packed_walk(nodeval, node_base_lvl, eid, side, r_lo, r_hi, *, max_levels: int):
    """Canonical ≤2-nodes-per-level walk over finished node values: [M, W, C].

    ``node_base_lvl`` [Lmax, E] maps walk levels to flat node bases. State
    is [M] ints — no window axis — and each level pays exactly ONE paired
    gather ([2, M] node rows, every window riding inside the row). The
    gathered rows are widened to f64 before they are added (a narrow codec
    table), never the table.
    """
    M = eid.shape[0]
    R2, W, C = nodeval.shape
    acc = torch.zeros((M, W, C), dtype=torch.float64, device=nodeval.device)
    l = r_lo.to(torch.int64)
    r = r_hi.to(torch.int64)
    side = side.to(torch.int64)
    for lev in range(max_levels):
        nb = node_base_lvl[lev][eid]
        emit_l = (l < r) & ((l & 1) == 1)
        b_l = l
        l = torch.where(emit_l, l + 1, l)
        emit_r = (l < r) & ((r & 1) == 1)
        b_r = r - 1
        r = torch.where(emit_r, r - 1, r)
        on = torch.stack([emit_l, emit_r])  # [2, M]
        idx = (nb[None] + torch.stack([b_l, b_r])) * 2 + side[None]
        idx = torch.where(on, idx, 0).clamp(0, R2 - 1)
        rows = nodeval[idx].to(torch.float64)  # [2, M, W, C] — one paired gather per level
        rows = torch.where(on[..., None, None], rows, 0.0)
        acc = acc + (rows[0] + rows[1])
        l, r = l >> 1, r >> 1
    return acc


def eval_atoms_packed(
    nodeval, node_base_lvl, atoms: FlatAtoms, r_lo, r_hi, *, max_levels: int
):
    """Packed-plan per-atom aggregate for every half-window: [Wh, M].

    Row order is (w0 left, w0 right, w1 left, ...); callers fold halves and
    scatter onto lixels. Consumes precomputed root rank intervals +
    q_t-folded node value tables.
    """
    k_s = atoms.qs.shape[1]
    M = atoms.edge.shape[0]
    acc = packed_walk(
        nodeval, node_base_lvl, atoms.edge, atoms.side_feat, r_lo, r_hi,
        max_levels=max_levels,
    )
    # unrolled multiply-add over k_s (see the module note on duplicate
    # window centers)
    val_l = acc[..., 0] * atoms.qs[:, None, 0]  # [M, W]
    val_r = acc[..., k_s] * atoms.qs[:, None, 0]
    for s in range(1, k_s):
        val_l = val_l + acc[..., s] * atoms.qs[:, None, s]
        val_r = val_r + acc[..., k_s + s] * atoms.qs[:, None, s]
    out = torch.stack([val_l.T, val_r.T], dim=1).reshape(-1, M)
    return torch.where(atoms.valid[None, :], out, 0.0)


# ===================================================================== DRFS
def _dyn_leaf_range(forest: FlatDynamicForest, atoms: FlatAtoms, hq: int):
    """Fully-covered leaf range [leaf_lo, leaf_hi) at depth hq: [M] i64 each.

    Mirrors drfs.DynamicRangeForest.leaf_range, with min/max/clip done in the
    float domain *before* the int cast so the ±inf pads of invalid atoms
    collapse to empty ranges instead of tripping undefined float->int casts.
    """
    lens = forest.edge_len[atoms.edge]
    nleaf = 1 << hq
    w_leaf = lens / nleaf
    hi_ok = torch.floor(atoms.pos_hi / w_leaf).clamp_max(float(nleaf))
    hi_ok = torch.where(atoms.pos_hi >= lens, float(nleaf), hi_ok.clamp_min(0.0))
    lo1, lo2 = atoms.pos_lo1, atoms.pos_lo2
    lo1_leaf = torch.where(
        torch.isfinite(lo1),
        torch.where(
            atoms.lo1_right,
            torch.floor(lo1 / w_leaf) + 1.0,  # need leaf start strictly > lo1
            torch.ceil(lo1 / w_leaf),
        ),
        0.0,
    )
    lo2_leaf = torch.where(torch.isfinite(lo2), torch.ceil(lo2 / w_leaf), 0.0)
    leaf_lo = torch.maximum(lo1_leaf, lo2_leaf).clamp(0.0, float(nleaf))
    leaf_hi = hi_ok.clamp(0.0, float(nleaf))
    return leaf_lo.to(torch.int64), leaf_hi.to(torch.int64)


def _dyn_pos_mask(atoms: FlatAtoms, p):
    """Event-position acceptance against the atom's three bounds: [M] bool."""
    lo1_ok = torch.where(atoms.lo1_right, p > atoms.pos_lo1, p >= atoms.pos_lo1)
    return (p <= atoms.pos_hi) & lo1_ok & (p >= atoms.pos_lo2)


def _dyn_level_runs(forest: FlatDynamicForest, d: int, Np: int):
    """(s_lo, s_hi) [E·2^d] i64: every depth-d node's run in the level tables."""
    E = forest.pend_ptr.shape[0] - 1
    NL = E << d
    pb = E * ((1 << d) - 1) + d  # node_ptr offset of level d's CSR block
    return (d * Np + forest.node_ptr[pb : pb + NL],
            d * Np + forest.node_ptr[pb + 1 : pb + NL + 1])


def dyn_window_tables(forest: FlatDynamicForest, wb: WindowBatch, *, n_levels: int,
                      hq: int, search_steps: int, out_dtype=None):
    """Per-(window, leaf-node) aggregates, prefix-summed along each edge.

    The key hoist of the dynamic engine (DESIGN.md §5): the time boundaries
    depend only on the *window*, and the bisection tree's leaves at depth hq
    partition every edge, so the window-restricted moment of each leaf is
    resolved ONCE per query — per (boundary, window, leaf) binary search +
    prefix gather over the leaf's time-sorted run — and prefix-summed along
    the leaf axis of each edge. An atom's fully-covered range then costs two
    O(1) gathers (``Lcum[leaf_hi] − Lcum[leaf_lo]``).

    Returns lcum [E·(nleaf+1)·2, W, 2K]: per (leaf-prefix, side) row the raw
    paired moment vector [K left-half | K right-half] for every window (W
    rides INSIDE the row). Raw Φ space: q_t is applied only after the caller
    differences two prefixes, the association of the NumPy path. Leaves are
    resolved ``fold_tables.FOLD_CHUNK`` at a time (same values, bounded
    transient memory).

    ``out_dtype`` (the codec's moment dtype) stores the table delta-encoded:
    each per-leaf value is quantized to ``out_dtype`` first, the prefix is
    summed in f64 over the quantized deltas, and the finished table is cast,
    so a prefix difference recovers the quantized per-leaf value.
    """
    W = wb.t_lo.shape[0] // 2
    K = forest.cum_lvl.shape[-1]
    Np = forest.time_lvl.shape[0] // n_levels
    E = forest.pend_ptr.shape[0] - 1
    nleaf = 1 << hq
    s_lo_all, s_hi_all = _dyn_level_runs(forest, hq, Np)
    t_b, right_b = window_boundaries(wb.t_lo, wb.t_hi)
    parts = []
    chunk = fold_tables.FOLD_CHUNK
    for c0 in range(0, E * nleaf, chunk):
        s_lo = s_lo_all[c0 : c0 + chunk]
        i_b = seg_search(
            forest.time_lvl, s_lo[None, None], s_hi_all[c0 : c0 + chunk][None, None],
            t_b[..., None], right_b[..., None], search_steps,
        )  # [3, W, n]
        v = forest.cum_lvl[(i_b - 1).clamp_min(0)]  # [3, W, n, 4, K]
        p = torch.where((i_b > s_lo[None, None])[..., None, None], v, 0.0)
        # per-leaf window moments, paired per side: [.., side] = [K left | K right]
        left = (p[1] - p[0])[..., 0::2, :]  # [W, n, 2, K] combos (ψ·left)
        right = (p[2] - p[1])[..., 1::2, :]  # combos (ψ·right)
        lv = torch.cat([left, right], dim=-1)  # [W, n, 2, 2K]
        if out_dtype is not None:  # delta encoding: quantize the per-leaf values
            lv = lv.to(out_dtype).to(torch.float64)
        parts.append(lv)
    # per-edge inclusive leaf prefix (f64) with a leading zero row, laid out
    # row-major [E·(nleaf+1)·2, W, 2K] for one-stacked-gather addressing —
    # contiguous, so a flush reads the rows in place: the permute alone is a
    # strided view, and every reshape of it to [rows, W·2K] would copy the
    # whole table again. One copy does the permute and the storage cast.
    cum = torch.cat(parts, dim=1).reshape(W, E, nleaf, 2, 2 * K).cumsum(dim=2)
    cum = torch.cat([torch.zeros_like(cum[:, :, :1]), cum], dim=2)
    out = torch.empty((E, nleaf + 1, 2, W, 2 * K), dtype=out_dtype or torch.float64,
                      device=cum.device)
    out.copy_(cum.permute(1, 2, 3, 0, 4))
    return out.reshape(E * (nleaf + 1) * 2, W, 2 * K)


def dyn_node_tables(forest: FlatDynamicForest, wb: WindowBatch, *, n_levels: int,
                    hq: int, steps_per_level: tuple, out_dtype=None):
    """q_t-contracted window moments of EVERY tree node up to depth hq.

    The exact-mode companion of :func:`dyn_window_tables`: each node's time
    window is resolved in its own run (per-level trip counts) and q_t is
    folded immediately (``fold_tables.fold_level``), so the per-atom canonical
    walk gathers node-local values — the rounding locality of the NumPy
    node decomposition.

    Returns the packed node-value layout :func:`packed_walk` and the fused
    kernel consume: nodeval [TN·2, W, 2k_s] with TN = E·(2^{hq+1}−1); node
    (d, e, i) lives at flat row (E·(2^d−1) + e·2^d + i)·2 + side.
    ``out_dtype`` (the codec's fold dtype) casts each folded chunk, as in
    :func:`packed_node_tables`.
    """
    Np = forest.time_lvl.shape[0] // n_levels
    k_t = wb.qt.shape[1]
    t_b, right_b = window_boundaries(wb.t_lo, wb.t_hi)
    qtl, qtr = wb.qt[0::2], wb.qt[1::2]
    chunk = fold_tables.FOLD_CHUNK
    parts = []
    for d in range(hq + 1):
        s_lo, s_hi = _dyn_level_runs(forest, d, Np)
        for c0 in range(0, s_lo.shape[0], chunk):
            parts.append(
                fold_level(
                    forest.time_lvl, forest.cum_lvl, s_lo[c0 : c0 + chunk],
                    s_hi[c0 : c0 + chunk], t_b, right_b, qtl, qtr,
                    int(steps_per_level[d]), k_t, out_dtype,
                )
            )
    return torch.cat(parts, dim=0)


def dyn_node_base(E: int, hq: int, device=None):
    """[hq+1, E] i64 complete-tree node bases for :func:`packed_walk`: walk
    level ``lev`` reads depth d = hq − lev, whose edge-e block starts at
    E·(2^d − 1) + e·2^d in the :func:`dyn_node_tables` layout."""
    e = torch.arange(E, dtype=torch.int64, device=device)
    return torch.stack([E * ((1 << (hq - lev)) - 1) + e * (1 << (hq - lev))
                        for lev in range(hq + 1)])


def eval_atoms_dyn(forest: FlatDynamicForest, atoms: FlatAtoms, wb: WindowBatch, tables,
                   *, n_levels: int, hq: int, scan_steps: int, pend_steps: int,
                   exact: bool, tree: bool = True):
    """DRFS per-atom aggregate for every half-window: [Wh, M].

    Row order is (w0 left, w0 right, w1 left, ...); callers fold halves and
    scatter onto lixels. Three phases, all window-batched:

      1. the fully-covered leaf range [leaf_lo, leaf_hi) at depth ``hq``.
         Quantized mode: two gathers into the per-edge leaf prefix tables
         (``tables`` = (:func:`dyn_window_tables`,)). Exact mode: the
         canonical ≤2-nodes-per-level walk over :func:`dyn_node_tables`
         (``tables`` = (nodeval,)). ``tree=False`` skips this phase (the
         fused executor answers it with one kernel launch);
      2. ``exact`` mode: the ≤2 partially covered boundary leaves, scanned
         ``scan_steps`` masked trips (≥ max leaf occupancy);
      3. pending (unsealed) events: a masked per-edge CSR scan of
         ``pend_steps`` trips (≥ max per-edge pending count), so streaming
         inserts are visible without any rebuild.

    The fixed-trip ``fori_loop`` of the reference is a Python loop of
    masked trips here. The final contraction with q_s ⊗ q_t is unrolled
    multiply-adds in a fixed (s, t) order — no ``einsum`` (see the module
    note on duplicate window centers).
    """
    Wh = wb.t_lo.shape[0]
    W = Wh // 2
    M = atoms.edge.shape[0]
    K = forest.cum_lvl.shape[-1]
    Np = forest.time_lvl.shape[0] // n_levels
    E = forest.pend_ptr.shape[0] - 1
    dev, dt = forest.cum_lvl.device, forest.cum_lvl.dtype
    eid = atoms.edge
    side = atoms.side_feat.to(torch.int64)
    nleaf = 1 << hq
    t_b, _ = window_boundaries(wb.t_lo, wb.t_hi)
    k_s = atoms.qs.shape[1]
    k_t = wb.qt.shape[1]

    # ---- phase 1: fully-covered leaf range [leaf_lo, leaf_hi) -------------
    leaf_lo, leaf_hi = _dyn_leaf_range(forest, atoms, hq)
    leaf_hi = torch.maximum(leaf_hi, leaf_lo)
    # scan phases accumulate raw Φ moments (q_t applied at the end)
    mom_l = torch.zeros((W, M, K), dtype=dt, device=dev)
    mom_r = torch.zeros((W, M, K), dtype=dt, device=dev)
    acc = None
    if exact and tree:
        (nodeval,) = tables
        acc = packed_walk(nodeval, dyn_node_base(E, hq, dev), eid, side, leaf_lo, leaf_hi,
                          max_levels=hq + 1)  # [M, W, 2k_s]
    elif tree:
        (lcum,) = tables
        base = eid * ((nleaf + 1) * 2) + side
        # [2, M, W, 2K], widened before the difference (a narrow codec table)
        rows = lcum[base[None] + torch.stack([leaf_hi, leaf_lo]) * 2].to(torch.float64)
        tv = (rows[0] - rows[1]).permute(1, 0, 2)  # [W, M, 2K]
        mom_l = mom_l + tv[..., :K]  # paired halves
        mom_r = mom_r + tv[..., K:]

    def masked_event_scan(mom_l, mom_r, s_lo, s_hi, on, times, poss, steps, prefix):
        """Fixed-trip scan of the per-atom runs [s_lo, s_hi), masked by on.
        ``prefix``: Φ rows differenced from the inclusive per-node prefix
        table (sealed levels), else gathered raw (pending buffer)."""
        table = (forest.cum_lvl if prefix else forest.pend_phi).reshape(-1, 2, 2 * K)
        for j in range(steps):
            i = s_lo + j
            valid = on & (i < s_hi)
            idx = torch.where(valid, i, 0)
            te = times[idx]
            p = poss[idx]
            row = table[idx, side]  # [M, 2K]
            if prefix and j > 0:
                row = row - table[(idx - 1).clamp_min(0), side]
            keep = valid & _dyn_pos_mask(atoms, p)
            m_l = (te[None] >= t_b[0][:, None]) & (te[None] <= t_b[1][:, None])  # [W, M]
            m_r = (te[None] > t_b[1][:, None]) & (te[None] <= t_b[2][:, None])
            mom_l = mom_l + torch.where((m_l & keep[None])[..., None], row[None, :, :K], 0.0)
            mom_r = mom_r + torch.where((m_r & keep[None])[..., None], row[None, :, K:], 0.0)
        return mom_l, mom_r

    # ---- phase 2 (exact mode): partially covered boundary leaves ----------
    if exact and scan_steps > 0:
        lens = forest.edge_len[eid]
        w_leaf = lens / nleaf
        pb = E * (nleaf - 1) + hq
        inf = float("inf")
        lo_eff = torch.maximum(
            torch.where(torch.isfinite(atoms.pos_lo1), atoms.pos_lo1, -inf),
            torch.where(torch.isfinite(atoms.pos_lo2), atoms.pos_lo2, -inf),
        )
        cl = torch.where(
            torch.isfinite(lo_eff),
            torch.floor(lo_eff / w_leaf).clamp(0.0, nleaf - 1.0),
            -1.0,
        ).to(torch.int64)
        cu_f = torch.floor(atoms.pos_hi.clamp_min(0.0) / w_leaf).clamp(-1.0, nleaf - 1.0)
        cu = torch.where((atoms.pos_hi >= lens) | (atoms.pos_hi < 0), -1.0, cu_f).to(torch.int64)
        ok_cl = (cl >= 0) & (cl < leaf_lo)
        ok_cu = (cu >= 0) & ((cu < leaf_lo) | (cu >= leaf_hi)) & ~(ok_cl & (cu == cl))
        for leaf, ok in ((cl, ok_cl), (cu, ok_cu)):
            pidx = pb + eid * nleaf + leaf.clamp(0, nleaf - 1)
            mom_l, mom_r = masked_event_scan(
                mom_l, mom_r, hq * Np + forest.node_ptr[pidx],
                hq * Np + forest.node_ptr[pidx + 1], ok,
                forest.time_lvl, forest.pos_lvl, scan_steps, True,
            )

    # ---- phase 3: pending (unsealed) events -------------------------------
    if pend_steps > 0:
        mom_l, mom_r = masked_event_scan(
            mom_l, mom_r, forest.pend_ptr[eid], forest.pend_ptr[eid + 1],
            torch.ones(M, dtype=torch.bool, device=dev),
            forest.pend_time, forest.pend_pos, pend_steps, False,
        )

    # ---- contraction with the factored query: Σ_(s,t) (q_s·q_t)·mom, s-major
    qtl, qtr = wb.qt[0::2], wb.qt[1::2]  # [W, k_t]
    ml = mom_l.reshape(W, M, k_s, k_t)
    mr = mom_r.reshape(W, M, k_s, k_t)
    val_l = val_r = None
    for s in range(k_s):
        q_s = atoms.qs[None, :, s]  # [1, M]
        for t in range(k_t):
            tl = (q_s * qtl[:, None, t]) * ml[..., s, t]
            tr = (q_s * qtr[:, None, t]) * mr[..., s, t]
            val_l = tl if val_l is None else val_l + tl
            val_r = tr if val_r is None else val_r + tr
    if acc is not None:
        wl = acc[..., 0] * atoms.qs[:, None, 0]  # [M, W]
        wr = acc[..., k_s] * atoms.qs[:, None, 0]
        for s in range(1, k_s):
            wl = wl + acc[..., s] * atoms.qs[:, None, s]
            wr = wr + acc[..., k_s + s] * atoms.qs[:, None, s]
        val_l = val_l + wl.T
        val_r = val_r + wr.T
    out = torch.stack([val_l, val_r], dim=1).reshape(Wh, M)
    return torch.where(atoms.valid[None, :], out, 0.0)
