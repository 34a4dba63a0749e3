"""Packed query plans: the host-side layer between planning and executors.

The query side of every solution decomposes into three reusable artifacts
(DESIGN.md §7):

  1. a **host plan** — the window-independent atoms of one (snapshot epoch,
     Lixel-Sharing mode) pair, chunked into flush-capped blocks, plus the
     deferred dominated-edge work and the planning statistics. Built by ONE
     walk of ``TNKDE.edge_geometries()`` and cached per epoch, so a warm
     query (or a serve batch on a pinned epoch) never re-plans: no Dijkstra,
     no geometry, no atom construction.
  2. **device atom packs** — the plan's blocks padded into size classes and
     uploaded, together with every window-independent derived quantity the
     executor needs (for the packed executor: the root position-rank
     interval of each atom). Cached inside the engines, keyed by the plan.
  3. **window tables** — the per-(snapshot, window batch) derived tables
     (rank boundaries, q_t-folded node values, leaf prefixes), cached by
     the ts tuple. Engines own these; this module provides the shared LRU.

The executors (NumPy oracle, gather-lean torch walk, fused CUDA kernel)
all consume the same plan; only the table packing differs per backend.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .plan import AtomSet

__all__ = [
    "HostPlan",
    "PlanCache",
    "build_host_plan",
    "chunk_atoms",
    "group_atoms_by_edge",
    "route_atoms_by_shard",
]


@dataclasses.dataclass
class HostPlan:
    """Window-independent query plan for one (epoch, LS-mode) pair."""

    key: tuple  # (epoch, lixel_sharing)
    blocks: List[AtomSet]  # flush-capped atom chunks (host arrays)
    dominated: List  # deferred LS work: (geom, side, candidate cols)
    n_atoms: int
    pairs: Tuple[int, int, int]  # (dominated, out-of-bandwidth, normal)

    @property
    def n_blocks(self) -> int:
        return len(self.blocks)


class PlanCache:
    """Tiny LRU for plans / packs / tables. Keys must be hashable; entries
    are opaque. ``get`` refreshes recency; eviction calls ``on_evict`` so
    engines can drop device arrays derived from the evicted entry."""

    def __init__(self, max_entries: int = 2, on_evict=None):
        self.max_entries = max(int(max_entries), 1)
        self._d: "OrderedDict" = OrderedDict()
        self._on_evict = on_evict

    def get(self, key):
        hit = self._d.get(key)
        if hit is not None:
            self._d.move_to_end(key)
        return hit

    def put(self, key, value) -> None:
        self._d[key] = value
        self._d.move_to_end(key)
        while len(self._d) > self.max_entries:
            old_key, old = self._d.popitem(last=False)
            if self._on_evict is not None:
                self._on_evict(old_key, old)

    def __len__(self) -> int:
        return len(self._d)

    def __contains__(self, key) -> bool:
        return key in self._d

    def values(self):
        return self._d.values()

    def clear(self) -> None:
        self._d.clear()


def chunk_atoms(parts: Sequence[AtomSet], cap: int) -> List[AtomSet]:
    """Concatenate per-edge atom sets into blocks of at most ``cap`` atoms.

    Block boundaries respect the per-geometry sets (an edge's atoms never
    straddle two blocks), so block shapes stay stable across queries.
    """
    blocks: List[AtomSet] = []
    pend: List[AtomSet] = []
    count = 0
    for p in parts:
        if p.m == 0:
            continue
        pend.append(p)
        count += p.m
        if count >= cap:
            blocks.append(AtomSet.concat(pend))
            pend, count = [], 0
    if pend:
        blocks.append(AtomSet.concat(pend))
    return blocks


def group_atoms_by_edge(atoms: AtomSet, q_pad: Optional[int] = None):
    """Route atoms into the per-edge grouped layout the fused kernel reads.

    Returns (edges [G], packed dict of [G, Qp] host arrays, Qp). ``q_pad``
    overrides the per-group atom capacity (size-classed so launch shapes
    repeat); padding rows have ``valid=False``, zero coefficients and
    empty selection intervals.
    """
    edges, inv = np.unique(atoms.edge, return_inverse=True)
    G = max(len(edges), 1)
    counts = np.bincount(inv, minlength=G) if atoms.m else np.zeros(G, np.int64)
    Q = max(int(counts.max(initial=1)), 1)
    Qp = max(int(q_pad or Q), Q)
    order = np.argsort(inv, kind="stable")
    slot = np.concatenate([np.arange(c) for c in counts]) if atoms.m else np.zeros(0, np.int64)
    row = np.repeat(np.arange(len(edges)), counts) if atoms.m else np.zeros(0, np.int64)

    def packed(x, fill=0):
        out = np.full((G, Qp) + x.shape[1:], fill, x.dtype)
        out[row, slot] = x[order]
        return out

    valid = np.zeros((G, Qp), bool)
    valid[row, slot] = True
    fields = dict(
        lixel=packed(atoms.lixel),
        side_feat=packed(atoms.side_feat.astype(np.int32)),
        qs=packed(atoms.qs, 0.0),
        pos_hi=packed(atoms.pos_hi, -np.inf),
        pos_lo1=packed(atoms.pos_lo1, np.inf),
        lo1_right=packed(atoms.lo1_right, False),
        pos_lo2=packed(atoms.pos_lo2, np.inf),
        valid=valid,
    )
    return edges, fields, Qp


def route_atoms_by_shard(
    atoms: AtomSet,
    shard_of_edge: np.ndarray,
    edge_slot: np.ndarray,
    n_shards: int,
    pad_to: Optional[int] = None,
):
    """Route a plan block's atoms to the shard owning their edge: [S, Mp].

    The sharded packing of :func:`chunk_atoms` blocks (DESIGN.md §3): atoms
    are grouped by ``shard_of_edge[atom.edge]``, their edge ids rewritten to
    the shard-LOCAL slots (``edge_slot``), and every shard padded to a
    common capacity — ``pad_to`` if given, else the per-shard max rounded
    to its ⅛-octave size class. Padding rows carry ``valid=False``, empty
    selection intervals and edge slot 0 — they decompose to an empty walk on
    any shard and belong to no segment of the scatter, so routing is safe
    even for shards that own no atoms.

    Returns a dict of host arrays matching ``torch_engine.FlatAtoms`` fields,
    bitwise the reference's. Window-independent: one routing serves every
    query window, exactly like the single-host pack.
    """
    S = max(int(n_shards), 1)
    shard = shard_of_edge[atoms.edge]
    order = np.argsort(shard, kind="stable")
    counts = np.bincount(shard, minlength=S)
    if pad_to is None:
        from .rfs import _size_class

        pad_to = _size_class(int(counts.max(initial=1)))
    mp = max(int(pad_to), int(counts.max(initial=1)), 1)
    offs = np.concatenate([[0], np.cumsum(counts)])

    def packed(x, fill=0):
        out = np.full((S, mp) + x.shape[1:], fill, x.dtype)
        for s in range(S):
            out[s, : counts[s]] = x[order[offs[s] : offs[s + 1]]]
        return out

    valid = np.zeros((S, mp), bool)
    for s in range(S):
        valid[s, : counts[s]] = True
    return dict(
        lixel=packed(atoms.lixel),
        edge=packed(edge_slot[atoms.edge]),
        side_feat=packed(atoms.side_feat.astype(np.int32)),
        qs=packed(atoms.qs, 0.0),
        pos_hi=packed(atoms.pos_hi, -np.inf),
        pos_lo1=packed(atoms.pos_lo1, np.inf),
        lo1_right=packed(atoms.lo1_right, False),
        pos_lo2=packed(atoms.pos_lo2, np.inf),
        valid=valid,
    )


def build_host_plan(
    model,
    key: tuple,
    *,
    flush_cap: int,
    ls: bool,
) -> HostPlan:
    """One planning walk of ``model.edge_geometries()`` → a cached HostPlan.

    ``model`` is the TNKDE instance. Lixel-Sharing classification happens
    here — dominated candidates are deferred into ``plan.dominated`` exactly
    as the inline path did.
    """
    from .lixel_sharing import classify_candidates
    from .plan import build_atoms

    parts: List[AtomSet] = []
    dominated: List = []
    n_dom = n_out = n_norm = 0
    for geom in model.edge_geometries():
        mask = None
        if ls:
            dom_c, dom_d, out, normal = classify_candidates(
                geom, model.ctx, model.ev_min_pos, model.ev_max_pos
            )
            n_dom += int(dom_c.sum() + dom_d.sum())
            n_out += int(out.sum())
            n_norm += int(normal.sum())
            mask = normal
            for side, dmask in ((0, dom_c), (1, dom_d)):
                cols = np.nonzero(dmask)[0]
                if len(cols):
                    dominated.append((geom, side, cols))
        atoms = build_atoms(geom, model.ctx, mask)
        if atoms.m:
            parts.append(atoms)
    blocks = chunk_atoms(parts, flush_cap)
    return HostPlan(
        key=key,
        blocks=blocks,
        dominated=dominated,
        n_atoms=sum(b.m for b in blocks),
        pairs=(n_dom, n_out, n_norm),
    )
