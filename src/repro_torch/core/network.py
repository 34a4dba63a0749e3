"""Road network representation and lixelization (paper §3.1, Defs 3.1-3.2).

A road network is an undirected weighted graph G=(V,E). Each edge is divided
into fixed-length segments ("lixels", Def 3.2); each lixel's *center point* is
the query position q. Everything is stored as dense NumPy arrays (CSR
adjacency) so the same structures feed the NumPy reference path, the JAX
device engines and kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["RoadNetwork", "Lixels", "build_lixels"]


@dataclasses.dataclass
class RoadNetwork:
    """Undirected road network.

    Attributes:
      n_vertices: |V|
      edge_src, edge_dst: int32 [E] endpoint vertex ids (each undirected edge
        stored once; adjacency covers both directions)
      edge_len: float64 [E] positive edge lengths (metres)
      csr_indptr, csr_indices, csr_edge_id, csr_weight: CSR adjacency over both
        directions; csr_edge_id maps an adjacency slot back to the edge id.
    """

    n_vertices: int
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_len: np.ndarray
    csr_indptr: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    csr_indices: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    csr_edge_id: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]
    csr_weight: np.ndarray = dataclasses.field(default=None)  # type: ignore[assignment]

    def __post_init__(self):
        self.edge_src = np.asarray(self.edge_src, dtype=np.int32)
        self.edge_dst = np.asarray(self.edge_dst, dtype=np.int32)
        self.edge_len = np.asarray(self.edge_len, dtype=np.float64)
        if self.edge_src.shape != self.edge_dst.shape or self.edge_src.shape != self.edge_len.shape:
            raise ValueError("edge arrays must share a shape")
        if np.any(self.edge_len <= 0):
            raise ValueError("edge lengths must be positive")
        if self.csr_indptr is None:
            self._build_csr()

    # ------------------------------------------------------------------ CSR
    def _build_csr(self) -> None:
        e = self.n_edges
        heads = np.concatenate([self.edge_src, self.edge_dst])
        tails = np.concatenate([self.edge_dst, self.edge_src])
        eids = np.concatenate([np.arange(e, dtype=np.int32)] * 2)
        w = np.concatenate([self.edge_len, self.edge_len])
        order = np.argsort(heads, kind="stable")
        heads, tails, eids, w = heads[order], tails[order], eids[order], w[order]
        indptr = np.zeros(self.n_vertices + 1, dtype=np.int64)
        np.add.at(indptr, heads + 1, 1)
        np.cumsum(indptr, out=indptr)
        self.csr_indptr = indptr
        self.csr_indices = tails.astype(np.int32)
        self.csr_edge_id = eids
        self.csr_weight = w.astype(np.float64)

    # ------------------------------------------------------------ properties
    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])

    def degree(self, v: int) -> int:
        return int(self.csr_indptr[v + 1] - self.csr_indptr[v])

    def neighbors(self, v: int):
        lo, hi = self.csr_indptr[v], self.csr_indptr[v + 1]
        return self.csr_indices[lo:hi], self.csr_weight[lo:hi], self.csr_edge_id[lo:hi]

    def total_length(self) -> float:
        return float(self.edge_len.sum())

    def validate(self) -> None:
        if self.edge_src.max(initial=-1) >= self.n_vertices:
            raise ValueError("edge_src out of range")
        if self.edge_dst.max(initial=-1) >= self.n_vertices:
            raise ValueError("edge_dst out of range")

    def dense_adjacency(self, inf: float = np.inf) -> np.ndarray:
        """Dense min-plus adjacency matrix (for a min-plus shortest-path kernel)."""
        a = np.full((self.n_vertices, self.n_vertices), inf, dtype=np.float64)
        np.fill_diagonal(a, 0.0)
        for s, d, w in zip(self.edge_src, self.edge_dst, self.edge_len):
            if w < a[s, d]:
                a[s, d] = w
                a[d, s] = w
        return a


@dataclasses.dataclass
class Lixels:
    """All lixels of a network for a given lixel length g (Def 3.2).

    Lixel i lives on edge ``edge_id[i]`` with its *center* at ``pos[i]`` metres
    from the edge's ``src`` endpoint. ``edge_ptr`` is a CSR-style offset table:
    lixels of edge e are ``[edge_ptr[e], edge_ptr[e+1])`` and appear in
    ascending position order (the paper's q_1..q_{l_e} indexing).
    """

    g: float
    edge_id: np.ndarray  # int32 [L]
    pos: np.ndarray  # float64 [L] distance from edge src to lixel center
    edge_ptr: np.ndarray  # int64 [E+1]

    @property
    def n_lixels(self) -> int:
        return int(self.edge_id.shape[0])

    def count_on_edge(self, e: int) -> int:
        return int(self.edge_ptr[e + 1] - self.edge_ptr[e])


def build_lixels(net: RoadNetwork, g: float) -> Lixels:
    """Divide every edge into ceil(len/g) segments of length g (last one may be
    shorter); lixel centers follow the paper's convention (center of segment).
    """
    if g <= 0:
        raise ValueError("lixel length must be positive")
    counts = np.ceil(net.edge_len / g).astype(np.int64)
    edge_ptr = np.zeros(net.n_edges + 1, dtype=np.int64)
    np.cumsum(counts, out=edge_ptr[1:])
    total = int(edge_ptr[-1])
    edge_id = np.repeat(np.arange(net.n_edges, dtype=np.int32), counts)
    # index of the lixel within its edge
    local = np.arange(total, dtype=np.int64) - np.repeat(edge_ptr[:-1], counts)
    start = local * g
    end = np.minimum(start + g, net.edge_len[edge_id])
    pos = (start + end) / 2.0
    return Lixels(g=float(g), edge_id=edge_id, pos=pos, edge_ptr=edge_ptr)
