"""Decomposable kernel algebra (paper §3.3 Eq. 4 and §7).

Every supported kernel K with bandwidth b admits an *exact* finite
decomposition of the split form the whole paper rests on:

    K( (d_q + d_p) / b )  =  q_vec(d_q) . e_vec(d_p)            (Eq. 7)

where d_q is the lixel-side part of the distance (known only at query time)
and d_p is the event-side part (aggregatable at index time). Aggregated
vectors A = sum_i e_vec(d_p_i) are what ADA / RFS / DRFS store; queries dot
them with q_vec (the paper's Q·A).

Conditioning note (narrow-float adaptation): event-side features are evaluated on
*scaled* arguments u = d_p / s in [0, 1] (s = edge length spatially, the time
span temporally), which keeps high-order moments O(n) instead of O(n * d^m).
The scale is folded into the query vector:

  polynomial K(x) = sum_m c_m x^m:
      K((d_q + u s)/b) = sum_j [ sum_{m>=j} c_m C(m,j) (d_q/b)^{m-j} (s/b)^j ] u^j
      -> e_vec_j(u) = u^j              (bandwidth-free index!)
      -> q_vec_j(d_q) = sum_{m>=j} c_m C(m,j) (d_q/b)^{m-j} (s/b)^j

  exponential K(x) = e^-x:
      e^{-(d_q + u s)/b} = e^{-d_q/b} * e^{-u s/b}
      -> e_vec(u) = e^{-u (s/b)}       (index depends on s/b, fixed at build)

  cosine K(x) = cos(x):  angle addition ->
      q = [cos(d_q/b), -sin(d_q/b)], e = [cos(u s/b), sin(u s/b)]

q_vec accepts *negative* d_q — that is how all four geometric cases (via-v_c,
via-v_d, same-edge-left, same-edge-right) reuse the two stored event-side
feature sets without any parity bookkeeping (see rfs.py).

Beyond-paper: ``chebyshev_kernel`` decomposes *any* kernel (e.g. Gaussian,
which the paper lists but cannot decompose exactly) through a degree-m
Chebyshev expansion whose error converges geometrically in m — unlike the
fixed linear/quadratic bounds of KARL/QUAD cited in §7.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np

__all__ = [
    "DecomposableKernel",
    "PolynomialKernel",
    "ExponentialKernel",
    "CosineKernel",
    "ProductKernel",
    "triangular",
    "epanechnikov",
    "quartic",
    "cosine",
    "exponential",
    "chebyshev_kernel",
    "gaussian_cheb",
    "get_kernel",
]


class DecomposableKernel:
    """Interface: K(x) on x in [0, 1] with K((d_q+d_p)/b) = q_vec . e_vec."""

    name: str = "abstract"
    n_features: int = 0
    #: True if e_vec does not depend on (s / b) — polynomials qualify, so their
    #: index serves any bandwidth; transcendental kernels bind s/b at build.
    bandwidth_free: bool = False

    def __call__(self, x):  # kernel value, vectorized; domain [0, 1]
        raise NotImplementedError

    def e_vec(self, u, s_over_b):
        """Event-side features. u in [0,1]; returns [..., n_features]."""
        raise NotImplementedError

    def q_vec(self, dq_over_b, s_over_b):
        """Query-side coefficients. dq_over_b may be any sign; [..., n_features]."""
        raise NotImplementedError


@dataclasses.dataclass
class PolynomialKernel(DecomposableKernel):
    """K(x) = sum_m coeffs[m] * x^m (Triangular, Epanechnikov, Quartic, ...)."""

    coeffs: np.ndarray
    name: str = "polynomial"
    bandwidth_free: bool = True

    def __post_init__(self):
        self.coeffs = np.asarray(self.coeffs, dtype=np.float64)
        self.n_features = len(self.coeffs)
        m = self.n_features - 1
        # binomial table C(m, j)
        self._binom = np.zeros((m + 1, m + 1))
        for i in range(m + 1):
            for j in range(i + 1):
                self._binom[i, j] = math.comb(i, j)

    def __call__(self, x):
        x = np.asarray(x, dtype=np.float64)
        return np.polyval(self.coeffs[::-1], x)

    def e_vec(self, u, s_over_b):
        u = np.asarray(u, dtype=np.float64)
        return np.stack([u**j for j in range(self.n_features)], axis=-1)

    def q_vec(self, dq_over_b, s_over_b):
        xq = np.asarray(dq_over_b, dtype=np.float64)
        k = self.n_features
        out = np.zeros(xq.shape + (k,), dtype=np.float64)
        for j in range(k):
            acc = np.zeros_like(xq)
            for m in range(j, k):
                acc = acc + self.coeffs[m] * self._binom[m, j] * xq ** (m - j)
            out[..., j] = acc * (s_over_b**j)
        return out


class ExponentialKernel(DecomposableKernel):
    """K(x) = e^{-x} (paper §7.1). Exact one-feature decomposition."""

    name = "exponential"
    n_features = 1
    bandwidth_free = False

    def __call__(self, x):
        return np.exp(-np.asarray(x, dtype=np.float64))

    def e_vec(self, u, s_over_b):
        u = np.asarray(u, dtype=np.float64)
        return np.exp(-u * s_over_b)[..., None]

    def q_vec(self, dq_over_b, s_over_b):
        xq = np.asarray(dq_over_b, dtype=np.float64)
        return np.exp(-xq)[..., None]


class CosineKernel(DecomposableKernel):
    """K(x) = cos(x) (paper §7.2). Exact two-feature decomposition."""

    name = "cosine"
    n_features = 2
    bandwidth_free = False

    def __call__(self, x):
        return np.cos(np.asarray(x, dtype=np.float64))

    def e_vec(self, u, s_over_b):
        a = np.asarray(u, dtype=np.float64) * s_over_b
        return np.stack([np.cos(a), np.sin(a)], axis=-1)

    def q_vec(self, dq_over_b, s_over_b):
        xq = np.asarray(dq_over_b, dtype=np.float64)
        return np.stack([np.cos(xq), -np.sin(xq)], axis=-1)


@dataclasses.dataclass
class ProductKernel:
    """K_s x K_t multi-kernel combination (paper §7.3, Eq. 8).

    The combined feature space is the outer product:
    Q_ij = Q_i(q) Q_j(q), A_ij = A_i A_j, |A_ij| = |A_i| * |A_j| = O(1).
    Used by the indexes to lay out the event moment blocks.
    """

    spatial: DecomposableKernel
    temporal: DecomposableKernel

    @property
    def n_features(self) -> int:
        return self.spatial.n_features * self.temporal.n_features

    def combine_q(self, qs, qt):
        """outer(Q_s, Q_t) flattened on the last axis."""
        return (qs[..., :, None] * qt[..., None, :]).reshape(qs.shape[:-1] + (-1,))

    def combine_e(self, es, et):
        return (es[..., :, None] * et[..., None, :]).reshape(es.shape[:-1] + (-1,))


# ----------------------------------------------------------------- factories
def triangular() -> PolynomialKernel:
    k = PolynomialKernel(np.array([1.0, -1.0]))
    k.name = "triangular"
    return k


def epanechnikov() -> PolynomialKernel:
    k = PolynomialKernel(np.array([1.0, 0.0, -1.0]))
    k.name = "epanechnikov"
    return k


def quartic() -> PolynomialKernel:
    k = PolynomialKernel(np.array([1.0, 0.0, -2.0, 0.0, 1.0]))
    k.name = "quartic"
    return k


def cosine() -> CosineKernel:
    return CosineKernel()


def exponential() -> ExponentialKernel:
    return ExponentialKernel()


def uniform() -> PolynomialKernel:
    k = PolynomialKernel(np.array([1.0]))
    k.name = "uniform"
    return k


def chebyshev_kernel(
    fn: Callable[[np.ndarray], np.ndarray], degree: int, name: str = "chebyshev"
) -> PolynomialKernel:
    """Beyond-paper: decompose an arbitrary kernel via Chebyshev interpolation
    on [0, 1]; error converges geometrically in ``degree`` for smooth fn
    (contrast with the non-converging linear/quadratic bounds of [9, 15])."""
    cheb = np.polynomial.chebyshev.Chebyshev.interpolate(fn, degree, domain=[0.0, 1.0])
    poly = cheb.convert(kind=np.polynomial.polynomial.Polynomial)
    k = PolynomialKernel(np.asarray(poly.coef, dtype=np.float64))
    k.name = name
    return k


def gaussian_cheb(degree: int = 10) -> PolynomialKernel:
    """Gaussian kernel e^{-x^2} as a converging polynomial decomposition."""
    return chebyshev_kernel(lambda x: np.exp(-(x**2)), degree, name=f"gaussian_cheb{degree}")


_REGISTRY = {
    "triangular": triangular,
    "epanechnikov": epanechnikov,
    "quartic": quartic,
    "cosine": cosine,
    "exponential": exponential,
    "uniform": uniform,
    "gaussian": gaussian_cheb,
}


def get_kernel(name: str) -> DecomposableKernel:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
