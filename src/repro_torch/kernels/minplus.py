"""Blocked (min, +) matrix product — the device relaxation step of batched
multi-source Bellman-Ford shortest paths
(:func:`repro_torch.core.shortest_path.minplus_bellman_ford`):
``out[i, j] = min_k a[i, k] + b[k, j]``.

It replaces the TPU kernel ``repro.kernels.minplus.minplus_matmul_pallas``
with ``csrc/minplus.cu`` (float32 and float64): shared-memory tiles of ``a``
and ``b`` and a register micro-tile of running minima per thread, edges
handled by bounds checks (no padded copy). Every output is one rounding
(``a + b``) followed by exact minima, so the kernel equals the plain version
here bitwise, whatever the order.

This module holds the plain PyTorch version, :func:`minplus_matmul_ref` —
what a CPU tensor gets and what the kernel is compared with on the card —
and the ``ctypes`` binding of the compiled kernel. The launching wrapper,
with its checks and launch count, is
:func:`repro_torch.kernels.ops.minplus_matmul`.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["minplus_matmul_ref", "minplus_library", "REF_CHUNK_ELEMS"]

# the plain version builds an [rows, K, N] temporary per chunk of rows; this
# caps it (64 Mi elements: 512 MB in f64) so berkeley-size products fit
REF_CHUNK_ELEMS = 1 << 26


def minplus_matmul_ref(a: torch.Tensor, b: torch.Tensor, *, out: torch.Tensor | None = None):
    """``out[i, j] = min_k a[i, k] + b[k, j]``: ``a [M, K]``, ``b [K, N]``,
    one dtype; ``[M, N]`` of that dtype. Plain PyTorch, chunked over rows so
    it never holds more than ``REF_CHUNK_ELEMS`` candidates at once. The
    torch transcription of ``repro.kernels.ref.minplus_matmul``."""
    M, K = a.shape
    N = b.shape[1]
    if out is None:
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    if K == 0:
        return out.fill_(float("inf"))
    rows = max(1, REF_CHUNK_ELEMS // max(K * N, 1))
    for lo in range(0, M, rows):
        hi = min(M, lo + rows)
        torch.amin(a[lo:hi, :, None] + b[None], dim=1, out=out[lo:hi])
    return out


def minplus_library(*, verbose: bool = False) -> ctypes.CDLL:
    """The compiled ``csrc/minplus.cu``, built at first use, with the
    argument types of ``minplus_f32`` / ``minplus_f64`` set (pointers and the
    stream are ``c_void_p``: ctypes would otherwise cut them to 32 bits)."""
    from ._build import load_library

    lib = load_library("minplus", verbose=verbose)
    for fn in (lib.minplus_f32, lib.minplus_f64):
        if fn.argtypes is None:
            p, i = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, p, p, i, i, i, i, p]
            fn.restype = i
    return lib
