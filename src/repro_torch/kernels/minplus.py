"""Blocked (min, +) matrix product — the device relaxation step of batched
multi-source Bellman-Ford shortest paths
(:func:`repro_torch.core.shortest_path.minplus_bellman_ford`):
``out[i, j] = min_k a[i, k] + b[k, j]``.

It replaces the TPU kernel ``repro.kernels.minplus.minplus_matmul_pallas``
with ``csrc/minplus.cu`` (float32 and float64): 80 x 64 output tiles, a
10 x 8 register micro-tile of running minima per thread, the K loop fed by a
two-stage ``cp.async`` ring, edges handled in the kernel (no padded copy).
Every output is one rounding (``a + b``) followed by exact minima, so the
kernel equals the plain version here bitwise, whatever the order.

This module holds the plain PyTorch version, :func:`minplus_matmul_ref` —
what a CPU tensor gets and what the kernel is compared with on the card —
and the ``ctypes`` binding of the compiled kernel. The launching wrapper,
with its checks and launch count, is
:func:`repro_torch.kernels.ops.minplus_matmul`.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["minplus_matmul_ref", "minplus_library", "minplus_occupancy", "minplus_vec",
           "REF_CHUNK_ELEMS", "TILE"]

# the plain version builds an [rows, K, N] temporary per chunk of rows; this
# caps it (64 Mi elements: 512 MB in f64) so berkeley-size products fit
REF_CHUNK_ELEMS = 1 << 26
# the kernel's block tile (BM, BN, BK: csrc/minplus.cu; minplus_occupancy
# reports the compiled values)
TILE = (80, 64, 16)


def minplus_vec(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the kernel stages ``a [M, K]`` and ``b [K, N]`` with 16-byte
    copies (csrc/minplus.cu's vec form): K and N multiples of 16 bytes'
    worth of elements and both inputs 16-byte aligned; else one copy per
    element."""
    vw = 16 // a.element_size()
    return (a.shape[1] % vw == 0 and b.shape[1] % vw == 0 and a.data_ptr() % 16 == 0
            and b.data_ptr() % 16 == 0)


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
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.minplus_f32, lib.minplus_f64):
        if fn.argtypes is None:
            fn.argtypes = [p, p, p, i, i, i, i, i, p]
            fn.restype = i
    if lib.minplus_occupancy.argtypes is None:
        lib.minplus_occupancy.argtypes = [i, i, i, p]
        lib.minplus_occupancy.restype = i
    return lib


def minplus_occupancy(dtype: torch.dtype, vec: bool, device: int = 0) -> dict:
    """What the CUDA runtime says of one instantiation of the kernel on a
    card: blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    the card's SMs, and the tile and block size it was compiled with."""
    info = (ctypes.c_int * 6)()
    itemsize = torch.empty((), dtype=dtype).element_size()
    err = minplus_library().minplus_occupancy(itemsize, int(bool(vec)), int(device), info)
    if err != 0:
        raise RuntimeError(f"minplus_occupancy failed (cudaError {err})")
    return dict(blocks_per_sm=info[0], sms=info[1], tile_m=info[2], tile_n=info[3],
                tile_k=info[4], threads=info[5])
