"""Hand-written Hopper kernels of the port.

  fused_walk — the packed-plan canonical climb + window contraction, one
               CUDA launch per flush (``csrc/fused_walk.cu``)

Each kernel ships with its plain PyTorch version in the same module (what a
CPU tensor gets) and a launching wrapper in ``ops`` that counts launches.
"""
from . import ops  # noqa: F401
