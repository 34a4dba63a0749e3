"""Hand-written Hopper kernels of the port.

  fused_walk — the packed-plan canonical climb + window contraction, one
               CUDA launch per flush (``csrc/fused_walk.cu``); serves the
               static RFS forest and the DRFS exact-mode complete tree
  fused_leaf — the DRFS quantized tree phase: leaf-prefix difference +
               q_s ⊗ q_t window contraction, one CUDA launch per flush
               (``csrc/fused_leaf.cu``)

Each kernel ships with its plain PyTorch version in the same module (what a
CPU tensor gets) and a launching wrapper in ``ops`` that counts launches.
"""
from . import ops  # noqa: F401
