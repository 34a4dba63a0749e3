"""Hand-written Hopper kernels of the port.

  fused_walk     — the packed-plan canonical climb + window contraction, one
                   CUDA launch per flush (``csrc/fused_walk.cu``) reading the
                   flat window table in place (float64, float32 or bfloat16,
                   the table codec's fold dtype); serves the static RFS forest
                   and the DRFS exact-mode complete tree
  fused_leaf     — the DRFS quantized tree phase: leaf-prefix difference +
                   q_s ⊗ q_t window contraction, one CUDA launch per flush
                   (``csrc/fused_leaf.cu``), on the flat leaf table in place
                   (float64 or float32)
  tree_query     — the ``executor='kernel'`` RFS flush: per (atom,
                   half-window) canonical time-rank decomposition with three
                   position searches per bucket (``csrc/tree_query.cu``)
  dyn_leaf_query — the ``executor='kernel'`` DRFS quantized tree phase over
                   materialised query vectors (``csrc/dyn_leaf_query.cu``)
  dyn_node_walk  — the ``executor='kernel'`` DRFS exact tree phase: launches
                   ``csrc/fused_walk.cu`` on the complete tree in place
  minplus_matmul — the (min, +) product, one launch per Bellman-Ford round
                   of ``core.shortest_path.minplus_bellman_ford``
                   (``csrc/minplus.cu``, f32 and f64)
  fold_node_tables — the packed RFS executors' window-table fold: every
                   node's time searches, prefix differences and q_t
                   contraction, one CUDA launch per fold writing the table in
                   the codec's fold dtype (``csrc/fold_tables.cu``)
  flash_attention — forward online-softmax attention of the LM prefill /
                   forward path with ``attn_impl='kernel'``, one launch per
                   layer (``csrc/flash_attention.cu``, bf16 and f32 inputs)

Each kernel ships with its plain PyTorch version in the same module (what a
CPU tensor gets) and a launching wrapper in ``ops`` that counts launches.
"""
from . import ops  # noqa: F401
