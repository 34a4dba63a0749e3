"""Window tables: device time a query of every kernel that is neither one
of the port's hand-written CUDA kernels nor a copy or a fill. On the RFS
fused path that is the plain-torch fold of ``torch_engine.packed_node_tables``
(searches, prefix gathers, the q_t contraction); the heatmap's zero fill and
its transpose before the one transfer count too where they run as kernels. Milliseconds a query; moves
``windows_per_s``."""

from tnkde_bench.harness.trace import is_copy, is_port_kernel


def read(run):
    if run.device is None or not run.n_queries:
        return None
    t = sum(v for k, v in run.device.kernels.items()
            if not is_port_kernel(k) and not is_copy(k))
    return t / run.n_queries * 1e3
