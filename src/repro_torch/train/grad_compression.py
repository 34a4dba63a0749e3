"""Error-feedback int8 gradient compression for the cross-pod reduction
(``repro.train.grad_compression``).

The reference runs inside a ``shard_map`` whose manual axis is ``'pod'``:
each pod member holds its own gradient and residual, shares one scale by
``pmax``, and sums the int8 payloads as int32 by ``psum``. In one process
the port's form takes the pod members' tensors as a list, in member order:
member ``i``'s are put on ``devices[i]`` (a ``ShardMesh``'s
``shard_devices(['pod'])``, as the sharded engines place their slabs). The
arithmetic is the reference's, so the means and residuals are bitwise its
own:

    y_i      = x_i + r_i                             (float32)
    scale    = max_i (max|y_i| / 127 + 1e-12)
    q_i      = clip(round(y_i / scale), -127, 127)   (int8, half to even)
    r_i'     = y_i - q_i · scale                     (what member i dropped)
    mean     = (Σ_i q_i as int32) · scale / n

The residual is rounded once, as XLA fuses ``y - q·scale`` into a
multiply-add: the product (≤ 8 + 24 bits) and the difference of two close
numbers are exact in float64, then rounded to float32.

Over processes (``mesh=``, a ``sharding.process.ProcessMesh``) each rank
passes its own block and residual: ``max|y|`` is first MAX-reduced over the
pod's own axes (the reference's scale is one per leaf over the whole
pod-local leaf, not one per block), the scale MAX-reduced across pods, the
payload summed across pods as int32; the same arithmetic, so the same bits.
"""
from __future__ import annotations

import torch

from repro_torch.train.optimizer import tree_fill, tree_leaves, tree_map

__all__ = ["quantize_int8", "dequantize_int8", "compressed_allreduce",
           "compressed_tree_allreduce", "init_residuals"]


def quantize_int8(x, scale):
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_allreduce(xs, residuals, devices=None, *, mesh=None, axis: str = "pod"):
    """Mean over the pod members of ``xs[i] + residuals[i]`` with an int8
    payload -> (float32 mean on the first member's device, [new residual of
    each member on its device]). ``devices[i]`` (default: where ``xs[i]``
    is) is member ``i``'s device.

    With a ``ProcessMesh`` ``mesh``, ``xs`` and ``residuals`` are this rank's
    block and residual and the members are the ranks along ``axis`` ->
    (this rank's block of the mean, its new residual)."""
    if mesh is not None:
        return _over_ranks(xs, residuals, mesh, axis)
    if len(xs) != len(residuals) or not xs:
        raise ValueError(f"compressed_allreduce: {len(xs)} members but {len(residuals)} "
                         "residuals")
    devices = [x.device for x in xs] if devices is None else [torch.device(d) for d in devices]
    ys = [x.to(d).float() + r.to(d) for x, r, d in zip(xs, residuals, devices)]
    home = devices[0]
    # the pmax of every member's own scale
    scale = torch.stack([(torch.max(torch.abs(y)) / 127.0 + 1e-12).to(home) for y in ys]).max()
    qs, new_res = [], []
    for y, d in zip(ys, devices):
        s = scale.to(d)
        q = quantize_int8(y, s)
        new_res.append((y.double() - q.double() * s.double()).float())  # one rounding
        qs.append(q)
    total = qs[0].to(home, torch.int32)
    for q in qs[1:]:  # the psum: int32, so any order gives the same sum
        total = total + q.to(home, torch.int32)
    n = torch.full((), float(len(xs)), dtype=torch.float32, device=home)
    return total.to(torch.float32) * scale / n, new_res


def _over_ranks(x, residual, mesh, axis):
    y = x.float() + residual
    m = torch.max(torch.abs(y))
    mesh.all_reduce(m, [a for a in mesh.axis_names if a != axis], op="max")  # the pod's leaf
    scale = mesh.all_reduce(m / 127.0 + 1e-12, [axis], op="max")  # the pmax
    q = quantize_int8(y, scale)
    new_res = (y.double() - q.double() * scale.double()).float()  # one rounding
    total = mesh.all_reduce(q.to(torch.int32), [axis])  # the psum, int32
    n = torch.full((), float(mesh.shape[axis]), dtype=torch.float32, device=y.device)
    return total.to(torch.float32) * scale / n, new_res


def compressed_tree_allreduce(grads, residuals, devices=None, *, mesh=None, axis: str = "pod"):
    """Leaf-wise :func:`compressed_allreduce` of the members' trees
    ``grads[i]`` with ``residuals[i]`` -> (mean tree, [residual tree of each
    member]); with a ``ProcessMesh`` ``mesh``, of this rank's trees ->
    (its blocks of the mean, its residual tree)."""
    if mesh is not None:
        pairs = [_over_ranks(g, r, mesh, axis)
                 for g, r in zip(tree_leaves(grads), tree_leaves(residuals))]
        return (tree_fill(grads, [m for m, _ in pairs]),
                tree_fill(residuals, [r for _, r in pairs]))
    flat = [tree_leaves(g) for g in grads]
    flat_r = [tree_leaves(r) for r in residuals]
    means, res = [], [[] for _ in grads]
    for j in range(len(flat[0])):
        mean, rs = compressed_allreduce([f[j] for f in flat], [f[j] for f in flat_r], devices)
        means.append(mean)
        for i, r in enumerate(rs):
            res[i].append(r)
    return tree_fill(grads[0], means), [tree_fill(r, v) for r, v in zip(residuals, res)]


def init_residuals(grads_shape):
    """Zero float32 residuals shaped like ``grads_shape``'s leaves."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
                    grads_shape)
