"""Mixture-of-Experts block (OLMoE / Qwen3-MoE style): top-k router with
renormalised weights, sort-based capacity dispatch per batch row, batched
expert FFN, and a combine in a fixed order (``repro.models.moe``).

Routing runs in float32: softmax over the experts, then the top ``k`` with
ties broken towards the lower expert id (``lax.top_k``'s order). Dispatch is
independent in every batch row: the row's ``S·k`` routes are sorted by expert
id (stable), ranked within their expert, and a route of rank ``≥ C`` —
``C = int(ceil(S·k / E) · capacity_factor)`` — goes to slot ``C``, the
overflow sink, which the FFN never reads: a dropped route adds nothing
(standard dropping MoE). The expert FFN is the reference's three einsums
over the ``[B, E, C, d]`` buffer (cuBLAS batched over the experts).

The combine adds each token's ``k`` weighted expert outputs in the order
the reference's ``.at[ft[order]].add`` visits them — by expert id, in
``x.dtype`` — one elementwise add after another: no atomics, so the result
does not depend on the device's scheduling.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import Init
from repro_torch.models.mlp import _act

__all__ = ["init_moe", "moe_block", "route", "capacity", "dispatch"]


def init_moe(init: Init, cfg: ModelConfig, dtype, *, stack: int = 0):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    up = ("experts", "embed_fsdp", "expert_mlp")
    return {
        "router": init((d, E), ("embed_fsdp", "experts"), dtype=torch.float32, stack=stack),
        "w_gate": init((E, d, f), up, dtype=dtype, stack=stack),
        "w_up": init((E, d, f), up, dtype=dtype, stack=stack),
        "w_down": init((E, f, d), ("experts", "expert_mlp", "embed_fsdp"), dtype=dtype,
                       stack=stack),
    }


def route(p, x, cfg: ModelConfig):
    """Router of ``x [B, S, d]`` -> (logits [T, E] f32, probs [T, E],
    top_w [T, k] renormalised, top_e [T, k]), ``T = B·S``; among equal
    probabilities the lower expert id comes first."""
    k = cfg.moe_top_k
    logits = torch.matmul(x.reshape(-1, x.shape[-1]).float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = srt.values[:, :k], srt.indices[:, :k]
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, top_w, top_e


def capacity(cfg: ModelConfig, S: int) -> int:
    """Slots per (batch row, expert): ``int(ceil(S·k / E) · capacity_factor)``."""
    return int(-(-S * cfg.moe_top_k // cfg.n_experts) * cfg.capacity_factor)


def dispatch(top_e, B: int, S: int, cfg: ModelConfig):
    """Per batch row, in the routes' order sorted by expert id (stable):
    (order [B, S·k] route ids, slot [B, S·k] in ``[0, E·(C+1))``, keep
    [B, S·k]). Slot ``e·(C+1) + C`` is expert ``e``'s overflow sink."""
    E, C = cfg.n_experts, capacity(cfg, S)
    fe = top_e.reshape(B, -1)
    es, order = torch.sort(fe, dim=-1, stable=True)
    experts = torch.arange(E, device=fe.device).expand(B, E).contiguous()
    seg_start = torch.searchsorted(es, experts)
    rank = torch.arange(fe.shape[1], device=fe.device) - torch.gather(seg_start, 1, es)
    keep = rank < C
    slot = es * (C + 1) + torch.clamp(rank, max=C)
    return order, slot, keep


def moe_block(p, x, cfg: ModelConfig, batch_sum=None):
    """``x [B, S, d]`` -> (out [B, S, d] in ``x.dtype``, aux f32 scalar):
    ``aux = router_aux_coef · load_balance + 1e-3 · z``. With ``batch_sum``
    (``common.cross_entropy``'s) the router's statistics are the global
    batch's — the expert fractions summed over every rank's tokens, the means
    over the global token count — and ``aux`` this rank's share of them."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.moe_top_k
    C = capacity(cfg, S)
    logits, probs, top_w, top_e = route(p, x, cfg)

    # ---- aux losses (switch load balance + router z-loss)
    hit = torch.zeros_like(probs).scatter_(1, top_e, 1.0) > 0
    if batch_sum is None:
        lb = E * torch.sum(hit.float().mean(0) * probs.mean(0))
        z = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    else:
        tokens = batch_sum(torch.full((), float(probs.shape[0]), device=probs.device))
        frac = batch_sum(hit.float().sum(0)) / tokens
        lb = E * torch.sum(frac * (probs.sum(0) / tokens))
        z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2) / tokens
    aux = cfg.router_aux_coef * lb + 1e-3 * z

    # ---- dispatch into [B, E, C (+ sink), d]
    order, slot, keep = dispatch(top_e, B, S, cfg)
    tok = torch.div(order, k, rounding_mode="floor")  # each route's token
    rows = torch.arange(B, device=x.device)[:, None].expand_as(slot)
    buf = torch.zeros((B, E * (C + 1), d), dtype=x.dtype, device=x.device)
    # kept routes own their slots; the dropped ones all land in the sinks,
    # which are cut off unread (no host sync for a mask)
    buf[rows, slot] = x[rows, tok]
    buf = buf.reshape(B, E, C + 1, d)[:, :, :C]

    # ---- expert FFN: one batched product per expert over its B·C slots (a
    # broadcast matmul would copy every expert's weights once per batch row)
    act = _act(cfg)
    g = act(torch.einsum("becd,edf->becf", buf, p["w_gate"]))
    u = torch.einsum("becd,edf->becf", buf, p["w_up"])
    yb = torch.einsum("becf,efd->becd", g * u, p["w_down"])  # [B, E, C, d]

    # ---- combine: each route's output back in route order and weighted, then
    # per token its k outputs summed by ascending expert id in x.dtype
    flat = torch.nn.functional.pad(yb, (0, 0, 0, 1)).reshape(B, E * (C + 1), d)
    yk = torch.where(keep[..., None], torch.gather(flat, 1, slot[..., None].expand(-1, -1, d)),
                     torch.zeros((), dtype=flat.dtype, device=x.device))
    yk = torch.empty_like(yk).scatter_(1, order[..., None].expand(-1, -1, d), yk)
    contrib = (yk * top_w.reshape(B, -1, 1).to(yk.dtype)).reshape(B, S, k, d)
    by_expert = torch.argsort(top_e.reshape(B, S, k), dim=-1)
    contrib = torch.gather(contrib, 2, by_expert[..., None].expand(-1, -1, -1, d))
    out = contrib[:, :, 0]
    for j in range(1, k):
        out = out + contrib[:, :, j]
    return out.to(x.dtype), aux
