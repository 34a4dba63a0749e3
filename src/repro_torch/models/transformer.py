"""Decoder-only LM, every non-encdec family: init, forward, prefill, decode
cache, decode (``repro.models.transformer``).

Plain functions over a dict of tensors, not ``nn.Module``s: the parameter
tree is the reference's key for key and shape for shape, so weights and
caches carry across one-to-one (``models.weights``). Layers run in a Python
loop over views of stacks (the reference's ``lax.scan``):

* ``dense`` / ``moe``: ``layers`` holds every per-layer parameter stacked on
  a leading layer axis (``layers.attn.wq [L, d, H, hd]``, …); the moe family
  swaps the MLP for ``models.moe``. Cache ``{'k', 'v'}`` of
  ``[L, B, S, Kv, hd]``.
* ``rwkv``: ``ln0`` after the embedding, no rope, time mix + channel mix
  (``models.rwkv``). Cache ``{tm_x [L, B, d], tm_S [L, B, H, N, N] f32,
  cm_x [L, B, d]}``.
* ``hybrid`` (RecurrentGemma): ``pattern`` is a list with one stack of
  ``n_layers // len(block_pattern)`` layers per pattern position (``rec``:
  ``models.rglru``; ``attn``: causal attention in a sliding window),
  ``tail`` a list of the ``n_layers mod len(block_pattern)`` single layers
  that follow. The cache holds ``p{i}`` per position (``{conv, h}`` stacks
  for ``rec``, ring-buffer window ``{k, v}`` stacks for ``attn``) and
  ``tail``, a list of per-layer states. The reference's ``prefill`` and
  ``decode_step`` leave the tail out (ROADMAP Queue C item 11); the port
  runs it, so a config whose depth is a multiple of the pattern gives the
  reference's cache and answers, and any other the forward's. The window
  caches are ring buffers (position ``p`` at row ``p % win``, Queue C
  item 12).

M-RoPE (``cfg.mrope_sections``): ``forward`` and ``prefill`` take
``mrope_pos [B, 3, S]`` beside ``embeds``; decode uses text positions (plain
rope at ``pos``), as the reference does. There are no sharding constraints
(one card).

Training: ``loss_fn`` is the reference's (``ce + aux``), and ``forward``
runs each layer (the hybrid: each pattern period, then each tail layer)
under the activation-checkpoint policy ``cfg.remat``
(``common.maybe_remat``), as the reference's scan bodies do. Wherever a stacked tree is read (``layers``, a
``pattern`` stack), a list of per-layer trees may stand in for it
(:func:`layer_params`): the trainer passes per-layer views so that each
layer's gradient lands in its own leaf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru as rg
from repro_torch.models import rwkv as rk
from repro_torch.models.attention import attention, decode_attention, init_attention
from repro_torch.models.common import (Init, cross_entropy, dtype_of, maybe_remat,
                                       mrope_positions, rms_norm, rotary)
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe_block

__all__ = ["init_params", "build_params", "forward", "loss_fn", "prefill", "init_cache",
           "cache_axes", "decode_step", "layer_params"]

DECODE_LOOPS = ("scan", "fori")
_LONG = 4096  # the hybrid's pattern blocks: 'dense' attention up to here, 'blocked' above


# --------------------------------------------------------------------- init
def _init_position(init: Init, cfg: ModelConfig, dtype, kind, stack=0):
    f32 = torch.float32
    p = {"ln1": init((cfg.d_model,), ("embed",), dtype=f32, zeros=True, stack=stack),
         "ln2": init((cfg.d_model,), ("embed",), dtype=f32, zeros=True, stack=stack),
         "mlp": init_mlp(init, cfg, dtype, stack=stack)}
    if kind == "rec":
        p["rec"] = rg.init_rglru(init, cfg, dtype, stack=stack)
    else:
        p["attn"] = init_attention(init, cfg, dtype, stack=stack)
    return p


def _hybrid_split(cfg: ModelConfig):
    """(layers per pattern position, the tail's kinds)."""
    pat = cfg.block_pattern
    n_super = cfg.n_layers // len(pat)
    return n_super, pat[:cfg.n_layers - n_super * len(pat)]


def init_params(cfg: ModelConfig, seed: int = 0, *, device="cuda"):
    """Seeded random parameters on ``device`` (the card unless asked
    otherwise): the reference's tree and scales, another generator."""
    return build_params(cfg, Init(seed, device))


def build_params(cfg: ModelConfig, init: Init):
    """The parameter tree, each leaf made by ``init`` (which records its
    logical axes: ``init.axes(params)``)."""
    dtype = dtype_of(cfg.param_dtype)
    f32 = torch.float32
    L, d = cfg.n_layers, cfg.d_model
    params = {
        "embed": init((cfg.vocab, d), ("vocab", "embed_fsdp"), dtype=dtype, scale=d ** -0.5),
        "final_norm": init((d,), ("embed",), dtype=f32, zeros=True),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = init((d, cfg.vocab), ("embed_fsdp", "vocab"), dtype=dtype)
    if cfg.family == "rwkv":
        params["ln0"] = init((d,), ("embed",), dtype=f32, zeros=True)
        params["layers"] = {
            "ln1": init((d,), ("embed",), dtype=f32, zeros=True, stack=L),
            "tm": rk.init_time_mix(init, cfg, dtype, stack=L),
            "ln2": init((d,), ("embed",), dtype=f32, zeros=True, stack=L),
            "cm": rk.init_channel_mix(init, cfg, dtype, stack=L),
        }
    elif cfg.family == "hybrid":
        n_super, tail = _hybrid_split(cfg)
        params["pattern"] = [_init_position(init, cfg, dtype, kind, n_super)
                             for kind in cfg.block_pattern]
        params["tail"] = [_init_position(init, cfg, dtype, kind) for kind in tail]
    else:
        params["layers"] = {
            "ln1": init((d,), ("embed",), dtype=f32, zeros=True, stack=L),
            "attn": init_attention(init, cfg, dtype, stack=L),
            "ln2": init((d,), ("embed",), dtype=f32, zeros=True, stack=L),
            "mlp": (init_moe if cfg.family == "moe" else init_mlp)(init, cfg, dtype, stack=L),
        }
    return params


def layer_params(tree, i):
    """Views of layer ``i`` of a stacked tree (parameters or cache), or
    entry ``i`` of a list of per-layer trees."""
    if isinstance(tree, list):
        return tree[i]
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


# ------------------------------------------------------------------- blocks
def _rope_for(cfg: ModelConfig, positions, mrope_pos=None):
    if cfg.family == "rwkv":
        return None
    if cfg.mrope_sections is not None and mrope_pos is not None:
        return mrope_positions(mrope_pos, cfg.mrope_sections, cfg.hd, cfg.rope_theta)
    cos, sin = rotary(positions, cfg.hd, cfg.rope_theta)
    return cos[None, :, None, :], sin[None, :, None, :]


def _embed(params, cfg: ModelConfig, tokens, embeds):
    if embeds is None:
        # F.embedding: its CPU backward adds the rows in a fixed order (an
        # indexed read's does not), so training on the CPU is reproducible
        x = F.embedding(tokens, params["embed"]).to(dtype_of(cfg.compute_dtype))
    else:
        x = embeds.to(dtype_of(cfg.compute_dtype))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    if cfg.family == "rwkv":
        x = rms_norm(x, params["ln0"], cfg.norm_eps)
    return x


def _head(params, cfg: ModelConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.matmul(x, head)


def _ffn(lp, x, cfg: ModelConfig, batch_sum=None):
    """The block's second half: x + MLP (or MoE) of its norm -> (x, aux)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        m, aux = moe_block(lp["mlp"], h, cfg, batch_sum)
        return x + m, aux
    return x + mlp(lp["mlp"], h, cfg), 0.0


def _block(lp, x, cfg: ModelConfig, rope, attn_impl, batch_sum=None):
    """dense / moe block -> (x, (k, v), aux)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, kv = attention(lp["attn"], h, cfg, rope, causal=cfg.attn_kind == "causal",
                      impl=attn_impl)
    x, aux = _ffn(lp, x + a, cfg, batch_sum)
    return x, kv, aux


def _rwkv_block(lp, x, cfg: ModelConfig, st):
    """rwkv block from state ``st = {tm_x, tm_S, cm_x}`` -> (x, new state)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    a, (tm_x, tm_S) = rk.time_mix(lp["tm"], h, cfg, (st["tm_x"], st["tm_S"]))
    x = x + a
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    c, cm_x = rk.channel_mix(lp["cm"], h, cfg, st["cm_x"])
    return x + c, {"tm_x": tm_x, "tm_S": tm_S, "cm_x": cm_x}


def _hybrid_block(lp, x, cfg: ModelConfig, kind, rope, impl):
    """hybrid block over a full sequence from a zero state -> (x, state):
    ``rec`` gives its ``{conv, h}``, ``attn`` its K/V rows."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if kind == "rec":
        a, st = rg.rglru_block(lp["rec"], h, cfg,
                               rg.init_rglru_state(cfg, x.shape[0], x.dtype, device=x.device))
    else:
        a, st = attention(lp["attn"], h, cfg, rope, causal=True, window=cfg.local_window,
                          impl=impl)
    x = x + a
    return x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg), st


def _hybrid_layers(params, cfg: ModelConfig, S: int, attn_impl: str):
    """Every hybrid layer in order: (cache key ``p{i}`` or ``tail``, the
    layer's index in that stack or list, kind, params, attention impl). The
    pattern blocks take 'dense' up to 4 096 tokens and 'blocked' above,
    whatever ``attn_impl`` says; the tail takes it."""
    n_super, tail = _hybrid_split(cfg)
    impl = "dense" if S <= _LONG else "blocked"
    for s in range(n_super):
        for i, kind in enumerate(cfg.block_pattern):
            yield f"p{i}", s, kind, layer_params(params["pattern"][i], s), impl
    for i, kind in enumerate(tail):
        yield "tail", i, kind, params["tail"][i], attn_impl


def _rwkv_zero_state(cfg: ModelConfig, x):
    return rk.init_state(cfg, x.shape[0], x.dtype, device=x.device)


def forward(params, cfg: ModelConfig, tokens=None, *, embeds=None, mrope_pos=None,
            attn_impl: str = "auto", batch_sum=None):
    """Full-sequence forward -> (logits [B, S, V], aux): the moe family's
    summed router loss in float32 (its statistics over the global batch
    with ``batch_sum``, ``common.cross_entropy``'s), 0.0 for the others."""
    x = _embed(params, cfg, tokens, embeds)
    S = x.shape[1]
    if cfg.family == "rwkv":
        layer = maybe_remat(lambda x, lp: _rwkv_block(lp, x, cfg, _rwkv_zero_state(cfg, x))[0],
                            cfg.remat)
        for i in range(cfg.n_layers):
            x = layer(x, layer_params(params["layers"], i))
        return _head(params, cfg, x), 0.0
    rope = _rope_for(cfg, torch.arange(S, device=x.device), mrope_pos)
    if cfg.family == "hybrid":
        # checkpointed as the reference's scan is: one pattern period at a
        # time, then each tail layer
        n_super, tail = _hybrid_split(cfg)
        impl = "dense" if S <= _LONG else "blocked"

        def period(x, lps):
            for kind, lp in zip(cfg.block_pattern, lps):
                x, _ = _hybrid_block(lp, x, cfg, kind, rope, impl)
            return x

        period = maybe_remat(period, cfg.remat)
        for s in range(n_super):
            x = period(x, [layer_params(stack, s) for stack in params["pattern"]])
        for kind, lp in zip(tail, params["tail"]):
            x = maybe_remat(lambda x, lp, kind=kind:
                            _hybrid_block(lp, x, cfg, kind, rope, attn_impl)[0], cfg.remat)(x, lp)
        return _head(params, cfg, x), 0.0
    if cfg.family == "moe":
        layer = maybe_remat(lambda x, lp: _block(lp, x, cfg, rope, attn_impl, batch_sum)[::2],
                            cfg.remat)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_layers):
            x, a = layer(x, layer_params(params["layers"], i))
            aux = aux + a
        return _head(params, cfg, x), aux
    layer = maybe_remat(lambda x, lp: _block(lp, x, cfg, rope, attn_impl)[0], cfg.remat)
    for i in range(cfg.n_layers):
        x = layer(x, layer_params(params["layers"], i))
    return _head(params, cfg, x), 0.0


def loss_fn(params, cfg: ModelConfig, batch, *, attn_impl: str = "auto", batch_sum=None):
    """Training loss of a batch ``{tokens | embeds (+ mrope_pos), labels
    [B, S], mask [B, S] (optional)}`` -> (ce + aux, {"ce", "aux"}): the
    masked mean cross entropy (``common.cross_entropy``) plus the moe
    family's router loss; ``aux`` is a float32 tensor, 0 for the other
    families. With ``batch_sum`` the batch is this rank's rows of a global
    batch and the loss this rank's share of the global batch's."""
    logits, aux = forward(params, cfg, batch.get("tokens"), embeds=batch.get("embeds"),
                          mrope_pos=batch.get("mrope_pos"), attn_impl=attn_impl,
                          batch_sum=batch_sum)
    ce = cross_entropy(logits, batch["labels"], batch.get("mask"), batch_sum)
    if not isinstance(aux, torch.Tensor):
        aux = torch.full((), float(aux), dtype=torch.float32, device=ce.device)
    return ce + aux, {"ce": ce, "aux": aux}


# ------------------------------------------------------------------ serving
def prefill(params, cfg: ModelConfig, tokens=None, *, embeds=None, mrope_pos=None,
            attn_impl: str = "auto"):
    """Full-prompt forward that also materialises the decode cache.

    Returns (last-token logits [B, V], cache) with the layout of
    :func:`init_cache`, in the compute dtype (the rwkv ``tm_S`` and the
    hybrid ``h`` in float32). The hybrid's window caches keep the last
    ``win = min(local_window, S)`` K/V rows, position ``p`` at row
    ``p % win`` where decode's ring buffer looks for it. The reference keeps
    them in order from row 0, which is the same layout when ``S ≤ win`` or
    ``S`` is a multiple of ``win``; for any other ``S`` its first decode
    steps overwrite rows still in the window (ROADMAP Queue C item 12).
    """
    x = _embed(params, cfg, tokens, embeds)
    B, S = x.shape[0], x.shape[1]
    cdt = dtype_of(cfg.compute_dtype)
    if cfg.family == "rwkv":
        states = []
        for i in range(cfg.n_layers):
            x, st = _rwkv_block(layer_params(params["layers"], i), x, cfg, _rwkv_zero_state(cfg, x))
            states.append(st)
        cache = {k: torch.stack([st[k] for st in states]) for k in ("tm_x", "tm_S", "cm_x")}
        return _head(params, cfg, x[:, -1:])[:, 0], cache
    rope = _rope_for(cfg, torch.arange(S, device=x.device), mrope_pos)
    if cfg.family == "hybrid":
        win = min(cfg.local_window or S, S)
        per_pos, tail = {}, []
        for key, _, kind, lp, impl in _hybrid_layers(params, cfg, S, attn_impl):
            x, st = _hybrid_block(lp, x, cfg, kind, rope, impl)
            if kind == "attn":  # position p at ring row p % win (Queue C item 12)
                st = {n: t[:, S - win:].roll(S % win, dims=1).to(cdt)
                      for n, t in zip("kv", st)}
            (tail if key == "tail" else per_pos.setdefault(key, [])).append(st)
        cache = {key: {n: torch.stack([st[n] for st in sts]) for n in sts[0]}
                 for key, sts in per_pos.items()}
        cache["tail"] = tail
        return _head(params, cfg, x[:, -1:])[:, 0], cache
    cache = init_cache(cfg, B, S, dtype=cdt, device=x.device)
    for i in range(cfg.n_layers):
        x, (k, v), _ = _block(layer_params(params["layers"], i), x, cfg, rope, attn_impl)
        cache["k"][i] = k
        cache["v"][i] = v
    return _head(params, cfg, x[:, -1:])[:, 0], cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16, *,
               device="cuda"):
    """Zeroed decode cache (see the module docstring for each family's
    layout); the hybrid's windows hold ``min(local_window, max_seq)`` rows."""
    hd, Kv, L = cfg.hd, cfg.n_kv, cfg.n_layers
    z = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
    if cfg.family == "rwkv":
        st = rk.init_state(cfg, batch, dtype, device=device)
        return {k: torch.zeros((L, *v.shape), dtype=v.dtype, device=device)
                for k, v in st.items()}
    if cfg.family == "hybrid":
        n_super, tail = _hybrid_split(cfg)
        win = min(cfg.local_window or max_seq, max_seq)

        def state(kind, *lead):
            if kind == "rec":
                return {"conv": z(*lead, batch, cfg.conv_width - 1, cfg.d_rnn),
                        "h": z(*lead, batch, cfg.d_rnn, dt=torch.float32)}
            return {"k": z(*lead, batch, win, Kv, hd), "v": z(*lead, batch, win, Kv, hd)}

        cache = {f"p{i}": state(kind, n_super) for i, kind in enumerate(cfg.block_pattern)}
        cache["tail"] = [state(kind) for kind in tail]
        return cache
    return {"k": z(L, batch, max_seq, Kv, hd), "v": z(L, batch, max_seq, Kv, hd)}


_KV_AXES = ("cache_batch", "cache_seq", "kv_heads", "head_dim")


def cache_axes(cfg: ModelConfig):
    """The logical axes of :func:`init_cache`'s tree, leaf for leaf (the
    reference's ``init_cache`` returns them beside the cache): ``"layers"``
    leading on stacks; the hybrid's tail layers have none."""
    kv = {"k": ("layers",) + _KV_AXES, "v": ("layers",) + _KV_AXES}
    if cfg.family == "rwkv":
        return {"tm_x": ("layers", "cache_batch", "embed"),
                "tm_S": ("layers", "cache_batch", "heads", None, None),
                "cm_x": ("layers", "cache_batch", "embed")}
    if cfg.family == "hybrid":
        _, tail = _hybrid_split(cfg)

        def state(kind, lead):
            if kind == "rec":
                return {"conv": lead + ("cache_batch", None, "rnn"),
                        "h": lead + ("cache_batch", "rnn")}
            return {"k": lead + _KV_AXES, "v": lead + _KV_AXES}

        axes = {f"p{i}": state(kind, ("layers",)) for i, kind in enumerate(cfg.block_pattern)}
        axes["tail"] = [state(kind, ()) for kind in tail]
        return axes
    return kv


def decode_step(params, cfg: ModelConfig, token, cache, pos):
    """One decode step: ``token [B]`` at position ``pos`` (the write index)
    -> (logits [B, V], cache).

    Both of the reference's ``cfg.decode_loop`` names are accepted and run
    the same loop: the reference's ``'fori'`` exists only to keep XLA from
    copying the stacked cache through ``lax.scan``, and eager PyTorch has no
    such copy. Every state is updated in the given cache tensors in place,
    and the same cache is returned. The hybrid's window caches are ring
    buffers: the new K/V row goes to ``pos % win`` and attention reads
    ``min(pos + 1, win)`` rows.
    """
    if cfg.decode_loop not in DECODE_LOOPS:
        raise ValueError(f"decode_loop must be one of {DECODE_LOOPS}, got {cfg.decode_loop!r}")
    x = _embed(params, cfg, token[:, None], None)
    pos = int(pos)
    if cfg.family == "rwkv":
        for i in range(cfg.n_layers):
            st = layer_params(cache, i)
            x, new = _rwkv_block(layer_params(params["layers"], i), x, cfg, st)
            for k, v in new.items():
                st[k].copy_(v)
        return _head(params, cfg, x)[:, 0], cache
    rope = _rope_for(cfg, torch.tensor([pos], device=x.device))
    if cfg.family == "hybrid":
        for key, i, kind, lp, _ in _hybrid_layers(params, cfg, 1, "dense"):
            st = cache["tail"][i] if key == "tail" else layer_params(cache[key], i)
            h = rms_norm(x, lp["ln1"], cfg.norm_eps)
            if kind == "rec":
                a, new = rg.rglru_block(lp["rec"], h, cfg, st, chunk=1)
                st["conv"].copy_(new["conv"])
                st["h"].copy_(new["h"])
            else:
                win = st["k"].shape[1]
                a, _ = decode_attention(lp["attn"], h, cfg, rope, st["k"], st["v"], pos % win,
                                        valid_len=min(pos + 1, win))
            x = x + a
            x = x + mlp(lp["mlp"], rms_norm(x, lp["ln2"], cfg.norm_eps), cfg)
        return _head(params, cfg, x)[:, 0], cache
    ck, cv = cache["k"], cache["v"]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = decode_attention(lp["attn"], h, cfg, rope, ck[i], cv[i], pos)
        x, _ = _ffn(lp, x + a, cfg)
    return _head(params, cfg, x)[:, 0], cache
