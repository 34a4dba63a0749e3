"""The port's hybrid family (recurrentgemma-9b: RG-LRU + local attention)
against the JAX package on the CPU, at ``reduce_for_smoke`` size (window 32)
on the reference's own weights, rtol = atol = 2e-4 in float32.

At 3 layers (one pattern period, no tail) the port equals the reference in
``forward``, ``prefill`` (logits and every cache leaf), ``decode_step``
(logits and cache after each step) and when decoding past the window, step
for step. At 5 layers (a period and a 2-layer tail, as recurrentgemma-9b's
38 = 12·3 + 2) the reference's ``prefill`` and ``decode_step`` skip the tail
(ROADMAP Queue C item 11): the port's equal the reference's ``forward``,
while the reference's prefill differs from it by more than 1e-2. With a
prompt longer than the window and not a multiple of it, the reference's
decode overwrites window rows still in use (Queue C item 12): the port's
decode equals the forward there, the reference's does not. Also the RG-LRU
block alone, the window-with-kernel refusal, carried caches, and bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as ref_rg
from repro.models import transformer as ref_tf
from repro.models.attention import attention as ref_attention
from repro.models.common import rms_norm as ref_rms_norm
from repro.models.mlp import mlp as ref_mlp
from repro_torch.kernels import ops
from repro_torch.models import rglru, transformer
from repro_torch.models.registry import get_model
from repro_torch.models.weights import cache_from_reference
from torch_lm_common import assert_same_tree, assert_trees_close, close, np_, rel_err
from torch_lm_common import port_init_matches_reference, ref_decode, ref_forward, ref_prefill
from torch_lm_common import world as make_world
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "recurrentgemma-9b"
WIN = 32  # reduce_for_smoke's local_window
# bf16, one block from the same bf16 input against the reference's block,
# relative to max|out|: one or two bf16 roundings apart (read 4.8e-3 rec,
# 2.0e-3 attn)
BF16_BLOCK_TOL = 1e-2
# bf16 forward logits, relative to max|logit|: the random 3-layer model with
# embed_scale amplifies every rounding: the reference's forward and its own
# blocks run one by one read 0.136 apart, the port 0.094 from its forward
BF16_TOL = 0.2


def _pad_windows(cache, rows, np_like=False):
    """Pad every window cache (k / v) along its sequence axis to ``rows``."""
    def pad(name, c):
        if name not in ("k", "v"):
            return c
        n = rows - c.shape[-3]
        if np_like:
            return jnp.pad(c, [(0, 0)] * (c.ndim - 3) + [(0, n), (0, 0), (0, 0)])
        return torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n))

    def walk(tree):
        if isinstance(tree, list):
            return [walk(t) for t in tree]
        return {k: walk(v) if isinstance(v, (dict, list)) else pad(k, v) for k, v in tree.items()}

    return walk(cache)


@pytest.fixture(scope="module")
def w3():
    rcfg, pcfg, params, tp = make_world(ARCH)
    assert pcfg.n_layers == 3 and pcfg.local_window == WIN
    return rcfg, pcfg, params, tp


@pytest.fixture(scope="module")
def w5():
    return make_world(ARCH, n_layers=5)


def _toks(cfg, n, seed=3):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (2, n))


@pytest.mark.parametrize("layers", [3, 5])
def test_param_tree(w3, w5, layers):
    _, pcfg, params, tp = w3 if layers == 3 else w5
    port_init_matches_reference(pcfg, params, transformer.init_params)
    assert len(tp["pattern"]) == 3 and len(tp["tail"]) == layers - 3


def test_rglru_block_matches_reference(w3):
    """From a nonzero state (conv tail and h), over 300 tokens: two chunks
    of 256, the second padded; output and carried state."""
    rcfg, pcfg, params, tp = w3
    rng = np.random.default_rng(2)
    B, S, r = 2, 300, pcfg.d_rnn
    x = rng.normal(size=(B, S, pcfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(B, pcfg.conv_width - 1, r)).astype(np.float32)
    h = rng.normal(size=(B, r)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[0], params["pattern"][0]["rec"])
    pp = transformer.layer_params(tp["pattern"][0], 0)["rec"]
    want, wst = ref_rg.rglru_block(rp, jnp.asarray(x), rcfg,
                                   {"conv": jnp.asarray(conv), "h": jnp.asarray(h)})
    t = torch.as_tensor
    got, st = rglru.rglru_block(pp, t(x), pcfg, {"conv": t(conv), "h": t(h)})
    close(np_(got), want, "rglru out")
    assert_trees_close(st, wst, "rglru state")


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_forward_and_prefill_match_reference(w3, impl):
    """3 layers; the pattern blocks take 'dense' whatever attn_impl says,
    so 'kernel' launches nothing and answers as 'dense'."""
    rcfg, pcfg, params, tp = w3
    toks = _toks(rcfg, 13)
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    n0 = ops.flash_attention.launches
    want, _ = ref_forward(params, rcfg, jt, attn_impl="dense")
    got, aux = transformer.forward(tp, pcfg, tt, attn_impl=impl)
    assert aux == 0.0
    close(np_(got), want, f"forward {impl}")
    want_l, want_c = ref_prefill(params, rcfg, jt, attn_impl="dense")
    got_l, got_c = get_model(pcfg).prefill(tp, {"tokens": tt}, attn_impl=impl)
    close(np_(got_l), want_l, f"prefill logits {impl}")
    assert got_c.pop("tail") == []
    assert_trees_close(got_c, want_c, f"prefill cache {impl}")
    assert ops.flash_attention.launches == n0


@pytest.mark.parametrize("P,n", [(9, 3), (26, 10)])
def test_decode_matches_reference(w3, P, n):
    """A prefill of P tokens, the window caches padded to the window, then n
    teacher-forced decode steps: logits and every cache leaf after each step
    equal the reference's; (26, 10) decodes to position 35, past the window
    of 32, so the ring buffer wraps. Each step also equals the port's
    forward over the same tokens."""
    rcfg, pcfg, params, tp = w3
    toks = _toks(rcfg, P + n, seed=P)
    model = get_model(pcfg)
    _, rcache = ref_prefill(params, rcfg, jnp.asarray(toks[:, :P], jnp.int32), attn_impl="dense")
    rcache = _pad_windows(rcache, WIN, np_like=True)
    _, cache = model.prefill(tp, {"tokens": torch.as_tensor(toks[:, :P])})
    cache = _pad_windows(cache, WIN)
    full, _ = model.forward(tp, {"tokens": torch.as_tensor(toks)})
    for i in range(n):
        t = P + i
        want, rcache = ref_decode(params, rcfg, jnp.asarray(toks[:, t], jnp.int32), rcache,
                                  jnp.int32(t))
        got, cache = model.decode_step(tp, torch.as_tensor(toks[:, t]), cache, t)
        close(np_(got), want, f"decode step {t}")
        close(np_(got), np_(full[:, t]), f"decode step {t} vs the port's forward")
        tail = cache.pop("tail")
        assert tail == []
        assert_trees_close(cache, rcache, f"decode cache step {t}")
        cache["tail"] = tail


@pytest.mark.parametrize("pattern", [("rec", "rec", "attn"), ("rec", "attn", "rec")])
def test_tail_is_served(pattern):
    """C11: 5 layers, a tail of 2 (rec, rec; or rec, attn). The port's
    forward, prefill and 3 decode steps equal the reference's forward; the
    reference's prefill leaves the tail out and differs from its forward by
    more than 1e-2 (read 0.2 at the default pattern)."""
    rcfg, pcfg, params, tp = make_world(ARCH, n_layers=5, block_pattern=pattern)
    P, n = 12, 3
    toks = _toks(rcfg, P + n)
    full, _ = ref_forward(params, rcfg, jnp.asarray(toks, jnp.int32), attn_impl="dense")
    full = np.asarray(full)
    got, _ = transformer.forward(tp, pcfg, torch.as_tensor(toks))
    close(np_(got), full, "5-layer forward")
    ref_last, _ = ref_prefill(params, rcfg, jnp.asarray(toks[:, :P], jnp.int32),
                                 attn_impl="dense")
    ref_full_P, _ = ref_forward(params, rcfg, jnp.asarray(toks[:, :P], jnp.int32),
                                   attn_impl="dense")
    gap = float(np.abs(np.asarray(ref_last) - np.asarray(ref_full_P)[:, -1]).max())
    assert gap > 1e-2, gap
    last, cache = transformer.prefill(tp, pcfg, torch.as_tensor(toks[:, :P]))
    close(np_(last), np.asarray(ref_full_P)[:, -1], "5-layer prefill vs the reference's forward")
    assert len(cache["tail"]) == 2
    assert set(cache["tail"][1]) == ({"k", "v"} if pattern[1] == "attn" else {"conv", "h"})
    cache = _pad_windows(cache, WIN)
    for t in range(P, P + n):
        got, cache = transformer.decode_step(tp, pcfg, torch.as_tensor(toks[:, t]), cache, t)
        close(np_(got), full[:, t], f"5-layer decode {t} vs the reference's forward")
    assert_same_tree(cache, jax.tree.map(np.asarray, transformer.init_cache(
        pcfg, 2, WIN, torch.float32, device="cpu")), "init_cache vs the served cache")
    if pattern[1] == "attn":  # the tail's attention has a window: the kernel refuses it
        with pytest.raises(NotImplementedError, match="sliding window"):
            transformer.forward(tp, pcfg, torch.as_tensor(toks), attn_impl="kernel")


@pytest.mark.parametrize("P", [40, 64])
def test_ring_buffer_past_the_window(w3, P):
    """C12: a prompt of P > 32 tokens, then 4 decode steps. The port's
    decode equals the reference's forward at every step. At P = 64, a
    multiple of the window, the reference lays its window out the same way:
    caches and logits equal. At P = 40 it keeps the rows in order from row
    0 and its decode then writes over rows still in the window: it leaves
    its forward by more than 1e-2."""
    rcfg, pcfg, params, tp = w3
    n = 4
    toks = _toks(rcfg, P + n, seed=P)
    full = np.asarray(ref_forward(params, rcfg, jnp.asarray(toks, jnp.int32),
                                     attn_impl="dense")[0])
    _, rcache = ref_prefill(params, rcfg, jnp.asarray(toks[:, :P], jnp.int32), attn_impl="dense")
    _, cache = transformer.prefill(tp, pcfg, torch.as_tensor(toks[:, :P]))
    if P % WIN == 0:
        assert_trees_close({k: v for k, v in cache.items() if k != "tail"}, rcache,
                           "prefill cache")
    ref_gap = 0.0
    for t in range(P, P + n):
        want, rcache = ref_decode(params, rcfg, jnp.asarray(toks[:, t], jnp.int32), rcache,
                                  jnp.int32(t))
        got, cache = transformer.decode_step(tp, pcfg, torch.as_tensor(toks[:, t]), cache, t)
        close(np_(got), full[:, t], f"decode {t} vs the reference's forward")
        ref_gap = max(ref_gap, float(np.abs(np.asarray(want) - full[:, t]).max()))
        if P % WIN == 0:
            close(np_(got), want, f"decode {t} vs the reference's decode")
    assert (ref_gap > 1e-2) == bool(P % WIN), ref_gap


def test_cache_from_reference(w3, w5):
    """A reference cache serves the port's decode at 3 layers; at 5 it has
    no tail states, and carrying it raises (C11), as it does without cfg."""
    rcfg, pcfg, params, tp = w3
    toks = _toks(rcfg, 10)
    _, rcache = ref_prefill(params, rcfg, jnp.asarray(toks[:, :9], jnp.int32),
                               attn_impl="dense")
    rcache = _pad_windows(rcache, WIN, np_like=True)
    cache = cache_from_reference(jax.tree.map(np.asarray, rcache), pcfg, device="cpu")
    assert cache["tail"] == []
    want, _ = ref_decode(params, rcfg, jnp.asarray(toks[:, 9], jnp.int32), rcache,
                                 jnp.int32(9))
    got, _ = transformer.decode_step(tp, pcfg, torch.as_tensor(toks[:, 9]), cache, 9)
    close(np_(got), want, "decode from a carried cache")
    with pytest.raises(ValueError, match="needs cfg"):
        cache_from_reference(jax.tree.map(np.asarray, rcache), device="cpu")
    rcfg5, pcfg5, params5, _ = w5
    _, rcache5 = ref_prefill(params5, rcfg5, jnp.asarray(toks[:, :9], jnp.int32),
                                attn_impl="dense")
    with pytest.raises(ValueError, match="Queue C item 11"):
        cache_from_reference(jax.tree.map(np.asarray, rcache5), pcfg5, device="cpu")


def test_bf16_matches_reference_bf16():
    """Each block kind from the same bf16 input, then the whole forward."""
    rcfg, pcfg, params, tp = make_world(ARCH, param_dtype="bfloat16", compute_dtype="bfloat16")
    toks = _toks(rcfg, 13, seed=5)
    x = np.random.default_rng(1).normal(size=(2, 13, pcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.as_tensor(x).bfloat16()
    rope = ref_tf._rope_for(rcfg, jnp.arange(13))
    prope = transformer._rope_for(pcfg, torch.arange(13))
    for i, kind in enumerate(rcfg.block_pattern):
        lp = jax.tree.map(lambda a: a[0], params["pattern"][i])
        h = ref_rms_norm(jx, lp["ln1"], rcfg.norm_eps)
        if kind == "rec":
            a, _ = ref_rg.rglru_block(lp["rec"], h, rcfg, ref_rg.init_rglru_state(rcfg, 2,
                                                                                jnp.bfloat16))
        else:
            a, _ = ref_attention(lp["attn"], h, rcfg, rope, window=WIN, impl="dense")
        want = jx + a
        want = want + ref_mlp(lp["mlp"], ref_rms_norm(want, lp["ln2"], rcfg.norm_eps), rcfg)
        got, st = transformer._hybrid_block(transformer.layer_params(tp["pattern"][i], 0), tx,
                                            pcfg, kind, prope, "dense")
        assert got.dtype == torch.bfloat16
        assert rel_err(np_(got), np.asarray(want, np.float32)) <= BF16_BLOCK_TOL, kind
    want, _ = ref_forward(params, rcfg, jnp.asarray(toks, jnp.int32), attn_impl="dense")
    got, _ = transformer.forward(tp, pcfg, torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    assert rel_err(np_(got), np.asarray(want, np.float32)) <= BF16_TOL
    _, cache = transformer.prefill(tp, pcfg, torch.as_tensor(toks))
    assert cache["p0"]["h"].dtype == torch.float32 and cache["p0"]["conv"].dtype == torch.bfloat16
    assert cache["p2"]["k"].dtype == torch.bfloat16
