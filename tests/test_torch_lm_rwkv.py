"""The port's rwkv family (rwkv6-3b) against the JAX package on the CPU, at
``reduce_for_smoke`` size on the reference's own weights, rtol = atol = 2e-4
in float32.

``time_mix`` / ``channel_mix`` alone (the reference scanning chunks of 4,
whose pad steps must leave the carried state as it is); ``forward``;
``prefill`` (last logits and every cache leaf: ``tm_x``, ``tm_S`` float32,
``cm_x``); teacher-forced ``decode_step``; the port's own serving oracle
(prefill + decode equals forward); one bfloat16 case against the
reference's bfloat16. The recurrence is plain torch (no kernel runs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv as ref_rk
from repro_torch.kernels import ops
from repro_torch.models import rwkv, transformer
from repro_torch.models.registry import get_model
from torch_lm_common import assert_trees_close, close, np_, port_init_matches_reference, rel_err
from torch_lm_common import ref_decode, ref_forward, ref_prefill
from torch_lm_common import world as make_world
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "rwkv6-3b"
# bf16 forward logits against the reference's bf16 ones, relative to
# max|logit| (rwkv has no attention): both round every activation to bf16
# and sum in other orders; read 1.0e-2
BF16_TOL = 5e-2


@pytest.fixture(scope="module")
def w():
    rcfg, pcfg, params, tp = make_world(ARCH)
    toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 13))
    return rcfg, pcfg, params, tp, toks


def test_param_tree(w):
    _, pcfg, params, _, _ = w
    port_init_matches_reference(pcfg, params, transformer.init_params)


@pytest.mark.parametrize("split", [13, 5])
def test_time_and_channel_mix_match_reference(w, split):
    """From a nonzero state: the reference in chunks of 4 (three pad steps
    of decay 1) against the port over the 13 tokens at once, and the port
    split at ``split`` with the state carried: out, last token and state."""
    rcfg, pcfg, params, tp, _ = w
    B, S, d = 2, 13, pcfg.d_model
    H, N = d // pcfg.rwkv_head_size, pcfg.rwkv_head_size
    rng = np.random.default_rng(9)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    x_last = rng.normal(size=(B, d)).astype(np.float32)
    S0 = rng.normal(size=(B, H, N, N)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[1], params["layers"])
    pp = transformer.layer_params(tp["layers"], 1)
    want, (want_x, want_S) = ref_rk.time_mix(rp["tm"], jnp.asarray(x), rcfg,
                                             (jnp.asarray(x_last), jnp.asarray(S0)), chunk=4)
    t = torch.as_tensor
    st = (t(x_last), t(S0))
    outs = []
    for a, b in ((0, split), (split, S)):
        if a < b:
            o, st = rwkv.time_mix(pp["tm"], t(x[:, a:b]), pcfg, st)
            outs.append(o)
    close(np_(torch.cat(outs, 1)), want, f"time_mix split {split}")
    close(np_(st[0]), want_x, "time_mix x_last")
    assert st[1].dtype == torch.float32
    close(np_(st[1]), want_S, "time_mix state")
    want_c, want_cx = ref_rk.channel_mix(rp["cm"], jnp.asarray(x), rcfg, jnp.asarray(x_last))
    got_c, got_cx = rwkv.channel_mix(pp["cm"], t(x), pcfg, t(x_last))
    close(np_(got_c), want_c, "channel_mix")
    close(np_(got_cx), want_cx, "channel_mix x_last")


def test_forward_and_prefill_match_reference(w):
    rcfg, pcfg, params, tp, toks = w
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    n0 = ops.flash_attention.launches
    want, _ = ref_forward(params, rcfg, jt)
    got, aux = transformer.forward(tp, pcfg, tt, attn_impl="kernel")
    assert aux == 0.0
    close(np_(got), want, "rwkv forward")
    want_l, want_c = ref_prefill(params, rcfg, jt)
    got_l, got_c = get_model(pcfg).prefill(tp, {"tokens": tt}, attn_impl="kernel")
    close(np_(got_l), want_l, "rwkv prefill logits")
    assert_trees_close(got_c, want_c, "rwkv prefill cache")
    assert got_c["tm_S"].dtype == torch.float32
    assert ops.flash_attention.launches == n0  # no attention, no kernel


def test_decode_matches_reference(w):
    """A prefill of 9 tokens, then 4 teacher-forced decode steps: logits and
    every state leaf after each step."""
    rcfg, pcfg, params, tp, toks = w
    P, n = 9, 4
    model = get_model(pcfg)
    _, rcache = ref_prefill(params, rcfg, jnp.asarray(toks[:, :P], jnp.int32))
    _, cache = model.prefill(tp, {"tokens": torch.as_tensor(toks[:, :P])})
    for i in range(n):
        want, rcache = ref_decode(params, rcfg, jnp.asarray(toks[:, P + i], jnp.int32), rcache,
                                  jnp.int32(P + i))
        got, cache = model.decode_step(tp, torch.as_tensor(toks[:, P + i]), cache, P + i)
        close(np_(got), want, f"rwkv decode step {i}")
        assert_trees_close(cache, rcache, f"rwkv decode cache step {i}")


def test_prefill_decode_matches_forward(w):
    """The port's own serving oracle: prefill(8) + 5 decode steps equal
    forward(13) at those positions; a zeroed init_cache decoded from token
    0 equals forward too."""
    _, pcfg, _, tp, toks = w
    tt = torch.as_tensor(toks)
    model = get_model(pcfg)
    full, _ = model.forward(tp, {"tokens": tt})
    last, cache = model.prefill(tp, {"tokens": tt[:, :8]})
    close(np_(last), np_(full[:, 7]), "prefill vs forward")
    for t in range(8, 13):
        got, cache = model.decode_step(tp, tt[:, t], cache, t)
        close(np_(got), np_(full[:, t]), f"decode {t} vs forward")
    cache = model.init_cache(2, 13, dtype=torch.float32, device="cpu")
    for t in range(3):
        got, cache = model.decode_step(tp, tt[:, t], cache, t)
        close(np_(got), np_(full[:, t]), f"decode {t} from a zeroed cache vs forward")


def test_bf16_matches_reference_bf16():
    rcfg, pcfg, params, tp = make_world(ARCH, param_dtype="bfloat16", compute_dtype="bfloat16")
    toks = np.random.default_rng(5).integers(0, rcfg.vocab, (2, 13))
    want, _ = ref_forward(params, rcfg, jnp.asarray(toks, jnp.int32))
    got, _ = transformer.forward(tp, pcfg, torch.as_tensor(toks))
    assert got.dtype == torch.bfloat16
    assert rel_err(np_(got), np.asarray(want, np.float32)) <= BF16_TOL
    _, cache = transformer.prefill(tp, pcfg, torch.as_tensor(toks))
    assert cache["tm_S"].dtype == torch.float32 and cache["tm_x"].dtype == torch.bfloat16
