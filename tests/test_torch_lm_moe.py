"""The port's moe family (olmoe-1b-7b, qwen3-moe-235b-a22b) against the JAX
package on the CPU, at ``reduce_for_smoke`` size on the reference's own
weights (``params_from_reference``), rtol = atol = 2e-4 in float32.

``moe_block`` alone (output, aux loss, routes and dropped routes at the
default capacity factor 1.25, where the batch must drop routes so the
overflow sink is exercised); ``forward`` (logits and summed aux) and
``prefill`` (last logits, every cache leaf) with ``attn_impl`` ``'dense'``
and ``'kernel'`` (the flash kernel's plain version) against the reference's
``'dense'`` and ``'pallas'`` (interpret mode); ``decode_step`` under both
decode-loop names; the port's own serving oracle (prefill + decode equals
forward at the no-drop capacity factor 16, as the reference's oracle sets
it); one bfloat16 case against the reference's bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro_torch.kernels import ops
from repro_torch.models import moe, transformer
from repro_torch.models.registry import get_model
from torch_lm_common import assert_trees_close, close, np_, port_init_matches_reference, rel_err
from torch_lm_common import ref_decode, ref_forward, ref_prefill
from torch_lm_common import world as make_world
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["olmoe-1b-7b", "qwen3-moe-235b-a22b"]
IMPLS = {"dense": "dense", "kernel": "pallas"}  # port -> reference
# bf16 forward logits against the reference's bf16 ones, relative to
# max|logit|, both 'dense': both round every activation to bf16 (one ulp is
# 2^-8 to 2^-7 of a value) but sum in other orders; read 2.4e-2 (olmoe) and
# 2.3e-2 (qwen3-moe); the dense family's qwen2.5-3b reads 3.3e-2 alike
BF16_TOL = 5e-2


@pytest.fixture(scope="module")
def worlds():
    out = {}
    for arch in ARCHS:
        rcfg, pcfg, params, tp = make_world(arch)
        toks = np.random.default_rng(3).integers(0, rcfg.vocab, (2, 13))
        out[arch] = (rcfg, pcfg, params, tp, toks)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_tree(worlds, arch):
    _, pcfg, params, _, _ = worlds[arch]
    port_init_matches_reference(pcfg, params, transformer.init_params)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_routes_and_drops(worlds, arch):
    """At the default capacity factor the batch drops routes (slot C, the
    sink); the port's routes are the reference's top-k (lower expert id
    first among ties), its dropped routes are the ones a count of the
    reference's routes per (row, expert) past C gives, and out and aux match."""
    rcfg, pcfg, params, tp, _ = worlds[arch]
    B, S = 2, 48
    x = np.random.default_rng(7).normal(size=(B, S, pcfg.d_model)).astype(np.float32)
    rp = jax.tree.map(lambda a: a[0], params["layers"]["mlp"])
    pp = transformer.layer_params(tp["layers"]["mlp"], 0)
    want, want_aux = ref_moe.moe_block(rp, jnp.asarray(x), rcfg)
    got, aux = moe.moe_block(pp, torch.as_tensor(x), pcfg)
    close(np_(got), want, f"{arch} moe_block out")
    close(float(aux), float(want_aux), f"{arch} moe_block aux")

    probs = jax.nn.softmax(jnp.asarray(x).reshape(B * S, -1) @ rp["router"], axis=-1)
    _, ref_e = jax.lax.top_k(probs, rcfg.moe_top_k)
    _, _, _, top_e = moe.route(pp, torch.as_tensor(x), pcfg)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(ref_e))
    C = moe.capacity(pcfg, S)
    assert C == int(-(-S * rcfg.moe_top_k // rcfg.n_experts) * rcfg.capacity_factor)
    counts = np.stack([np.bincount(r, minlength=rcfg.n_experts)
                       for r in np.asarray(ref_e).reshape(B, -1)])
    _, _, keep = moe.dispatch(top_e, B, S, pcfg)
    dropped = int((~keep).sum())
    assert dropped == int(np.maximum(counts - C, 0).sum()) and dropped > 0, (dropped, C, counts)


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_prefill_match_reference(worlds, arch, impl):
    rcfg, pcfg, params, tp, toks = worlds[arch]
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    n0 = ops.flash_attention.launches
    want, want_aux = ref_forward(params, rcfg, jt, attn_impl=IMPLS[impl])
    got, aux = transformer.forward(tp, pcfg, tt, attn_impl=impl)
    assert aux.dtype == torch.float32
    close(np_(got), want, f"{arch} forward {impl}")
    close(float(aux), float(want_aux), f"{arch} forward aux {impl}")
    want_l, want_c = ref_prefill(params, rcfg, jt, attn_impl=IMPLS[impl])
    got_l, got_c = get_model(pcfg).prefill(tp, {"tokens": tt}, attn_impl=impl)
    close(np_(got_l), want_l, f"{arch} prefill logits {impl}")
    assert_trees_close(got_c, want_c, f"{arch} prefill cache {impl}")
    assert ops.flash_attention.launches == n0  # CPU tensors: the plain version


@pytest.mark.parametrize("loop", ["scan", "fori"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(worlds, arch, loop):
    """A padded prefill of 9 tokens, then 3 teacher-forced decode steps."""
    rcfg, pcfg, params, tp, toks = worlds[arch]
    rcfg, pcfg = (dataclasses.replace(c, decode_loop=loop) for c in (rcfg, pcfg))
    P, n = 9, 3
    model = get_model(pcfg)
    _, rcache = ref_prefill(params, rcfg, jnp.asarray(toks[:, :P], jnp.int32), attn_impl="dense")
    rcache = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))), rcache)
    _, cache = model.prefill(tp, {"tokens": torch.as_tensor(toks[:, :P])}, attn_impl="kernel")
    cache = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n)) for k, c in cache.items()}
    for i in range(n):
        want, rcache = ref_decode(params, rcfg, jnp.asarray(toks[:, P + i], jnp.int32), rcache,
                                  jnp.int32(P + i))
        got, cache = model.decode_step(tp, torch.as_tensor(toks[:, P + i]), cache, P + i)
        close(np_(got), want, f"{arch} decode {loop} step {i}")
        assert_trees_close(cache, rcache, f"{arch} decode {loop} cache step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's own serving oracle at the no-drop capacity factor 16:
    prefill(12) + 3 decode steps equal forward(15) at those positions."""
    _, pcfg, _, tp = make_world(arch, capacity_factor=16.0)
    toks = torch.as_tensor(np.random.default_rng(4).integers(0, pcfg.vocab, (2, 15)))
    model = get_model(pcfg)
    full, _ = model.forward(tp, {"tokens": toks}, attn_impl="dense")
    last, cache = model.prefill(tp, {"tokens": toks[:, :12]}, attn_impl="kernel")
    close(np_(last), np_(full[:, 11]), f"{arch} prefill vs forward")
    cache = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 3)) for k, c in cache.items()}
    for t in range(12, 15):
        got, cache = model.decode_step(tp, toks[:, t], cache, t)
        close(np_(got), np_(full[:, t]), f"{arch} decode {t} vs forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_reference_bf16(arch):
    rcfg, pcfg, params, tp = make_world(arch, param_dtype="bfloat16", compute_dtype="bfloat16")
    toks = np.random.default_rng(5).integers(0, rcfg.vocab, (2, 13))
    want, _ = ref_forward(params, rcfg, jnp.asarray(toks, jnp.int32), attn_impl="dense")
    got, _ = transformer.forward(tp, pcfg, torch.as_tensor(toks), attn_impl="dense")
    assert got.dtype == torch.bfloat16
    assert rel_err(np_(got), np.asarray(want, np.float32)) <= BF16_TOL
