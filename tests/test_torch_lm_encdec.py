"""The port's encoder-decoder (whisper-tiny) against the JAX package on the
CPU, at ``reduce_for_smoke`` size on the reference's own weights, rtol =
atol = 2e-4 in float32.

``encode`` (non-causal self-attention) and ``decode_train`` (causal, cross
attention, tied head) with ``attn_impl`` ``'dense'`` and ``'kernel'`` (the
flash kernel's plain version) against the reference's ``'dense'`` and
``'pallas'`` (interpret mode); ``prefill_cross``, ``init_cache`` and
``decode_step`` (logits and cache after each step); the reference's
``test_encdec_decode_consistency`` contract in the port; the registry's
entry points (``prefill`` is None, ``loss_fn`` raises); one bfloat16 case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as ref_ed
from repro_torch.kernels import ops
from repro_torch.models import encdec
from repro_torch.models.registry import get_model
from torch_lm_common import assert_trees_close, close, np_, port_init_matches_reference, rel_err
from torch_lm_common import world as make_world
from torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-tiny"
IMPLS = {"dense": "dense", "kernel": "pallas"}  # port -> reference
# bf16 against the reference's bf16, relative to max|out|, both 'dense':
# every activation rounded to bf16 in both, summed in other orders. Read
# 1.7e-2 (encode) and 3.3e-2 (decode_train from the reference's encoder
# output); end to end the random decoder amplifies the encoder's few-ulp
# differences to 0.19 through cross-attention, so each half is held alone
BF16_TOL = 5e-2
ref_encode = jax.jit(ref_ed.encode, static_argnums=1, static_argnames=("attn_impl",))
ref_decode_train = jax.jit(ref_ed.decode_train, static_argnums=1, static_argnames=("attn_impl",))
ref_decode = jax.jit(ref_ed.decode_step, static_argnums=1)


@pytest.fixture(scope="module")
def w():
    """The reference's init of ``encdec.init_params`` (its registry's
    ``init``), 2 × 16 frames and 2 × 7 tokens."""
    rcfg, pcfg, params, tp = make_world(ARCH, seed=2)
    rng = np.random.default_rng(5)
    frames = rng.normal(size=(2, 16, pcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, pcfg.vocab, (2, 7))
    return rcfg, pcfg, params, tp, frames, toks


def test_param_tree(w):
    _, pcfg, params, _, _, _ = w
    port_init_matches_reference(pcfg, params, encdec.init_params)


@pytest.mark.parametrize("impl", sorted(IMPLS))
def test_encode_and_decode_train_match_reference(w, impl):
    rcfg, pcfg, params, tp, frames, toks = w
    n0 = ops.flash_attention.launches
    want_enc = ref_encode(params, rcfg, jnp.asarray(frames), attn_impl=IMPLS[impl])
    got_enc = encdec.encode(tp, pcfg, torch.as_tensor(frames), attn_impl=impl)
    close(np_(got_enc), want_enc, f"encode {impl}")
    want = ref_decode_train(params, rcfg, jnp.asarray(toks, jnp.int32), want_enc,
                            attn_impl=IMPLS[impl])
    got = encdec.decode_train(tp, pcfg, torch.as_tensor(toks), got_enc, attn_impl=impl)
    close(np_(got), want, f"decode_train {impl}")
    logits, aux = get_model(pcfg).forward(tp, {"frames": torch.as_tensor(frames),
                                               "tokens": torch.as_tensor(toks)}, attn_impl=impl)
    assert aux == 0.0 and torch.equal(logits, got)
    assert ops.flash_attention.launches == n0  # CPU tensors: the plain version


def test_decode_steps_match_reference(w):
    """prefill_cross and init_cache, then 7 decode steps from position 0:
    logits and every cache leaf after each step."""
    rcfg, pcfg, params, tp, frames, toks = w
    enc = ref_encode(params, rcfg, jnp.asarray(frames))
    rxk, rxv = ref_ed.prefill_cross(params, rcfg, enc)
    xk, xv = encdec.prefill_cross(tp, pcfg, torch.as_tensor(np.array(enc)))
    close(np_(xk), rxk, "prefill_cross k")
    close(np_(xv), rxv, "prefill_cross v")
    rcache, _ = ref_ed.init_cache(rcfg, 2, 7, 16, dtype=jnp.float32)
    cache = get_model(pcfg).init_cache(2, 7, dtype=torch.float32, enc_seq=16, device="cpu")
    assert_trees_close(cache, rcache, "init_cache")
    rcache["xk"], rcache["xv"] = rxk, rxv
    cache["xk"], cache["xv"] = xk, xv
    for t in range(toks.shape[1]):
        want, rcache = ref_decode(params, rcfg, jnp.asarray(toks[:, t], jnp.int32), rcache,
                                  jnp.int32(t))
        got, cache = encdec.decode_step(tp, pcfg, torch.as_tensor(toks[:, t]), cache, t)
        close(np_(got), want, f"decode step {t}")
        assert_trees_close(cache, rcache, f"decode cache step {t}")


def test_encdec_decode_consistency():
    """tests/test_models_smoke.py::test_encdec_decode_consistency in the
    port, on its own seeded weights: decoding token by token from the cross
    cache equals decode_train's last row."""
    _, pcfg = make_world(ARCH)[:2]
    params = encdec.init_params(pcfg, 2, device="cpu")
    B, S = 2, 6
    rng = np.random.default_rng(5)
    frames = torch.as_tensor(rng.normal(size=(B, 8, pcfg.d_model)).astype(np.float32))
    tokens = torch.as_tensor(rng.integers(0, pcfg.vocab, (B, S)))
    enc_out = encdec.encode(params, pcfg, frames)
    ref = encdec.decode_train(params, pcfg, tokens, enc_out)
    cache = encdec.init_cache(pcfg, B, S, 8, dtype=torch.float32, device="cpu")
    cache["xk"], cache["xv"] = encdec.prefill_cross(params, pcfg, enc_out)
    for t in range(S):
        logits, cache = encdec.decode_step(params, pcfg, tokens[:, t], cache, t)
        close(np_(logits), np_(ref[:, t]), f"decode {t} vs decode_train")


def test_registry(w):
    _, pcfg, _, tp, frames, toks = w
    model = get_model(pcfg)
    assert model.prefill is None
    batch = {"frames": torch.as_tensor(frames), "tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(toks)}
    loss, metrics = model.loss_fn(tp, batch)
    assert bool(torch.isfinite(loss)) and float(metrics["aux"]) == 0.0
    assert float(loss) == float(metrics["ce"])
    cache = model.init_cache(2, 5, device="cpu")
    assert cache["k"].dtype == torch.bfloat16 and cache["xk"].shape[2] == 5


def test_bf16_matches_reference_bf16():
    rcfg, pcfg, params, tp = make_world(ARCH, seed=2, param_dtype="bfloat16",
                                        compute_dtype="bfloat16")
    rng = np.random.default_rng(6)
    frames = rng.normal(size=(2, 16, pcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, pcfg.vocab, (2, 7))
    want_enc = ref_encode(params, rcfg, jnp.asarray(frames))
    got_enc = encdec.encode(tp, pcfg, torch.as_tensor(frames))
    assert got_enc.dtype == torch.bfloat16
    assert rel_err(np_(got_enc), np.asarray(want_enc, np.float32)) <= BF16_TOL
    want = ref_decode_train(params, rcfg, jnp.asarray(toks, jnp.int32), want_enc)
    enc = torch.as_tensor(np.asarray(want_enc, np.float32)).bfloat16()
    got = encdec.decode_train(tp, pcfg, torch.as_tensor(toks), enc)
    assert got.dtype == torch.bfloat16
    assert rel_err(np_(got), np.asarray(want, np.float32)) <= BF16_TOL
