"""The port's LM serving path vs the JAX package, on the CPU.

The dense family at ``reduce_for_smoke`` size (f32), on the reference's own
weights carried across with ``params_from_reference``: ``forward`` and
``prefill`` with ``attn_impl`` ``'dense'``, ``'blocked'`` and ``'kernel'``
(the flash-attention kernel's plain version on the CPU) against the
reference's ``'dense'``, ``'blocked'`` and ``'pallas'`` (interpret mode), and
``decode_step`` (``decode_loop`` ``'scan'`` and ``'fori'``) after a padded
prefill, all at the reference's own tolerance (rtol = atol = 2e-4; the
largest error measured was 5.3e-5, on gemma-2b's V cache, whose
``embed_scale`` makes activations 8x larger). ``flash_attention_ref`` (what the CUDA kernel is held against on the
card) is checked against the Pallas kernel in interpret mode over the
reference's own sweep. The CUDA kernel itself is compiled and compared on
the GPU by ``chip_smoke.py`` (``[flash-kernels]``, ``[lm]``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.configs import runnable_cells as ref_runnable_cells
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_oracle
from repro.models import transformer as ref_tf
from repro.models.registry import get_model as ref_get_model
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    flash_attention_bf16_ref,
    flash_attention_f32_ref,
    flash_attention_ref,
)
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.registry import get_model
from repro_torch.models.weights import cache_from_reference, params_from_reference

DENSE = ["qwen2.5-3b", "granite-8b", "gemma-2b", "starcoder2-15b"]
TOL = 2e-4  # tests/test_models_smoke.py's serving oracle
IMPLS = {"dense": "dense", "blocked": "blocked", "kernel": "pallas"}  # port -> reference


def _np(t):
    return t.detach().float().numpy()


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=f"{what}: max err {err}")
    return err


@pytest.fixture(scope="module")
def world():
    """Per dense arch: the reduced config, the reference's params (seeded
    jax init) and the port's copy of them, and a token batch."""
    out = {}
    for arch in DENSE:
        cfg = ref_reduce(ref_get_config(arch))
        params, _ = ref_get_model(cfg).init(jax.random.key(1))
        tp = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
        toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 13))
        out[arch] = (cfg, params, tp, toks)
    return out


@pytest.mark.parametrize("arch", sorted(REF_ARCHS))
def test_configs_are_the_references(arch):
    """The port's copy of the configs: every field, the reduced miniature,
    the shapes and the runnable cells."""
    port = configs.get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(configs.reduce_for_smoke(port)) == dataclasses.asdict(
        ref_reduce(ref_get_config(arch)))
    assert port.param_count() == ref_get_config(arch).param_count()
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
    assert configs.runnable_cells() == ref_runnable_cells()


def test_common_math_matches_reference():
    """rms_norm (f32 inside, 1 + gamma), layer_norm, rotary and apply_rope
    (halves, not interleaved) against repro.models.common, f32 and bf16."""
    from repro.models import common as rc
    from repro_torch.models import common as pc

    rng = np.random.default_rng(11)
    x, g, b = rng.normal(size=(2, 5, 3, 16)), rng.normal(size=16), rng.normal(size=16)
    pos = np.arange(5)
    for jdt, tdt, tol in ((jnp.float32, torch.float32, 1e-6), (jnp.bfloat16, torch.bfloat16, 1e-2)):
        jx, tx = jnp.asarray(x, jdt), torch.as_tensor(x, dtype=torch.float32).to(tdt)
        jg, tg = jnp.asarray(g, jnp.float32), torch.as_tensor(g, dtype=torch.float32)
        jb, tb = jnp.asarray(b, jnp.float32), torch.as_tensor(b, dtype=torch.float32)
        got = pc.rms_norm(tx, tg, 1e-6)
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), np.asarray(rc.rms_norm(jx, jg, 1e-6), np.float32),
                                   rtol=tol, atol=tol)
        np.testing.assert_allclose(_np(pc.layer_norm(tx, tg, tb, 1e-6)),
                                   np.asarray(rc.layer_norm(jx, jg, jb, 1e-6), np.float32),
                                   rtol=tol, atol=tol)
        jc, js = rc.rotary(jnp.asarray(pos), 16, 1e4)
        tc, ts = pc.rotary(torch.as_tensor(pos), 16, 1e4)
        np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(_np(ts), np.asarray(js), rtol=1e-6, atol=1e-6)
        got = pc.apply_rope(tx, tc[:, None, :], ts[:, None, :])
        want = rc.apply_rope(jx, jc[:, None, :], js[:, None, :])
        assert got.dtype == tdt
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", DENSE)
def test_params_round_trip(world, arch):
    """Carried weights keep keys, shapes and dtypes (bf16 bits included);
    the port's own init builds the same tree."""
    cfg, params, tp, _ = world[arch]
    flat_ref = {jax.tree_util.keystr(k): v for k, v in
                jax.tree_util.tree_flatten_with_path(params)[0]}

    def flat(tree, pre=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}['{k}']") if isinstance(v, dict) else {f"{pre}['{k}']": v})
        return out

    flat_tp, flat_init = flat(tp), flat(transformer.init_params(configs.reduce_for_smoke(
        configs.get_config(arch)), 0, device="cpu"))
    assert set(flat_tp) == set(flat_ref) == set(flat_init)
    for k, v in flat_ref.items():
        assert tuple(flat_tp[k].shape) == tuple(v.shape) == tuple(flat_init[k].shape), k
        assert flat_tp[k].dtype == flat_init[k].dtype == {
            "float32": torch.float32, "bfloat16": torch.bfloat16}[str(v.dtype)], k
        np.testing.assert_array_equal(_np(flat_tp[k]), np.asarray(v, np.float32))
    bf = dataclasses.replace(cfg, param_dtype="bfloat16", compute_dtype="bfloat16")
    bparams, _ = ref_get_model(bf).init(jax.random.key(2))
    emb = np.asarray(bparams["embed"])
    got = params_from_reference({"embed": emb}, device="cpu")["embed"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), emb.view(np.int16))


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_prefill_match_reference(world, arch, impl):
    """``forward`` (all logits) and ``prefill`` (last logits and the cache).
    ``'blocked'`` is held through prefill alone: both packages pad the
    sequence to one 2 048-token tile, which makes each blocked call seconds
    long on the CPU, and forward runs the same trunk."""
    cfg, params, tp, toks = world[arch]
    pcfg = configs.reduce_for_smoke(configs.get_config(arch))
    n0 = ops.flash_attention.launches
    jt, tt = jnp.asarray(toks, jnp.int32), torch.as_tensor(toks)
    if impl != "blocked":
        want, _ = ref_tf.forward(params, cfg, jt, attn_impl=IMPLS[impl])
        got, aux = transformer.forward(tp, pcfg, tt, attn_impl=impl)
        assert aux == 0.0
        _close(_np(got), want, f"{arch} forward {impl}")
    want_l, want_c = ref_tf.prefill(params, cfg, jt, attn_impl=IMPLS[impl])
    got_l, got_c = get_model(pcfg).prefill(tp, {"tokens": tt}, attn_impl=impl)
    _close(_np(got_l), want_l, f"{arch} prefill logits {impl}")
    for key in ("k", "v"):
        assert got_c[key].shape == want_c[key].shape
        _close(_np(got_c[key]), want_c[key], f"{arch} prefill cache {key} {impl}")
    assert ops.flash_attention.launches == n0  # CPU tensors: the plain version, no launch


@pytest.mark.parametrize("loop", ["scan", "fori"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_reference(world, arch, loop):
    """A padded prefill of 9 tokens, then 2 teacher-forced decode steps: the
    port (either decode_loop) against the reference's decode_step."""
    cfg, params, tp, toks = world[arch]
    cfg = dataclasses.replace(cfg, decode_loop=loop)
    pcfg = dataclasses.replace(configs.reduce_for_smoke(configs.get_config(arch)),
                               decode_loop=loop)
    P, n = 9, 2
    rmodel, model = ref_get_model(cfg), get_model(pcfg)
    _, rcache = rmodel.prefill(params, {"tokens": jnp.asarray(toks[:, :P], jnp.int32)},
                               attn_impl="dense")
    rcache = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, n), (0, 0), (0, 0))), rcache)
    _, cache = model.prefill(tp, {"tokens": torch.as_tensor(toks[:, :P])}, attn_impl="kernel")
    cache = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, n)) for k, c in cache.items()}
    for i in range(n):
        want, rcache = rmodel.decode_step(params, jnp.asarray(toks[:, P + i], jnp.int32), rcache,
                                          jnp.int32(P + i))
        got, new = model.decode_step(tp, torch.as_tensor(toks[:, P + i]), cache, P + i)
        _close(_np(got), want, f"{arch} decode {loop} step {i}")
        for k in ("k", "v"):
            _close(_np(new[k]), rcache[k], f"{arch} decode {loop} cache {k}")
        cache = new


def test_cache_from_reference(world):
    """A reference prefill cache carried across serves the port's decode."""
    cfg, params, tp, toks = world["qwen2.5-3b"]
    _, rcache = ref_tf.prefill(params, cfg, jnp.asarray(toks[:, :7], jnp.int32),
                               attn_impl="dense")
    rcache = jax.tree.map(lambda c: jnp.pad(c, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))), rcache)
    cache = cache_from_reference(jax.tree.map(np.asarray, rcache), device="cpu")
    assert cache["k"].dtype == torch.float32 and tuple(cache["k"].shape) == rcache["k"].shape
    want, _ = ref_tf.decode_step(params, cfg, jnp.asarray(toks[:, 7], jnp.int32), rcache,
                                 jnp.int32(7))
    got, _ = transformer.decode_step(tp, configs.reduce_for_smoke(configs.get_config(
        "qwen2.5-3b")), torch.as_tensor(toks[:, 7]), cache, 7)
    _close(_np(got), want, "decode from a carried cache")


# ----------------------------------------------------------- flash attention
FLASH_GRID = [(1, 2, 2, 64, 16), (2, 4, 2, 128, 32), (1, 8, 1, 256, 64)]


def _qkv(b, h, hkv, s, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, d)), rng.normal(size=(b, hkv, s, d)),
            rng.normal(size=(b, hkv, s, d)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", FLASH_GRID)
def test_flash_ref_matches_pallas(b, h, hkv, s, d, causal, dtype):
    """The reference's own sweep (tests/test_kernels_pallas.py): f32 to
    2e-5, bf16 to 2e-2."""
    arrs = _qkv(b, h, hkv, s, d, h * s + d)
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = ref_ops.flash_attention(*(jnp.asarray(x, jdt) for x in arrs), causal=causal,
                                   tq=64, tk=64)
    t = [torch.as_tensor(x, dtype=torch.float32).to(tdt) for x in arrs]
    got = flash_attention_ref(*t, causal=causal)
    n0 = ops.flash_attention.launches
    assert torch.equal(ops.flash_attention(*t, causal=causal), got)
    assert ops.flash_attention.launches == n0
    assert got.dtype == tdt and tuple(got.shape) == (b, h, s, d)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), rtol=tol, atol=tol)


def test_flash_ref_differs_from_ref_only_by_p_cast():
    """ref.flash_attention rounds the softmax weights to v's dtype before
    p @ v; the Pallas body (and the port's f32 contract) keeps them f32. In
    f32 the two agree; in bf16, rounding p to bf16 in the Pallas body's
    arithmetic gives ref.flash_attention back, and the port's bf16 contract,
    which rounds p, stays within two output roundings of it."""
    b, h, hkv, s, d = 2, 4, 2, 128, 32
    arrs = _qkv(b, h, hkv, s, d, 7)
    f32 = [torch.as_tensor(x, dtype=torch.float32) for x in arrs]
    want32 = np.asarray(ref_oracle.flash_attention(*(jnp.asarray(x, jnp.float32) for x in arrs)))
    np.testing.assert_allclose(_np(flash_attention_ref(*f32)), want32, rtol=1e-5, atol=1e-5)

    bf = [x.to(torch.bfloat16) for x in f32]
    want = np.asarray(ref_oracle.flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in arrs)),
                      np.float32)
    q, k, v = (x.float() for x in bf)
    rep = h // hkv
    logits = q @ k.repeat_interleave(rep, 1).transpose(-1, -2) * d ** -0.5
    logits = logits.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(), -1e30)
    p = torch.softmax(logits, -1)
    vv = bf[2].repeat_interleave(rep, 1)
    cast_p = torch.matmul(p.to(torch.bfloat16).float(), vv.float()).to(torch.bfloat16)
    keep_p = torch.matmul(p, vv.float()).to(torch.bfloat16)
    assert torch.equal(keep_p, flash_attention_f32_ref(*bf))
    ulp = 2.0 ** -7 * np.abs(want).max()  # one bf16 rounding of the output
    assert np.abs(_np(cast_p) - want).max() <= ulp
    assert np.abs(_np(keep_p) - want).max() > 0.0  # the cast of p is the difference
    # the bf16 kernel's contract rounds p as the oracle does (per key tile,
    # before normalising): within two roundings of the output
    assert np.abs(_np(flash_attention_ref(*bf)) - want).max() <= 2 * ulp


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,h,hkv,s,d", FLASH_GRID)
def test_flash_bf16_ref_matches_reference(b, h, hkv, s, d, causal):
    """The bf16 kernel's plain version (p rounded to bf16 per key tile) is
    within two bf16 ulps of max|out| of ``repro.kernels.ref.flash_attention``
    (which rounds p too) and within 2e-2 of the Pallas kernel (f32 p), the
    reference's own bf16 tolerance; ``ops.flash_attention`` on CPU bf16
    tensors is exactly it and launches nothing. f32 inputs keep the Pallas
    body's arithmetic bit for bit."""
    arrs = _qkv(b, h, hkv, s, d, 11 * h + s + d)
    t = [torch.as_tensor(x, dtype=torch.float32).to(torch.bfloat16) for x in arrs]
    got = flash_attention_bf16_ref(*t, causal=causal)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, s, d)
    n0 = ops.flash_attention.launches
    assert torch.equal(ops.flash_attention(*t, causal=causal), got)
    assert torch.equal(flash_attention_ref(*t, causal=causal), got)
    assert ops.flash_attention.launches == n0
    jq = [jnp.asarray(x, jnp.bfloat16) for x in arrs]
    want = np.asarray(ref_oracle.flash_attention(*jq, causal=causal), np.float32)
    assert np.abs(_np(got) - want).max() <= 2 * 2.0 ** -7 * np.abs(want).max()
    pallas = np.asarray(ref_ops.flash_attention(*jq, causal=causal, tq=64, tk=64), np.float32)
    np.testing.assert_allclose(_np(got), pallas, rtol=2e-2, atol=2e-2)
    f32 = [x.float() for x in t]
    assert torch.equal(flash_attention_ref(*f32, causal=causal),
                       flash_attention_f32_ref(*f32, causal=causal))


def test_flash_rejects_sequence_lengths_the_pallas_kernel_rejects():
    q = torch.zeros((1, 2, 200, 16))
    with pytest.raises(ValueError, match="multiple of 128"):
        ops.flash_attention(q, q, q)


# ----------------------------------------------------------- what is not served
@pytest.mark.parametrize("arch", sorted(a for a, c in REF_ARCHS.items()
                                        if c.family != "dense" or c.is_encdec))
def test_other_families_raise(arch):
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    with pytest.raises(NotImplementedError, match="ROADMAP A10b"):
        get_model(cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP A10b"):
        transformer.init_params(cfg, device="cpu")


def test_unported_inputs_and_names_raise(world):
    cfg = configs.reduce_for_smoke(configs.get_config("qwen2.5-3b"))
    _, _, tp, toks = world["qwen2.5-3b"]
    model = get_model(cfg)
    tt = torch.as_tensor(toks)
    with pytest.raises(ValueError, match="'kernel'"):
        model.prefill(tp, {"tokens": tt}, attn_impl="pallas")
    with pytest.raises(NotImplementedError, match="M-RoPE"):
        model.forward(tp, {"tokens": tt, "mrope_pos": torch.zeros((2, 3, 13), dtype=torch.long)})
    with pytest.raises(NotImplementedError, match="ROADMAP A10c"):
        model.loss_fn(tp, {"tokens": tt, "labels": tt})
    with pytest.raises(ValueError, match="decode_loop"):
        transformer.decode_step(tp, dataclasses.replace(cfg, decode_loop="while"), tt[:, 0],
                                transformer.init_cache(cfg, 2, 4, device="cpu"), 0)


def test_serve_lm_on_cpu():
    """serve_lm mirrors the reference's: reduced config, prefill, greedy
    decode from the padded cache; 'kernel' and 'dense' decode the same
    tokens (f32, a few ulps apart)."""
    logs = []
    n0 = ops.flash_attention.launches
    kern = serve.serve_lm(prompt_len=16, decode_len=4, batch=2, attn_impl="kernel",
                          device="cpu", log_fn=logs.append)
    dense = serve.serve_lm(prompt_len=16, decode_len=4, batch=2, attn_impl="dense",
                           device="cpu", log_fn=logs.append)
    assert ops.flash_attention.launches == n0
    assert len(kern) == 4 and all(t.shape == (2,) for t in kern)
    assert all((a == b).all() for a, b in zip(kern, dense))
    assert any("prefill 16 toks x2" in line for line in logs)
