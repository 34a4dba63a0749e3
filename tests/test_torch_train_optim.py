"""The port's AdamW, WSD schedule, global-norm clip and TokenPipeline
(``repro_torch.train.optimizer``, ``repro_torch.data.synthetic``) against
the reference's, on the same gradients and state.

Tolerance: ≤1e-6 relative (each leaf against its own max|value|) for
params, mu, nu, master, lr and grad_norm. Both packages do the same float32
operations in the same order; they read equal here, or apart by a last-bit
difference of the global norm's sum (XLA and PyTorch reduce in different
orders). The token stream is bitwise the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import TokenPipeline as RefPipeline
from repro.train import optimizer as ref_opt
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.models.weights import opt_state_from_reference, params_from_reference
from repro_torch.train import optimizer as opt
from repro_torch.train.optimizer import AdamWState, tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-6


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"embed": (rng.normal(size=(12, 8)) * scale).astype(np.float32),
            "layers": {"w": (rng.normal(size=(3, 8, 5)) * scale).astype(np.float32),
                       "ln": (rng.normal(size=(3, 8)) * scale).astype(np.float32)},
            "pattern": [{"a": (rng.normal(size=(2, 4)) * scale).astype(np.float32)}]}


def test_wsd_schedule_matches_reference():
    """Steps 0, inside warmup, warmup, stable, mid-decay, the end, past it."""
    ref = ref_opt.wsd_schedule(3e-4, warmup=10, stable=100, decay=40)
    port = opt.wsd_schedule(3e-4, warmup=10, stable=100, decay=40)
    for step in (0, 3, 10, 50, 100, 117, 140, 141, 500):
        want = np.float32(ref(jnp.int32(step)))
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert rel(float(got), want) <= TOL, (step, float(got), want)


@pytest.mark.parametrize("scale", [0.01, 10.0])  # under and over the clip norm 1.0
def test_clip_by_global_norm_matches_reference(scale):
    g = _tree(0, scale)
    want, wgn = ref_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    got, gn = opt.clip_by_global_norm(params_from_reference(g, device="cpu"), 1.0)
    assert rel(float(gn), float(wgn)) <= TOL
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32
        assert rel(_np(a), b) <= TOL


def test_grad_clip():
    g = {"x": torch.full((4,), 100.0)}
    clipped, gn = opt.clip_by_global_norm(g, 1.0)
    assert np.isclose(float(gn), 200.0)
    assert np.isclose(float(torch.linalg.norm(clipped["x"])), 1.0, atol=1e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_reference(param_dtype):
    """Two reference steps make a state with nonzero moments; the third step
    runs in both packages from that state (carried by
    ``opt_state_from_reference``) on the same gradients."""
    pdt = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jdt, tdt = pdt[param_dtype]
    lr_kw = dict(warmup=2, stable=10, decay=5)
    params = jax.tree.map(jnp.asarray, _tree(1))
    state = ref_opt.adamw_init(params)
    for s in (2, 3):
        params, state, _ = ref_opt.adamw_update(jax.tree.map(jnp.asarray, _tree(s)), state,
                                                lr_fn=ref_opt.wsd_schedule(1e-2, **lr_kw),
                                                param_dtype=jdt)
    grads = _tree(4, 3.0)
    want_p, want_s, want_m = ref_opt.adamw_update(
        jax.tree.map(jnp.asarray, grads), state, lr_fn=ref_opt.wsd_schedule(1e-2, **lr_kw),
        param_dtype=jdt)
    st = opt_state_from_reference(jax.tree.map(np.asarray, state), device="cpu")
    assert isinstance(st, AdamWState) and st.step.dtype == torch.int32
    p_in = params_from_reference(jax.tree.map(np.asarray, params), device="cpu")
    got_p, got_s, got_m = opt.adamw_update(params_from_reference(grads, device="cpu"), st,
                                           lr_fn=opt.wsd_schedule(1e-2, **lr_kw), params=p_in)
    assert got_p is p_in and got_s.mu is st.mu  # in place (train.optimizer's docstring)
    assert int(got_s.step) == int(want_s.step) == 3
    for k in ("lr", "grad_norm"):
        assert rel(float(got_m[k]), float(want_m[k])) <= TOL, k
    for name, got, want in (("params", got_p, want_p), ("mu", got_s.mu, want_s.mu),
                            ("nu", got_s.nu, want_s.nu), ("master", got_s.master,
                                                          want_s.master)):
        for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert a.dtype == (tdt if name == "params" else torch.float32), name
            assert rel(_np(a), np.asarray(b, np.float32)) <= TOL, name


def test_adamw_decreases_quadratic():
    w = {"a": torch.tensor([3.0, -2.0]), "b": torch.tensor([[1.5]])}
    st = opt.adamw_init(w)
    lr_fn = opt.wsd_schedule(0.1, warmup=1, stable=1000, decay=100)
    loss = lambda p: torch.sum(p["a"] ** 2) + torch.sum(p["b"] ** 2)  # noqa: E731
    l0 = float(loss(w))
    for _ in range(50):
        g = {k: 2 * v for k, v in w.items()}
        w, st, _ = opt.adamw_update(g, st, lr_fn=lr_fn, params=w, weight_decay=0.0)
        assert w["a"].data_ptr() != st.master["a"].data_ptr()  # params never alias master
    assert float(loss(w)) < 0.1 * l0
    assert int(st.step) == 50


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 5), (7, 123)])
def test_pipeline_bitwise_reference(seed, step):
    ref = RefPipeline(512, 96, 4, seed=seed).batch(step)
    got = TokenPipeline(512, 96, 4, seed=seed).batch(step, "cpu")
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.long
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


@pytest.mark.parametrize("host_id", [0, 1])
def test_pipeline_host_shards_bitwise_reference(host_id):
    ref = RefPipeline(300, 64, 6, seed=2, host_id=host_id, n_hosts=2).batch(4)
    got = TokenPipeline(300, 64, 6, seed=2, host_id=host_id, n_hosts=2).batch(4, "cpu")
    assert got["tokens"].shape == (3, 64)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_pipeline_deterministic_and_seekable():
    p1 = TokenPipeline(512, 64, 8, seed=3)
    p2 = TokenPipeline(512, 64, 8, seed=3)
    b5a = p1.batch(5, "cpu")
    _ = p1.batch(6, "cpu")
    b5b = p2.batch(5, "cpu")  # seek directly — no state
    assert torch.equal(b5a["tokens"], b5b["tokens"])
    assert not torch.equal(p1.batch(7, "cpu")["tokens"], b5a["tokens"])
    assert torch.equal(b5a["tokens"][:, 1:], b5a["labels"][:, :-1])  # next-token shifted
    with pytest.raises(ValueError):
        TokenPipeline(512, 64, 6, n_hosts=4)
