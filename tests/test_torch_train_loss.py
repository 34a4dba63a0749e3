"""Every family's ``loss_fn`` and its gradients against the reference's
``loss_fn`` and ``jax.grad``, float32, at the reduced size, on the
reference's weights; and ``ops.flash_attention`` refusing autograd.

Tolerances: ``ce`` within 1e-5 relative (read: ≤2.1e-7, whisper-tiny the
largest); ``aux`` likewise (the moe router loss; 0 elsewhere); each
gradient leaf within 1e-4 of its own max|g| (read: ≤1.9e-5, the
recurrentgemma MLP and the gemma norms the largest), a leaf with no
gradient (qwen2-vl's ``embed`` under ``embeds``) zero in both.

whisper-tiny's leaves are held to 5e-4 instead (read: 1.1e-4, the decoder's
cross-attention ``bq``). On these weights float32 itself is that far from
the exact gradient: against the float64 gradient (the port's loss_fn in
float64, held here too) the reference's float32 leaves read up to 2.4e-4
and the port's up to 1.8e-4, so two correct float32 gradients need not
agree to 1e-4. Its self-attention key biases ``bk`` (no rope) get a
gradient that is zero in exact arithmetic — a shift shared by every key
leaves the softmax unchanged — so both packages' are float32 noise (~1e-7
against a largest gradient of 2.8): they are held to ≤1e-6 of the tree's
largest gradient in both packages instead.
"""
import dataclasses

import numpy as np
import pytest
import torch

from torch_lm_common import world
from torch_train_common import batches, port_loss_and_grad, ref_loss_and_grad
from repro.configs import ARCHS
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CE_TOL = 1e-5
GRAD_TOL = 1e-4
ENCDEC_GRAD_TOL = 5e-4  # whisper-tiny: float32's own distance from float64 (docstring)
ZERO_GRAD_TOL = 1e-6


def _zero_in_exact_arithmetic(cfg, key):
    return cfg.is_encdec and key.endswith("attn/bk")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_and_grads_match_reference(arch):
    rcfg, pcfg, rparams, pparams = world(arch)
    rb, pb = batches(rcfg)
    rloss, rmet, rgrads = ref_loss_and_grad(rcfg, rparams, rb)
    loss, met, grads = port_loss_and_grad(pcfg, pparams, pb)
    assert set(met) == {"ce", "aux"}
    met = {k: float(v.detach()) for k, v in met.items()}
    assert abs(met["ce"] - rmet["ce"]) <= CE_TOL * abs(rmet["ce"]), (met, rmet)
    assert abs(met["aux"] - rmet["aux"]) <= CE_TOL * max(abs(rmet["aux"]), 1e-30)
    assert abs(float(loss.detach()) - rloss) <= CE_TOL * abs(rloss)
    assert set(grads) == set(rgrads)
    tol = ENCDEC_GRAD_TOL if rcfg.is_encdec else GRAD_TOL
    _held(rcfg, grads, rgrads, tol, arch)
    if rcfg.is_encdec:  # both float32 gradients against the float64 one
        f64 = dataclasses.replace(pcfg, param_dtype="float64", compute_dtype="float64")
        wide = lambda t: t.double() if t.is_floating_point() else t  # noqa: E731
        _, _, g64 = port_loss_and_grad(f64, torch.utils._pytree.tree_map(wide, pparams),
                                       {k: wide(v) for k, v in pb.items()})
        _held(rcfg, grads, g64, tol, f"{arch} port f32 vs f64")
        _held(rcfg, rgrads, g64, tol, f"{arch} reference f32 vs f64")


def _held(rcfg, grads, wants, tol, what):
    biggest = max(float(np.abs(np.asarray(g, np.float64)).max()) for g in wants.values())
    for k, want in wants.items():
        want = np.asarray(want, np.float64)
        got = np.asarray(grads[k], np.float64)
        assert got.shape == want.shape and np.isfinite(got).all(), k
        if _zero_in_exact_arithmetic(rcfg, k):
            assert max(np.abs(got).max(), np.abs(want).max()) <= ZERO_GRAD_TOL * biggest, k
            continue
        scale = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        assert err <= tol * scale, f"{what} {k}: {err} of max|g| {scale}"


def test_flash_attention_refuses_autograd():
    """'kernel' attention under autograd raises, on the CPU as on the card;
    serving through the kernel (no gradient) is unchanged."""
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model

    rcfg, pcfg, _, pparams = world("qwen2.5-3b")
    _, pb = batches(rcfg)
    _, _, grads = port_loss_and_grad(pcfg, pparams, pb, attn_impl="dense")
    with pytest.raises(RuntimeError, match="no backward.*'dense' or 'blocked'"):
        port_loss_and_grad(pcfg, pparams, pb, attn_impl="kernel")
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="Pallas kernel"):
        ops.flash_attention(q, q.detach(), q.detach())
    with torch.no_grad():  # grad disabled: the forward runs
        assert ops.flash_attention(q, q, q).shape == q.shape
    model = get_model(pcfg)
    toks = pb["tokens"][:, :12]
    kernel, _ = model.prefill(pparams, {"tokens": toks}, attn_impl="kernel")
    dense, _ = model.prefill(pparams, {"tokens": toks}, attn_impl="dense")
    assert not kernel.requires_grad
    np.testing.assert_allclose(kernel.numpy(), dense.numpy(), rtol=2e-4, atol=2e-4)
