"""The port's train step (``repro_torch.train.train_step``) and int8
error-feedback all-reduce (``train.grad_compression``) against the
reference's jitted ones.

Three plain steps of reduced qwen2.5-3b from the reference's initial
params and AdamW state, on ``TokenPipeline`` batches:

* chained (each package carries its own state): ``lr`` bitwise, ``loss``
  within 1e-5 relative (read 2.2e-6), and the params at the end within
  0.1·Σ lr of the reference's, every element (read: 0.055·Σ lr). After
  three Adam steps every element has moved by about Σ lr, so a wrong
  update direction or size shows at that scale; an element whose gradient
  is near zero — within float32 noise, where the sign of ``g`` and the
  ratio ``g / (|g| + eps)`` hang on a rounding — could move up to 2·lr
  apart in one step, which the bound would flag (none does);
* each step from the reference's state of the step before (so the step, not
  the diverging trajectory, is compared): ``grad_norm`` within 1e-4
  relative (read ≤9.8e-6 here; 5.1e-5 on the weights of seed 2: the
  gradients themselves agree to float32 noise, which
  ``test_torch_train_loss.py`` bounds at 1e-4 of each leaf).

The reference's ``compressed_allreduce`` (4 members, 8 rounds of error
feedback) and one hierarchical step (2 members, ``pod_compression=True``)
run in a subprocess on forced host devices (``tests/torch_train_pod_ref.py``).
The port's list form gives bitwise its means and residuals. Its
hierarchical step on ``ShardMesh.on_one_device(2, 'cpu', axis='pod')``:
the members' mean loss within 1e-5 of the mean of the reference's
per-member losses, ``lr`` bitwise, ``grad_norm`` within 1e-4; params within
1e-3·lr of the reference's (read 2.4e-4·lr; an element whose int8 sum
turned between 0 and ±1 on float32 noise would move ~lr apart: none does);
each member's residual within 1e-2 of one int8 quantum (2·max|r|; read
3.0e-3: the gradients' float32 noise) but for at most 0.1 % of the
elements (read ≤0.025 %), which sat on a rounding boundary and differ by
one quantum.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from torch_lm_common import flat, world
from repro.data.synthetic import TokenPipeline as RefPipeline
from repro.models.registry import get_model as ref_get_model
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.ckpt.checkpoint import _flatten, _unflatten
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.distributed import ShardMesh
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.models.registry import get_model
from repro_torch.models.weights import opt_state_from_reference, params_from_reference
from repro_torch.train.grad_compression import compressed_allreduce, init_residuals
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import make_train_step
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

LR, WARMUP, STEPS, B, S = 1e-3, 2, 3, 4, 32
LOSS_TOL = 1e-5
NORM_TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def test_three_steps_match_reference():
    rcfg, pcfg, rparams, pparams = world("qwen2.5-3b")
    ref_step = jax.jit(ref_make_train_step(ref_get_model(rcfg).loss_fn, rcfg, lr=LR,
                                           warmup=WARMUP))
    step = make_train_step(get_model(pcfg).loss_fn, pcfg, lr=LR, warmup=WARMUP)
    ropt = ref_adamw_init(rparams)
    popt = opt_state_from_reference(_host(ropt), device="cpu")
    lrs = []
    for t in range(STEPS):
        rb = RefPipeline(rcfg.vocab, S, B, seed=1).batch(t)
        pb = TokenPipeline(pcfg.vocab, S, B, seed=1).batch(t, "cpu")
        # the step alone: from the reference's state of the step before
        p1, o1, m1 = step(params_from_reference(_host(rparams), device="cpu"),
                          opt_state_from_reference(_host(ropt), device="cpu"), pb)
        rparams, ropt, rm = ref_step(rparams, ropt, rb)
        assert _rel(m1["grad_norm"], rm["grad_norm"]) <= NORM_TOL, t
        assert float(m1["lr"]) == float(rm["lr"]) and int(o1.step) == t + 1
        # the trajectory: each package from its own state
        pparams, popt, pm = step(pparams, popt, pb)
        assert _rel(pm["loss"], rm["loss"]) <= LOSS_TOL, (t, float(pm["loss"]), rm["loss"])
        assert float(pm["lr"]) == float(rm["lr"])
        assert set(pm) == {"loss", "ce", "aux", "lr", "grad_norm"}
        lrs.append(float(rm["lr"]))
    bound = 0.1 * sum(lrs)
    want = flat(rparams)
    for k, v in flat(pparams).items():
        err = float(np.abs(v.numpy() - np.asarray(want[k])).max())
        assert err <= bound, f"{k}: {err / sum(lrs)} of Σ lr"


@pytest.fixture(scope="module")
def pod_ref(tmp_path_factory):
    """The reference's pod runs (tests/torch_train_pod_ref.py), as arrays."""
    out = str(tmp_path_factory.mktemp("pod") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, os.path.join(ROOT, "tests", "torch_train_pod_ref.py"),
                          os.path.join(ROOT, "src"), out], capture_output=True, text=True,
                         timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


def test_compressed_allreduce_bitwise_reference(pod_ref):
    xs = [torch.from_numpy(x) for x in pod_ref["ef_xs"]]
    res = [torch.zeros(x.shape) for x in xs]
    for it in range(8):  # error feedback: each round from the residuals of the last
        mean, res = compressed_allreduce(xs, res, ["cpu"] * len(xs))
        for i, r in enumerate(res):
            np.testing.assert_array_equal(mean.numpy(), pod_ref[f"ef{it}_mean"][i])
            np.testing.assert_array_equal(r.numpy(), pod_ref[f"ef{it}_res"][i])


def test_hierarchical_step_matches_reference(pod_ref):
    cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
    model = get_model(cfg)
    skel = model.init(0, device="cpu")
    params = _unflatten(skel, iter(torch.from_numpy(pod_ref["p0" + k]) for k, _ in
                                   _flatten(skel)))
    mesh = ShardMesh.on_one_device(2, "cpu", axis="pod")
    step = make_train_step(model.loss_fn, cfg, mesh=mesh, lr=LR, warmup=WARMUP,
                           pod_compression=True)
    batch = TokenPipeline(cfg.vocab, S, B, seed=0).batch(0, "cpu")
    p1, _, res, met = step(params, adamw_init(params), [init_residuals(params)] * 2, batch)
    assert _rel(met["loss"], pod_ref["met_loss"].mean()) <= LOSS_TOL
    assert float(met["lr"]) == float(pod_ref["met_lr"][0])
    assert _rel(met["grad_norm"], pod_ref["met_grad_norm"][0]) <= NORM_TOL
    lr = float(met["lr"])
    for k, v in _flatten(p1):
        assert float(np.abs(v.numpy() - pod_ref["p1" + k]).max()) <= 1e-3 * lr, k
    for i in range(2):
        for k, v in _flatten(res[i]):
            want = pod_ref[f"res{i}" + k]
            quantum = 2 * float(np.abs(want).max())
            d = np.abs(v.numpy() - want) / quantum
            flip = d > 0.5  # one quantum: a rounding boundary crossed on float32 noise
            assert flip.mean() <= 1e-3 and (d[flip] <= 1.01).all(), (i, k, flip.mean())
            assert d[~flip].max() <= 1e-2, (i, k, d[~flip].max())
