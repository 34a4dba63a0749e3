"""Shared helpers of the LM family tests (``tests/test_torch_lm_*.py``): the
reduced configs of both packages, the reference's seeded weights carried into
the port, tree flattening and the comparisons at the reference's serving
tolerance."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models import transformer as ref_tf
from repro.models.registry import get_model as ref_get_model
from repro_torch import configs
from repro_torch.models.weights import params_from_reference

TOL = 2e-4  # tests/test_models_smoke.py's serving oracle (f32)
# the reference's decoder-only entry points, each compiled once per shape:
# called eagerly, every call traces and compiles its scans and ops anew
# (a 5-layer hybrid forward: 6.4 s eager, 1.4 s jitted, on the CPU)
ref_forward = jax.jit(ref_tf.forward, static_argnums=1, static_argnames=("attn_impl",))
ref_prefill = jax.jit(ref_tf.prefill, static_argnums=1, static_argnames=("attn_impl",))
ref_decode = jax.jit(ref_tf.decode_step, static_argnums=1)
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def np_(t):
    return t.detach().float().numpy()


def close(got, want, what, tol=TOL):
    """``got`` within rtol = atol = ``tol`` of ``want``; returns max |error|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=f"{what}: max err {err}")
    return err


def rel_err(got, want):
    """max |got − want| / max |want| (both as float32 numpy)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def flat(tree, pre=""):
    """{path: leaf} of a nested dict / list tree (either package's)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{pre}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, f"{pre}/{i}"))
        return out
    return {pre: tree}


def configs_for(arch, **overrides):
    """(reference config, port config): the reduced miniature of ``arch``
    with the same ``overrides`` applied to both."""
    ref = dataclasses.replace(ref_reduce(ref_get_config(arch)), **overrides)
    port = dataclasses.replace(configs.reduce_for_smoke(configs.get_config(arch)), **overrides)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def world(arch, seed=1, **overrides):
    """(reference cfg, port cfg, reference params, the port's copy)."""
    rcfg, pcfg = configs_for(arch, **overrides)
    params, _ = ref_get_model(rcfg).init(jax.random.key(seed))
    return rcfg, pcfg, params, params_from_reference(jax.tree.map(np.asarray, params),
                                                     device="cpu")


def assert_same_tree(port_tree, ref_tree, what):
    """Keys (list positions included), shapes and dtypes equal."""
    fp, fr = flat(port_tree), flat(ref_tree)
    assert set(fp) == set(fr), (what, sorted(set(fp) ^ set(fr)))
    for k, v in fr.items():
        assert tuple(fp[k].shape) == tuple(v.shape), (what, k, fp[k].shape, v.shape)
        assert fp[k].dtype == DTYPES[str(v.dtype)], (what, k, fp[k].dtype, v.dtype)


def assert_trees_close(port_tree, ref_tree, what, tol=TOL):
    """Same structure, every leaf within ``tol``; returns the worst error."""
    assert_same_tree(port_tree, ref_tree, what)
    fr = flat(ref_tree)
    return max([close(np_(v), fr[k], f"{what} {k}", tol) for k, v in flat(port_tree).items()],
               default=0.0)


def port_init_matches_reference(pcfg, ref_params, init):
    """The port's own seeded init builds the reference's tree."""
    assert_same_tree(init(pcfg, 0, device="cpu"), ref_params, pcfg.arch_id)
