"""Training checkpoints across the packages, ``run_training`` on the CPU and
the training example.

* A ``{"params", "opt": AdamWState}`` tree saved by the reference's
  ``save_checkpoint`` restores in the port, bitwise, bfloat16 leaves
  included (NamedTuple fields keyed by name, ``"['opt'].mu['embed']"``, as
  ``jax.tree_util.keystr`` writes them). The same tree saved by the port
  writes the reference's files byte for byte and the reference's
  ``meta.json`` leaves; the reference's ``restore_checkpoint`` reads the
  port's float32 training checkpoint bitwise. (It cannot read a bfloat16
  leaf with this NumPy, its own included: ``np.load`` gives the 2-byte
  records back as ``|V2``, which ``jnp.asarray`` refuses to cast.)
* ``run_training`` on reduced qwen2.5-3b: over its first 60 steps the loss
  falls by ≥ 0.2 (the reference's own criterion, ``tests/test_substrate.py``);
  resumed from the step-60 checkpoint it runs steps 60-64 with bitwise the
  losses of the uninterrupted 65-step run, and logs "resumed from step 60".
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as ref_restore
from repro.ckpt import save_checkpoint as ref_save
from repro.configs import get_config as ref_get_config
from repro.configs import reduce_for_smoke as ref_reduce
from repro.models.registry import get_model as ref_get_model
from repro.train import optimizer as ref_opt
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch.train import run_training
from repro_torch.models.registry import get_model
from repro_torch.models.weights import opt_state_from_reference, params_from_reference
from repro_torch.train.optimizer import AdamWState, adamw_init, tree_leaves, tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_tree(param_dtype):
    """The reference's reduced qwen2.5 params and a one-step AdamW state."""
    cfg = dataclasses.replace(ref_reduce(ref_get_config("qwen2.5-3b")), param_dtype=param_dtype)
    params, _ = ref_get_model(cfg).init(jax.random.key(3))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    params, opt, _ = ref_opt.adamw_update(grads, ref_opt.adamw_init(params),
                                          lr_fn=ref_opt.wsd_schedule(1e-2, warmup=1),
                                          param_dtype=params["embed"].dtype)
    return {"params": params, "opt": opt}


def _port_skeleton(param_dtype):
    """The port's tree after a train step: every parameter in ``param_dtype``
    (the step casts the float32 norms, as the reference's does)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("qwen2.5-3b")), param_dtype=param_dtype)
    params = get_model(cfg).init(0, device="cpu")
    opt = adamw_init(params)
    return {"params": tree_map(lambda t: t.to(getattr(torch, param_dtype)), params), "opt": opt}


def _port_copy(tree):
    host = jax.tree.map(np.asarray, tree)
    return {"params": params_from_reference(host["params"], device="cpu"),
            "opt": opt_state_from_reference(host["opt"], device="cpu")}


def _bits(t):
    t = t.detach()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_reference_training_checkpoint_restores_in_port(tmp_path, param_dtype):
    tree = _ref_tree(param_dtype)
    ref_save(str(tmp_path), 7, tree)
    with open(tmp_path / "step_000000007" / "meta.json") as f:
        keys = [leaf["key"] for leaf in json.load(f)["leaves"]]
    assert "['opt'].step" in keys and "['opt'].mu['embed']" in keys
    got, step, _ = restore_checkpoint(str(tmp_path), _port_skeleton(param_dtype))
    assert step == 7 and isinstance(got["opt"], AdamWState)
    want = _port_copy(tree)
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    assert got["params"]["embed"].dtype == getattr(torch, param_dtype)


@pytest.mark.parametrize("param_dtype", ["bfloat16", "float32"])
def test_port_training_checkpoint_is_the_reference_layout(tmp_path, param_dtype):
    tree = _ref_tree(param_dtype)
    ref_save(str(tmp_path / "ref"), 7, tree)
    save_checkpoint(str(tmp_path / "port"), 7, _port_copy(tree))
    d_ref, d_port = (tmp_path / w / "step_000000007" for w in ("ref", "port"))
    meta = [json.load(open(d / "meta.json"))["leaves"] for d in (d_ref, d_port)]
    assert meta[0] == meta[1]
    for leaf in meta[0]:
        assert (d_ref / leaf["file"]).read_bytes() == (d_port / leaf["file"]).read_bytes(), leaf
    if param_dtype == "float32":  # the reference reads the port's checkpoint
        skel = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree)
        got, step, _ = ref_restore(str(tmp_path / "port"), skel)
        assert step == 7
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_restore_in_place_keeps_the_tensors(tmp_path):
    skel = _port_skeleton("bfloat16")
    save_checkpoint(str(tmp_path), 1, _port_copy(_ref_tree("bfloat16")))
    before = [t.data_ptr() for t in tree_leaves(skel)]
    got, _, _ = restore_checkpoint(str(tmp_path), skel, in_place=True)
    assert [t.data_ptr() for t in tree_leaves(got)] == before
    for a, b in zip(tree_leaves(got), tree_leaves(_port_copy(_ref_tree("bfloat16")))):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_run_training_loss_falls_and_resume_is_exact(tmp_path):
    cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
    kw = dict(global_batch=4, seq_len=64, lr=2e-3, warmup=10, device="cpu")
    # uninterrupted: 65 steps, checkpoints at steps 60 and 65
    _, opt, straight = run_training(cfg, steps=65, ckpt_dir=str(tmp_path / "a"), ckpt_every=60,
                                    log_fn=lambda line: None, **kw)
    assert int(opt.step) == 65 and len(straight) == 65
    losses = straight[:60]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.2, (losses[:5], losses[-5:])
    # resumed: the step-60 checkpoint alone, 5 more steps
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    shutil.rmtree(tmp_path / "b" / "step_000000065")
    logs = []
    _, opt, more = run_training(cfg, steps=65, ckpt_dir=str(tmp_path / "b"), ckpt_every=1000,
                                log_fn=logs.append, **kw)
    assert int(opt.step) == 65 and len(more) == 5
    assert any("resumed from step 60" in line for line in logs)
    assert more == straight[60:]  # bitwise


def test_run_training_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device trains")
    cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(cfg, steps=1, global_batch=2, seq_len=8)


def test_train_example_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    run = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "train_lm_torch.py"),
                          "--steps", "3", "--batch", "2", "--seq", "32", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)], capture_output=True, text=True,
                         timeout=300, env=env)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "over 3 steps" in run.stdout and "[train] step 2 loss" in run.stdout
