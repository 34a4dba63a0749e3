"""Sharding rules, meshes and abstract parameters of the port
(``repro_torch.sharding.rules``, ``compat``, ``launch.mesh``,
``models.registry.abstract_params`` / ``input_specs`` / ``cache_axes``)
against the JAX package.

* For all 10 architectures at FULL size, every parameter leaf of
  ``abstract_params`` (meta tensors, nothing allocated) has the shape, dtype
  and logical axes of the reference's (``jax.eval_shape`` of its init), and
  its spec under each of the four profiles on both production meshes equals
  the reference's ``logical_spec`` — which reads only ``mesh.shape``, so the
  port's ``ShardMesh`` is passed to it. The same for every decode cache leaf
  (``cache_axes`` beside ``init_cache(device='meta')``; the hybrid's tail,
  which the reference's cache leaves out, Queue C 11, carries the pattern's
  axes without ``"layers"``).
* ``input_specs`` equals the reference's in keys, shapes and dtypes for
  every runnable cell.
* The dry-run's per-device parameter, gradient and AdamW bytes equal those
  computed from the reference's specs and shapes.
* ``make_train_step(mesh=ShardMesh 1 × 1, rules=PROFILES['train'])`` at the
  reduced size equals the reference's step under ``make_local_mesh()`` and
  the same rules, to ``test_torch_train_step.py``'s tolerances;
  ``run_training(mesh=)`` equals the run without a mesh; a ``ShardMesh``
  over two devices in one process raises, naming ``ProcessMesh``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.data.synthetic import TokenPipeline as RefPipeline
from repro.launch.mesh import make_local_mesh as ref_local_mesh
from repro.models.registry import abstract_params as ref_abstract_params
from repro.models.registry import abstract_tree as ref_abstract_tree
from repro.models.registry import get_model as ref_get_model
from repro.models.registry import input_specs as ref_input_specs
from repro.sharding.rules import PROFILES as REF_PROFILES
from repro.sharding.rules import logical_spec as ref_logical_spec
from repro.train.optimizer import adamw_init as ref_adamw_init
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.compat import host_mesh, make_mesh
from repro_torch.configs import ARCHS, SHAPES, get_config, reduce_for_smoke, runnable_cells
from repro_torch.core.distributed import ShardMesh
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.launch.train import run_training
from repro_torch.models.registry import (abstract_params, abstract_tree, cache_axes, get_model,
                                         input_specs)
from repro_torch.models.weights import opt_state_from_reference
from repro_torch.sharding.rules import PROFILES, ShardingRules, logical_sharding, logical_spec
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.train_step import make_train_step
from torch_lm_common import flat, world
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

MESHES = {"pod1": make_production_mesh(), "pod2": make_production_mesh(multi_pod=True)}
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "int32": torch.int32}
ARCH_IDS = sorted(ARCHS)
_REF = {}


def _axes_flat(tree, pre=""):
    """{path: logical axes} of an axes tree (tuples of names are leaves)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {pre: tuple(tree)}
    return {k: v for key, sub in items for k, v in _axes_flat(sub, f"{pre}/{key}").items()}


def _ref_params(arch):
    if arch not in _REF:
        _REF[arch] = ref_abstract_params(ref_get_config(arch))
    return _REF[arch]


def _same_leaf(port, ref, what):
    assert tuple(port.shape) == tuple(ref.shape), (what, tuple(port.shape), ref.shape)
    assert port.dtype == DTYPES[str(ref.dtype)], (what, port.dtype, ref.dtype)
    assert port.device.type == "meta", what


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_reference(arch):
    rp, rax = _ref_params(arch)
    pp, pax = abstract_params(get_config(arch))
    fr, fp = flat(rp), flat(pp)
    ar, ap = _axes_flat(rax), _axes_flat(pax)
    assert set(fp) == set(fr) == set(ap) == set(ar)
    for k in fr:
        _same_leaf(fp[k], fr[k], k)
        assert ap[k] == ar[k], (k, ap[k], ar[k])
        for mname, mesh in MESHES.items():
            for prof in PROFILES:
                want = tuple(ref_logical_spec(fr[k].shape, ar[k], mesh, REF_PROFILES[prof]))
                got = logical_spec(tuple(fp[k].shape), ap[k], mesh, PROFILES[prof])
                assert got == want, (k, mname, prof, got, want)


def _ref_cache(rcfg, B, S):
    model = ref_get_model(rcfg)
    if rcfg.is_encdec:
        return ref_abstract_tree(lambda: model.init_cache(B, S, jnp.bfloat16, enc_seq=S))
    return ref_abstract_tree(lambda: model.init_cache(B, S, jnp.bfloat16))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    model = get_model(cfg)
    for sname in [s for a, s in runnable_cells() if a == arch and SHAPES[s].kind == "decode"]:
        B, S = SHAPES[sname].global_batch, SHAPES[sname].seq_len
        kw = dict(enc_seq=S) if cfg.is_encdec else {}
        tree, axes = abstract_tree(lambda: (model.init_cache(B, S, torch.bfloat16, device="meta",
                                                             **kw), cache_axes(cfg)))
        rtree, raxes = _ref_cache(rcfg, B, S)
        fp, fr, ap, ar = flat(tree), flat(rtree), _axes_flat(axes), _axes_flat(raxes)
        assert set(fp) == set(ap)
        tail = {k for k in fp if k.startswith("/tail/")}
        assert set(fp) - tail == set(fr) == set(ar)
        for k in fr:
            _same_leaf(fp[k], fr[k], k)
            assert ap[k] == ar[k], (k, ap[k], ar[k])
            for mesh in MESHES.values():
                for prof in PROFILES:
                    want = tuple(ref_logical_spec(fr[k].shape, ar[k], mesh, REF_PROFILES[prof]))
                    assert logical_spec(tuple(fp[k].shape), ap[k], mesh, PROFILES[prof]) == want
        for k in tail:  # the tail's layers: a pattern position's axes, one layer
            leaf = k.rsplit("/", 1)[1]
            kind = "rec" if leaf in ("conv", "h") else "attn"
            twin = f"/p{cfg.block_pattern.index(kind)}/{leaf}"
            assert ap[k] == ar[twin][1:], (k, ap[k], ar[twin])
            assert tuple(fp[k].shape) == tuple(fr[twin].shape[1:]), k


@pytest.mark.parametrize("arch,shape", runnable_cells())
def test_input_specs_match_reference(arch, shape):
    got = input_specs(get_config(arch), SHAPES[shape])
    want = ref_input_specs(ref_get_config(arch), REF_SHAPES[shape])
    assert set(got) == set(want)
    for k, v in want.items():
        _same_leaf(got[k], v, k)
    small = input_specs(get_config(arch), SHAPES[shape], reduced=True)
    for k, v in ref_input_specs(ref_get_config(arch), REF_SHAPES[shape], reduced=True).items():
        _same_leaf(small[k], v, k)


def _block_bytes(shape, spec, mesh, itemsize):
    n = 1
    for d, e in zip(shape, spec):
        axes = () if e is None else ((e,) if isinstance(e, str) else tuple(e))
        n *= d // math.prod(mesh.shape[a] for a in axes)
    return n * itemsize


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_bytes_match_reference_specs(arch):
    """Parameters and gradients at the parameter dtype (the step's steady
    state), float32 mu, nu and master, the int32 step; per device."""
    cfg = get_config(arch)
    rp, rax = _ref_params(arch)
    fr, ar = flat(rp), _axes_flat(rax)
    pbytes = np.dtype(jnp.dtype(cfg.param_dtype)).itemsize
    pp, pax = abstract_params(cfg)
    for mname, mesh in MESHES.items():
        prof = "train_pod" if mname == "pod2" else "train"
        want_p = want_o = 0
        for k, v in fr.items():
            spec = tuple(ref_logical_spec(v.shape, ar[k], mesh, REF_PROFILES[prof]))
            want_p += _block_bytes(v.shape, spec, mesh, pbytes)
            want_o += 3 * _block_bytes(v.shape, spec, mesh, 4)
        st = dryrun._state(cfg, SHAPES["train_4k"], mesh, PROFILES[prof], pp, pax)
        assert (st["param_bytes"], st["grad_bytes"], st["opt_bytes"]) == \
            (want_p, want_p, want_o + 4), (mname, st)


def test_logical_sharding_block_and_fallback():
    mesh = MESHES["pod1"]
    # MQA: one kv head under a 16-way model axis stays replicated
    sh = logical_sharding((2048, 1, 256), ("embed_fsdp", "kv_heads", "head_dim"), mesh,
                          PROFILES["train"], torch.bfloat16)
    assert sh.spec == ("data", None, None)
    assert sh.shard_shape == (128, 1, 256) and sh.shard_nbytes == 128 * 256 * 2
    # an axis is used once: batch takes (pod, data), seq then only model
    sh = logical_sharding((64, 4096, 8), ("act_batch", "act_seq", None), MESHES["pod2"],
                          PROFILES["train_pod"])
    assert sh.spec == (("pod", "data"), "model", None) and sh.shard_shape == (2, 256, 8)
    rules = ShardingRules({"x": ("data", "model")})
    assert logical_spec((48,), ("x",), mesh, rules) == ("data",)  # 48 % 256: model dropped
    with pytest.raises(ValueError):
        logical_spec((4, 4), ("x",), mesh, rules)


def test_meshes():
    for multi, shape in ((False, {"data": 16, "model": 16}),
                         (True, {"pod": 2, "data": 16, "model": 16})):
        m = make_production_mesh(multi_pod=multi)
        assert m.shape == shape and {d.type for d in m.devices} == {"meta"}
        assert len(m.devices) == math.prod(shape.values())
    local = make_local_mesh(device="cpu")
    assert local.shape == {"data": 1, "model": 1} and local.devices == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh()
    devs = [torch.device("cpu", i) for i in range(6)]
    m = host_mesh((2, 2), ("a", "b"), devices=devs)
    assert m.shape == {"a": 2, "b": 2} and m.devices == devs[:4]
    assert m.shard_devices(["b"]) == devs[:2]  # row-major: a outermost
    assert make_mesh((3, 2), ("x", "y"), devs).devices == devs
    with pytest.raises(ValueError, match="needs 8"):
        host_mesh(8, devices=devs)


def test_abstract_params_allocate_nothing():
    cfg = get_config("qwen3-moe-235b-a22b")  # 235 B parameters
    params, _ = abstract_params(cfg)
    leaves = list(flat(params).values())
    assert {t.device.type for t in leaves} == {"meta"}
    assert sum(t.numel() for t in leaves) > 2e11
    with pytest.raises(ValueError, match="allocated on cpu"):
        abstract_tree(lambda: ({"a": torch.zeros(2, device="cpu")}, {"a": (None,)}))


LR, WARMUP, STEPS, B, S = 1e-3, 2, 3, 4, 32


def _host(tree):
    return jax.tree.map(np.asarray, tree)


def test_train_step_on_a_1x1_mesh_matches_reference():
    rcfg, pcfg, rparams, pparams = world("qwen2.5-3b")
    rules = PROFILES["train"]
    ref_step = jax.jit(ref_make_train_step(ref_get_model(rcfg).loss_fn, rcfg,
                                           mesh=ref_local_mesh(), rules=REF_PROFILES["train"],
                                           lr=LR, warmup=WARMUP))
    mesh = ShardMesh(["cpu"], shape=(1, 1), axis_names=("data", "model"))
    step = make_train_step(get_model(pcfg).loss_fn, pcfg, mesh=mesh, rules=rules, lr=LR,
                           warmup=WARMUP)
    assert step.specs()["/embed"] == ("model", "data")
    ropt = ref_adamw_init(rparams)
    popt = opt_state_from_reference(_host(ropt), device="cpu")
    lrs = []
    for t in range(STEPS):
        rb = RefPipeline(rcfg.vocab, S, B, seed=1).batch(t)
        pb = TokenPipeline(pcfg.vocab, S, B, seed=1).batch(t, "cpu")
        pparams, popt, pm = step(pparams, popt, pb)
        rparams, ropt, rm = ref_step(rparams, ropt, rb)
        rel = abs(float(pm["loss"]) - float(rm["loss"])) / abs(float(rm["loss"]))
        assert rel <= 1e-5, (t, rel)
        assert float(pm["lr"]) == float(rm["lr"])
        lrs.append(float(rm["lr"]))
    want = flat(rparams)
    for k, v in flat(pparams).items():
        assert float(np.abs(v.numpy() - np.asarray(want[k])).max()) <= 0.1 * sum(lrs), k


def test_run_training_takes_a_mesh():
    cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
    kw = dict(steps=2, global_batch=2, seq_len=16, device="cpu", log_fn=lambda line: None)
    _, _, plain = run_training(cfg, **kw)
    mesh = ShardMesh(["cpu"], shape=(1, 1), axis_names=("data", "model"))
    _, _, meshed = run_training(cfg, mesh=mesh, profile="train", **kw)
    assert meshed == plain
    with pytest.raises(KeyError):
        run_training(cfg, mesh=mesh, profile="no-such-profile", **kw)
    two = ShardMesh([torch.device("cpu", 0), torch.device("cpu", 1)])
    with pytest.raises(NotImplementedError, match="ProcessMesh"):
        run_training(cfg, mesh=two, **kw)
    with pytest.raises(NotImplementedError, match="ProcessMesh"):
        make_train_step(get_model(cfg).loss_fn, cfg, mesh=two, rules=PROFILES["train"])
    meta = ShardMesh(["meta"], shape=(1, 1), axis_names=("data", "model"))
    step = make_train_step(get_model(cfg).loss_fn, cfg, mesh=meta, rules=PROFILES["train"])
    params = get_model(cfg).init(0, device="cpu")
    with pytest.raises(ValueError, match="mesh positions on meta"):
        step(params, adamw_init(params), TokenPipeline(cfg.vocab, 16, 2, seed=0).batch(0, "cpu"))
