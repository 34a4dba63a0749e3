"""The reference's training on global batches whose rows do not divide by
its mesh, on forced host devices, for ``tests/test_torch_train_dp_rows.py``:

    python tests/torch_train_dp_rows_ref.py SRC_DIR QWEN.npz OLMOE.npz OUT.npz

reads the reduced qwen2.5-3b's and olmoe-1b-7b's initial parameters
(``*.npz``, keyed as ``jax.tree_util.keystr``) and writes (``np.savez``),
on 4 forced host devices under ``PROFILES['train']``, with the parameters
placed by their ``logical_spec``s and ``TokenPipeline(512, 32, B, seed=0)``
batches:

* for each case of ``CASES`` on ``('data', 'model')`` = (2, 2) (``rows2``:
  qwen, B = 2, the rows split over ``data``; ``rows3``: qwen, B = 3, both
  axes dropped; ``moe2``: olmoe, B = 2): the jitted loss, its ``ce``/``aux``
  and every gradient leaf whole of batch 0 (``{case}/loss``, ``{case}/g…``)
  and, for the qwen cases, the losses and grad norms of ``STEPS`` steps of
  ``make_train_step`` (``{case}/losses``, ``{case}/norms``);
* for ``('pod', 'data')`` = (2, 2), qwen: one hierarchical step
  (``pod_compression=True``) on B = 2, each device's metrics (``pod2/met_*``,
  device order) and each pod's residuals whole (``pod2/res{pod}…``); and on
  B = 1 the exception it raises (``pod1/raised``: its type name, '' if none;
  ``pod1/message``: its first line).
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax  # noqa: E401,E402
from jax.sharding import NamedSharding  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.data.synthetic import TokenPipeline  # noqa: E402
from repro.models.registry import get_model  # noqa: E402
from repro.sharding.rules import PROFILES, logical_spec  # noqa: E402
from repro.train.grad_compression import init_residuals  # noqa: E402
from repro.train.optimizer import adamw_init  # noqa: E402
from repro.train.train_step import make_train_step  # noqa: E402

LR, WARMUP, S, STEPS = 1e-3, 2, 32, 2
CASES = {"rows2": ("qwen2.5-3b", 2, True), "rows3": ("qwen2.5-3b", 3, True),
         "moe2": ("olmoe-1b-7b", 2, False)}
rules = PROFILES["train"]
devs = np.array(jax.devices()[:4])
out = {}


def world(arch, path):
    """(cfg, model, logical axes, the parameters of ``path``)."""
    cfg = reduce_for_smoke(get_config(arch))
    model = get_model(cfg)
    skel, axes = model.init(jax.random.key(0))
    given = np.load(path)
    flat, treedef = jax.tree_util.tree_flatten_with_path(skel)
    params = jax.tree_util.tree_unflatten(
        treedef, [np.asarray(given[jax.tree_util.keystr(kp)]) for kp, _ in flat])
    return cfg, model, axes, params


def placed(mesh, axes, params):
    """The parameters placed on ``mesh`` by their specs."""
    return jax.tree.map(lambda ax, p: jax.device_put(
        p, NamedSharding(mesh, logical_spec(p.shape, ax, mesh, rules))), axes, params,
        is_leaf=lambda x: isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x))


worlds = {"qwen2.5-3b": world("qwen2.5-3b", sys.argv[2]),
          "olmoe-1b-7b": world("olmoe-1b-7b", sys.argv[3])}
mesh = jax.sharding.Mesh(devs.reshape(2, 2), ("data", "model"))
for name, (arch, B, steps) in CASES.items():
    cfg, model, axes, params = worlds[arch]
    pipe = TokenPipeline(cfg.vocab, S, B, seed=0)
    p = placed(mesh, axes, params)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, mesh=mesh, rules=rules), has_aux=True))
    (loss, met), g = grad(p, pipe.batch(0))
    out[f"{name}/loss"] = np.asarray(loss)
    for k, v in met.items():
        out[f"{name}/{k}"] = np.asarray(v)
    for kp, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[f"{name}/g" + jax.tree_util.keystr(kp)] = np.asarray(v)
    if not steps:
        continue
    step = jax.jit(make_train_step(model.loss_fn, cfg, mesh=mesh, rules=rules, lr=LR,
                                   warmup=WARMUP))
    opt, losses, norms = adamw_init(p), [], []
    for t in range(STEPS):
        p, opt, m = step(p, opt, pipe.batch(t))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    out[f"{name}/losses"], out[f"{name}/norms"] = np.array(losses), np.array(norms)

cfg, model, axes, params = worlds["qwen2.5-3b"]
mesh = jax.sharding.Mesh(devs.reshape(2, 2), ("pod", "data"))
step = jax.jit(make_train_step(model.loss_fn, cfg, mesh=mesh, rules=rules, lr=LR, warmup=WARMUP,
                               pod_compression=True))
p = placed(mesh, axes, params)
_, _, res, met = step(p, adamw_init(p), init_residuals(p), TokenPipeline(cfg.vocab, S, 2).batch(0))
order = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
for k, v in met.items():
    shards = sorted(v.addressable_shards, key=lambda s: order[s.device])
    out["pod2/met_" + k] = np.array([float(s.data) for s in shards])
for kp, v in jax.tree_util.tree_flatten_with_path(res)[0]:
    whole = [np.zeros(v.shape, np.float32) for _ in range(2)]
    for s in v.addressable_shards:
        whole[order[s.device] // 2][s.index] = np.asarray(s.data)
    for pod in range(2):
        out[f"pod2/res{pod}" + jax.tree_util.keystr(kp)] = whole[pod]
try:
    step(p, adamw_init(p), init_residuals(p), TokenPipeline(cfg.vocab, S, 1).batch(0))
    out["pod1/raised"] = np.array("")
except Exception as e:  # noqa: BLE001 — the test reads which
    out["pod1/raised"] = np.array(type(e).__name__)
    out["pod1/message"] = np.array(str(e).splitlines()[0] if str(e) else "")
np.savez(sys.argv[4], **out)
