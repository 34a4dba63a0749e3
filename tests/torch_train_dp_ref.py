"""The reference's training on meshes of forced host devices, for
``tests/test_torch_train_dp.py``:

    python tests/torch_train_dp_ref.py SRC_DIR PARAMS.npz OUT.npz

reads reduced qwen2.5-3b's initial parameters (``PARAMS.npz``, keyed as
``jax.tree_util.keystr``) and writes (``np.savez``), on 4 forced host
devices under ``PROFILES['train']``, with the parameters placed by their
``logical_spec``s and ``TokenPipeline(512, 32, 4, seed=0)`` batches:

* for the meshes ``data4`` (``('data',)`` = 4) and ``data2x2``
  (``('data', 'model')`` = (2, 2)): the jitted loss, its ``ce``/``aux``
  and every gradient leaf whole (``{mesh}/loss``, ``{mesh}/g…``) of batch
  0, and the losses of three ``make_train_step`` steps (``{mesh}/losses``);
* for ``('data', 'model')`` = (2, 2): each device's slice of an array of
  ``block_shape`` under the specs ``block_cases`` lists (``blocks{i}``:
  [device in mesh order, dimension, (start, stop)]);
* for ``('pod', 'data')`` = (2, 2): one hierarchical step
  (``pod_compression=True``): each device's metrics (``hier/met_*``, device
  order) and each pod's residuals whole, put together from the devices'
  shards (``hier/res{pod}…``).
"""
import json
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax  # noqa: E401,E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from repro.configs import get_config, reduce_for_smoke  # noqa: E402
from repro.data.synthetic import TokenPipeline  # noqa: E402
from repro.models.registry import get_model  # noqa: E402
from repro.sharding.rules import PROFILES, logical_spec  # noqa: E402
from repro.train.grad_compression import init_residuals  # noqa: E402
from repro.train.optimizer import adamw_init  # noqa: E402
from repro.train.train_step import make_train_step  # noqa: E402

LR, WARMUP, B, S, STEPS = 1e-3, 2, 4, 32, 3
rules = PROFILES["train"]
cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
model = get_model(cfg)
skel, axes = model.init(jax.random.key(0))
given = np.load(sys.argv[2])
flat, treedef = jax.tree_util.tree_flatten_with_path(skel)
params = jax.tree_util.tree_unflatten(
    treedef, [np.asarray(given[jax.tree_util.keystr(kp)]) for kp, _ in flat])
pipe = TokenPipeline(cfg.vocab, S, B, seed=0)
out = {}


def placed(mesh):
    """The parameters placed on ``mesh`` by their specs."""
    return jax.tree.map(lambda ax, p: jax.device_put(
        p, NamedSharding(mesh, logical_spec(p.shape, ax, mesh, rules))), axes, params,
        is_leaf=lambda x: isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x))


devs = np.array(jax.devices()[:4])
for name, shape, names in (("data4", (4,), ("data",)),
                           ("data2x2", (2, 2), ("data", "model"))):
    mesh = jax.sharding.Mesh(devs.reshape(shape), names)
    p = placed(mesh)
    grad = jax.jit(jax.value_and_grad(
        lambda p, b: model.loss_fn(p, b, mesh=mesh, rules=rules), has_aux=True))
    (loss, met), g = grad(p, pipe.batch(0))
    out[f"{name}/loss"] = np.asarray(loss)
    for k, v in met.items():
        out[f"{name}/{k}"] = np.asarray(v)
    for kp, v in jax.tree_util.tree_flatten_with_path(g)[0]:
        out[f"{name}/g" + jax.tree_util.keystr(kp)] = np.asarray(v)
    step = jax.jit(make_train_step(model.loss_fn, cfg, mesh=mesh, rules=rules, lr=LR,
                                   warmup=WARMUP))
    opt, losses = adamw_init(p), []
    for t in range(STEPS):
        p, opt, m = step(p, opt, pipe.batch(t))
        losses.append(float(m["loss"]))
    out[f"{name}/losses"] = np.array(losses)

# the reference's block order: each device's slice of an (8, 12) array
# under a few specs on ('data', 'model') = (2, 2), tuple entries in both orders
BLOCK_SHAPE = (8, 12)
BLOCK_CASES = [["data", "model"], [["model", "data"], None], [None, ["data", "model"]],
               ["model", None], [None, None]]
mesh = jax.sharding.Mesh(devs.reshape(2, 2), ("data", "model"))
out["block_cases"], out["block_shape"] = np.array(json.dumps(BLOCK_CASES)), np.array(BLOCK_SHAPE)
for i, spec in enumerate(BLOCK_CASES):
    idx = NamedSharding(mesh, P(*(tuple(e) if isinstance(e, list) else e for e in spec))
                        ).devices_indices_map(BLOCK_SHAPE)
    out[f"blocks{i}"] = np.array([[sl.indices(n)[:2] for sl, n in zip(idx[d], BLOCK_SHAPE)]
                                  for d in mesh.devices.reshape(-1)])

mesh = jax.sharding.Mesh(devs.reshape(2, 2), ("pod", "data"))
step = jax.jit(make_train_step(model.loss_fn, cfg, mesh=mesh, rules=rules, lr=LR, warmup=WARMUP,
                               pod_compression=True))
p = placed(mesh)
_, _, res, met = step(p, adamw_init(p), init_residuals(p), pipe.batch(0))
order = {d: i for i, d in enumerate(mesh.devices.reshape(-1))}
for k, v in met.items():
    shards = sorted(v.addressable_shards, key=lambda s: order[s.device])
    out["hier/met_" + k] = np.array([float(s.data) for s in shards])
for kp, v in jax.tree_util.tree_flatten_with_path(res)[0]:
    whole = [np.zeros(v.shape, np.float32) for _ in range(2)]
    for s in v.addressable_shards:
        whole[order[s.device] // 2][s.index] = np.asarray(s.data)
    for pod in range(2):
        out[f"hier/res{pod}" + jax.tree_util.keystr(kp)] = whole[pod]
np.savez(sys.argv[3], **out)
