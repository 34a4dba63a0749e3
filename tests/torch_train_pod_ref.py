"""The reference's int8 error-feedback all-reduce and hierarchical train
step, run on forced host devices, for ``tests/test_torch_train_step.py``:

    python tests/torch_train_pod_ref.py SRC_DIR OUT.npz

writes (as ``np.savez``) 8 rounds of ``compressed_allreduce`` over a
4-member ``pod`` mesh (``ef{i}_mean``, ``ef{i}_res`` per member, the inputs
``ef_xs``), and one ``make_train_step(..., pod_compression=True)`` step of
reduced qwen2.5-3b on a 2-member pod: the initial and the new parameters
(``p0…``, ``p1…``, keyed as ``jax.tree_util.keystr``), each member's
metrics (``met_*``) and residuals (``res{i}…``).
"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import sys
sys.path.insert(0, sys.argv[1])
import numpy as np, jax, jax.numpy as jnp  # noqa: E401,E402
from jax.sharding import PartitionSpec as P
from repro.compat import make_mesh, shard_map
from repro.configs import get_config, reduce_for_smoke
from repro.data.synthetic import TokenPipeline
from repro.models.registry import get_model
from repro.sharding.rules import PROFILES
from repro.train.grad_compression import compressed_allreduce, init_residuals
from repro.train.optimizer import adamw_init
from repro.train.train_step import make_train_step

out = {}
def put(prefix, tree):
    for kp, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + jax.tree_util.keystr(kp)] = np.asarray(v)

# 8 rounds of error feedback over a 4-member pod (tests/test_substrate.py)
mesh = make_mesh((4,), ("pod",))
xs = np.random.default_rng(0).normal(size=(4, 512)).astype(np.float32)
body = lambda x, r: tuple(o[None] for o in compressed_allreduce(x[0], r[0], "pod"))
fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("pod"), P("pod")),
                       out_specs=(P("pod"), P("pod"))))
r = jnp.zeros((4, 512))
for it in range(8):
    m, r = fn(jnp.asarray(xs), r)
    out[f"ef{it}_mean"], out[f"ef{it}_res"] = np.asarray(m), np.asarray(r)
out["ef_xs"] = xs

# one hierarchical step of reduced qwen2.5 on a 2-member pod
cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
pod = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("pod",))
model = get_model(cfg)
params, _ = model.init(jax.random.key(0))
put("p0", params)
opt = adamw_init(params)
step = jax.jit(make_train_step(model.loss_fn, cfg, mesh=pod, rules=PROFILES["train"], lr=1e-3,
                               warmup=2, pod_compression=True))
batch = TokenPipeline(cfg.vocab, 32, 4, seed=0).batch(0)
p1, o1, r1, met = step(params, opt, init_residuals(params), batch)
put("p1", p1)
for k, v in met.items():
    out["met_" + k] = np.array([float(s.data) for s in v.addressable_shards])
for kp, v in jax.tree_util.tree_flatten_with_path(r1)[0]:
    for i, s in enumerate(sorted(v.addressable_shards, key=lambda s: s.device.id)):
        out[f"res{i}" + jax.tree_util.keystr(kp)] = np.asarray(s.data)
np.savez(sys.argv[2], **out)
