"""Worlds, constants and reference helpers shared by the static-RFS test
files of the port (``tests/test_torch_tnkde*.py``): the port's and the
reference's copies of one seeded world, the reference's NumPy answers and
the port's SPS oracle cached per configuration, and the x64 shim fixture."""
import pathlib

import jax
import pytest

import repro.data.spatial as ref_spatial
import repro_torch.data.spatial as port_spatial
from repro.core import TNKDE as RefTNKDE
from repro_torch.core import TNKDE

KW = dict(g=35.0, b_s=700.0, b_t=2.5 * 86400.0)
TS5 = [2 * 86400.0, 4 * 86400.0, 5.5 * 86400.0, 7 * 86400.0, 9 * 86400.0]
KERNEL_FAMILIES = [
    ("triangular", "quartic"),
    ("epanechnikov", "cosine"),
    ("quartic", "exponential"),
    ("cosine", "triangular"),
    ("exponential", "epanechnikov"),
    ("gaussian", "triangular"),
]
REPO = pathlib.Path(__file__).resolve().parents[1]


def _world(mod):
    net = mod.make_network(60, 100, seed=13)
    return net, mod.make_events(net, 800, seed=14, span_days=12)


@pytest.fixture(scope="module")
def world():
    return _world(port_spatial)


@pytest.fixture(scope="module")
def ref_world():
    return _world(ref_spatial)


_REF, _SPS = {}, {}


def _reference(ref_world, ks, kt, ls):
    """Reference package, NumPy engine, all five windows."""
    key = (ks, kt, ls)
    if key not in _REF:
        net, ev = ref_world
        _REF[key] = RefTNKDE(net, ev, solution="rfs", engine="numpy", lixel_sharing=ls,
                             spatial_kernel=ks, temporal_kernel=kt, **KW).query(TS5)
    return _REF[key]


def _sps(world, ks, kt):
    """The port's own index-free oracle."""
    key = (ks, kt)
    if key not in _SPS:
        net, ev = world
        _SPS[key] = TNKDE(net, ev, solution="sps", spatial_kernel=ks,
                          temporal_kernel=kt, **KW).query(TS5)
    return _SPS[key]


@pytest.fixture
def x64_shim(monkeypatch):
    """The reference's device engines call ``jax.experimental.enable_x64``,
    which newer jax releases dropped. Restore it for ONE test (monkeypatch
    undoes it afterwards, so the reference's own tests see jax as it is)."""
    monkeypatch.setattr(jax.experimental, "enable_x64",
                        lambda *a, **k: jax.enable_x64(True), raising=False)
