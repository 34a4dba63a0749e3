"""The static-RFS equivalence matrix, ``executor='kernel'`` (moved unchanged
from ``tests/test_torch_tnkde.py``; one file per executor keeps the tier-1
run's files short): ``TNKDE(solution='rfs', engine='torch', device='cpu')``
over six kernel families, one and five windows, with and without lixel
sharing, ≤ 1e-12 relative to max|F| from the reference's NumPy engine and
≤ 1e-9 from the port's index-free SPS evaluation (a different algorithm).
"""
import numpy as np
import pytest

from repro_torch.core import TNKDE
from torch_tnkde_common import KERNEL_FAMILIES, KW, TS5, _reference, _sps
from torch_tnkde_common import ref_world, world  # noqa: F401 (fixtures)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.mark.parametrize("executor", ["kernel"])
@pytest.mark.parametrize("ls", [False, True])
@pytest.mark.parametrize("W", [1, 5])
@pytest.mark.parametrize("ks,kt", KERNEL_FAMILIES)
def test_torch_engine_matches_reference_and_sps(world, ref_world, ks, kt, W, ls, executor):
    net, ev = world
    m = TNKDE(net, ev, solution="rfs", engine="torch", executor=executor, device="cpu",
              lixel_sharing=ls, spatial_kernel=ks, temporal_kernel=kt, **KW)
    assert m.engine_desc == f"torch/{executor}"
    got = m.query(TS5[:W])
    ref = _reference(ref_world, ks, kt, ls)[:W]
    assert got.shape == ref.shape and got.dtype == np.float64
    scale = np.abs(ref).max()
    assert scale > 0
    assert np.abs(got - ref).max() <= 1e-12 * scale, np.abs(got - ref).max() / scale
    sps = _sps(world, ks, kt)[:W]
    assert np.abs(got - sps).max() <= 1e-9 * scale, np.abs(got - sps).max() / scale
