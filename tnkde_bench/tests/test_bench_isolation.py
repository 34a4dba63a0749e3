"""Nothing the harness runs loads the JAX stack or the JAX package (top-level
names compared whole: ``repro_torch`` is not ``repro``); the reference loads
neither package."""
import json
import subprocess
import sys

from bench_small import ROOT, ROOT_PATHS

CONFIG = f"{ROOT}/tnkde_bench/configs/berkeley-rfs.json"

CELLS = ["berkeley-rfs-fresh", "berkeley-rfs-dashboard", "johns_creek-rfs-serve",
         "johns_creek-rfs-quiet", "johns_creek-rfs-over"]

REHEARSE = f"""
import json, sys
sys.path[:0] = {ROOT_PATHS!r}
from bench_small import run_small
from tnkde_bench.harness.cell import forbidden_modules
out = {{}}
for cell in {CELLS!r}:
    res, info = run_small(cell, trace=cell.endswith(("fresh", "over")))
    out[cell] = res["correct"]
out["forbidden"] = forbidden_modules()
out["loaded"] = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(out))
"""

REFERENCE = f"""
import json, sys
sys.path[:0] = {ROOT_PATHS!r}
import numpy as np
from tnkde_bench.harness.dataset import make_dataset
from tnkde_bench.reference.tnkde_ref import exact_heat
cfg = json.load(open({CONFIG!r}))
ds = make_dataset(cfg["table3"], 0.01, 1)
exact_heat(ds, g=50.0, b_s=800.0, b_t=0.2 * ds.t_span, lixels=np.arange(20), ts=[ds.t_min])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _run(code):
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_every_cell_rehearsed_loads_no_jax():
    out = _run(REHEARSE)
    assert all(out[c] for c in CELLS), out
    assert out["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["loaded"])
    assert "repro_torch" in out["loaded"]


def test_reference_loads_neither_package():
    loaded = set(_run(REFERENCE))
    assert not {"jax", "jaxlib", "flax", "repro", "repro_torch"} & loaded
