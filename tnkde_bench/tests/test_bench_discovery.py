"""A configuration, a cell, a traffic driver and a per-layer metric dropped
into a copy of the benchmark's folder, with the metric's entry added to the
copy's BENCHMARK.json, are found by name, with no edit to any harness file."""
import json
import shutil

from bench_small import SCALE, SEED, small_checks
from tnkde_bench.harness import cell as C

METRIC = '''
def read(run):
    return float(run.n_queries) + 0.5
'''


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "bench"
    shutil.copytree(C.BENCH, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    cfg = json.loads((root / "configs" / "berkeley-rfs.json").read_text())
    cfg.update(name="tiny-rfs", scale=SCALE)
    (root / "configs" / "tiny-rfs.json").write_text(json.dumps(cfg))
    wl = json.loads((root / "workloads" / "berkeley-rfs-fresh.json").read_text())
    wl.update(config="tiny-rfs", driver="closed_loop_copy",
              params={**wl["params"], "windows": 3})
    (root / "workloads" / "tiny-rfs-fresh.json").write_text(json.dumps(wl))
    driver = (root / "traffic" / "closed_loop.py").read_text()
    (root / "traffic" / "closed_loop_copy.py").write_text(driver)
    (root / "metrics" / "tiny.queries_plus_half.py").write_text(METRIC)
    spec = json.loads((C.BENCH.parent / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "tiny.queries_plus_half", "unit": "queries",
                              "better": "higher", "source": "program_counter",
                              "layer": "front end", "moves": "windows_per_s",
                              "workloads": ["tiny-rfs-fresh"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    with small_checks():
        res, info = C.run_cell("tiny-rfs-fresh", SEED, 1.0, True, device="cpu", root=root)
    assert res["correct"], res
    q = res["metrics"]["tiny.queries_plus_half"]
    assert q["unit"] == "queries" and q["value"] == res["attempted"] + 0.5
    assert set(res["metrics"]) == {"tiny.queries_plus_half"}  # the cell's entries only
