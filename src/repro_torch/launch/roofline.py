"""Roofline of the dry-run's cells against the H100 (``repro.launch.roofline``).

Terms (per device, seconds):
    compute    = FLOPs / PEAK_FLOPS          (989 TFLOP/s dense bf16)
    memory     = bytes / HBM_BW              (3.35 TB/s HBM3)
    collective = collective bytes / LINK_BW  (50 GB/s per card between nodes)

The peaks are the NVIDIA H100 SXM5 data sheet's: 989 TFLOP/s of dense
bf16 tensor-core math (1 979 with sparsity) and 3.35 TB/s of HBM3. A 16-wide
mesh axis spans two 8-card nodes, so the inter-node rate per card sets the
collectives' pace: the NVIDIA DGX H100 data sheet gives each card one
ConnectX-7 port at 400 Gb/s (InfiniBand NDR), 50 GB/s; NVLink's 900 GB/s
holds only inside a node. The ``mesh`` of a cell is the reference's logical
arrangement (``launch.mesh``), not a measured cluster.

The dry-run's ``cost`` is the whole step (``launch.dryrun``: the outside
plus every layer times its count), so the reference's scan-once correction
(``max(full - layer, 0) + L · layer``, which undoes XLA counting a scanned
layer once) and its encoder-decoder branch (the full cost times L) are not
applied: applied to a whole-step count they would count the layers again.
rwkv's recurrence is in the traced FLOPs (its einsums), so nothing is added
for it either.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for train, 2·N·D for
prefill and decode — the "useful compute" numerator of ``useful_ratio``
(MODEL_FLOPS / the step's counted FLOPs; full-layer remat reads ~6/8 on a
dense train step). ``dominant`` and ``roofline_fraction`` keep the
reference's definitions.

    PYTHONPATH=src python -m repro_torch.launch.roofline --dryrun-dir runs/dryrun --mesh pod1
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, Optional

from repro_torch.configs import SHAPES, get_config

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "roofline_row", "render_table", "render_compact",
           "rows_of", "main"]

PEAK_FLOPS = 989e12  # dense bf16 / card (H100 SXM5 data sheet)
HBM_BW = 3.35e12  # B/s / card (HBM3, H100 SXM5 data sheet)
LINK_BW = 50e9  # B/s / card between nodes (ConnectX-7 400 Gb/s, DGX H100 data sheet)


def roofline_row(rec: Dict, n_chips: int, shape=None) -> Optional[Dict]:
    """One cell's row; ``shape`` (a ``ShapeSpec``) for a record whose shape
    is not one of ``SHAPES``."""
    if not rec.get("ok", False):
        return None
    cfg = get_config(rec["arch"])
    shape = shape or SHAPES[rec["shape"]]
    flops = rec["cost"]["flops"]
    byts = rec["cost"]["bytes"]
    coll = rec["collectives"]["total"]
    t_comp = flops / PEAK_FLOPS
    t_mem = byts / HBM_BW
    t_coll = coll / LINK_BW
    dominant = max(
        (("compute", t_comp), ("memory", t_mem), ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]
    # MODEL_FLOPS (whole step, all chips)
    tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
    per_tok = cfg.flops_per_token_train()
    if shape.kind != "train":
        per_tok /= 3.0  # forward-only: 2N vs 6N
    model_flops = per_tok * tokens
    flops_global = flops * n_chips
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec.get("mesh", {}),
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops": model_flops,
        "hlo_flops_global": flops_global,
        "useful_ratio": model_flops / flops_global if flops_global else 0.0,
        "bytes_per_device_gib": rec["memory"]["bytes_per_device"] / 2**30,
        "roofline_fraction": (model_flops / n_chips / PEAK_FLOPS)
        / max(max(t_comp, t_mem, t_coll), 1e-30),
    }


def render_table(rows, title=""):
    hdr = ("| arch | shape | compute s | memory s | collective s | dominant | "
           "useful FLOPs | roofline frac | GiB/dev |")
    sep = "|" + "---|" * 9
    lines = [f"### {title}", "", hdr, sep] if title else [hdr, sep]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {r['bytes_per_device_gib']:.2f} |"
        )
    return "\n".join(lines)


_SHORT = {"compute": "comp", "memory": "mem", "collective": "coll"}


def render_compact(rows_by_mesh):
    """One row per arch, one column per shape; each cell reads the dominant
    term (``comp``, ``mem``, ``coll``), the bound (the largest of
    the three times) in seconds and the GiB per device, the meshes
    separated by ``/`` in the order given."""
    meshes = list(rows_by_mesh)
    keyed = {m: {(r["arch"], r["shape"]): r for r in rows} for m, rows in rows_by_mesh.items()}
    archs = sorted({a for k in keyed.values() for a, _ in k})
    shapes = [s for s in SHAPES if any(s == sh for k in keyed.values() for _, sh in k)]
    lines = [f"| arch ({' / '.join(meshes)}) | " + " | ".join(shapes) + " |",
             "|" + "---|" * (1 + len(shapes))]
    for arch in archs:
        cells = []
        for shape in shapes:
            rs = [keyed[m].get((arch, shape)) for m in meshes]
            if any(r is None for r in rs):
                cells.append("—")
                continue
            bound = [max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"]) for r in rs]
            cells.append("/".join(_SHORT[r["dominant"]] for r in rs) + " "
                         + " / ".join(f"{b:.3g}" for b in bound) + " s, "
                         + " / ".join(f"{r['bytes_per_device_gib']:.3g}" for r in rs) + " GiB")
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def rows_of(dryrun_dir: str, mesh: str):
    """(rows, n_chips, skipped paths) of one mesh's cell files."""
    n_chips = 256 if mesh == "pod1" else 512
    rows, skipped = [], []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, f"*__{mesh}.json"))):
        if os.path.basename(path).startswith("kde__"):
            continue
        with open(path) as f:
            rec = json.load(f)
        row = roofline_row(rec, n_chips)
        if row:
            rows.append(row)
        else:
            skipped.append(path)
    return rows, n_chips, skipped


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dryrun-dir", default="runs/dryrun")
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "both"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--compact", action="store_true",
                    help="one table, an arch a row and a shape a column, the meshes side by "
                         "side in each cell (dominant term, bound, GiB/dev)")
    args = ap.parse_args(argv)
    out = {}
    for mesh in ("pod1", "pod2") if args.mesh == "both" else (args.mesh,):
        rows, n_chips, skipped = rows_of(args.dryrun_dir, mesh)
        for path in skipped:
            print(f"skip (failed): {path}")
        if not args.compact:
            print(render_table(rows, title=f"Roofline ({mesh}, {n_chips} H100s)"))
        out[mesh] = rows
    if args.compact:
        print(render_compact(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out if args.mesh == "both" else out[args.mesh], f, indent=1)
    return 0


if __name__ == "__main__":
    main()
