"""Figure-22 analog on the PyTorch port (``examples/heatmap_kernels.py``
through ``repro_torch``): the same TN-KDE index rendered with different
kernel functions — Triangular / Cosine / Exponential produce increasingly
smooth heatmaps at identical query cost. Runs on the card unless --device
cpu is given.

    PYTHONPATH=src python examples/heatmap_kernels_torch.py
    PYTHONPATH=src python examples/heatmap_kernels_torch.py --device cpu
"""
import argparse
import time

import numpy as np

from repro_torch.core import TNKDE
from repro_torch.data.spatial import make_dataset

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

net, events, meta = make_dataset("berkeley", scale=0.05, seed=0)
t0, t1 = events.time.min(), events.time.max()
kw = dict(g=50.0, b_s=800.0, b_t=0.25 * (t1 - t0), device=args.device)
t_query = 0.5 * (t0 + t1)

rows = {}
for kernel in ("triangular", "cosine", "exponential"):
    t = time.perf_counter()
    m = TNKDE(net, events, solution="rfs", spatial_kernel=kernel, **kw)
    F = m.query([t_query])[0]
    dt = time.perf_counter() - t
    rows[kernel] = F / max(F.max(), 1e-9)
    print(f"{kernel:12s}: build+query {dt:.2f}s  "
          f"mass={F.sum():10.1f}  p95/p50={np.percentile(F,95)/max(np.percentile(F,50),1e-9):.2f}")

# ascii "heatmap" over the first 72 lixels — same hotspots, different slopes
print("\nlixel-density stripes (darker = denser):")
shades = " .:-=+*#%@"
for k, f in rows.items():
    stripe = "".join(shades[min(int(v * 9.99), 9)] for v in f[:72])
    print(f"{k:12s} |{stripe}|")

tri = rows["triangular"]
for k, f in rows.items():
    if k != "triangular":
        print(f"corr({k}, triangular) = {np.corrcoef(f, tri)[0,1]:.3f}  "
              f"(matches in high-density areas, differs at boundaries — Fig. 22)")
