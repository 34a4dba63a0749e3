"""Quickstart on the PyTorch port: build a TN-KDE index once, answer many
temporal windows (``examples/quickstart.py`` through ``repro_torch``). Runs
on the card unless --device cpu is given; exits non-zero if the index does
not reproduce the direct (SPS) computation.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys

import numpy as np

from repro_torch.core import TNKDE
from repro_torch.data.spatial import make_dataset

EXACT_TOL = 1e-10  # max |RFS - direct| relative to max |direct| (chip_smoke.py's SPS_TOL)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# 1. a calibrated synthetic replica of the paper's Berkeley dataset
net, events, meta = make_dataset("berkeley", scale=0.05, seed=0)
print(f"network: |V|={meta['V']} |E|={meta['E']} events N={meta['N']} "
      f"(Table-3 shape ratio N/|E|={meta['N_over_E']:.0f})")

# 2. build the Range Forest once (exact, any future window)
t0, t1 = events.time.min(), events.time.max()
model = TNKDE(
    net, events,
    g=50.0,                 # lixel length (metres)
    b_s=800.0,              # spatial bandwidth
    b_t=0.2 * (t1 - t0),    # temporal bandwidth
    spatial_kernel="triangular",
    temporal_kernel="triangular",
    solution="rfs",
    lixel_sharing=True,
    device=args.device,
)
print(f"built RFS over {model.n_lixels} lixels in {model.stats.build_seconds:.2f}s "
      f"(index {model.stats.index_bytes/2**20:.1f} MiB, engine={model.engine_desc})")

# 3. three online windows (morning / midday / evening of day 30)
day = 30 * 86400.0
windows = [day + 8 * 3600, day + 13 * 3600, day + 18 * 3600]
F = model.query(windows)
for t, f in zip(windows, F):
    hot = np.argsort(f)[-3:][::-1]
    print(f"window t={t:>12.0f}: density sum={f.sum():9.1f}  "
          f"top lixels={list(hot)} (F={f[hot].round(2)})")

# 4. exactness: the index reproduces the direct (SPS) computation
ref = TNKDE(net, events, g=50.0, b_s=800.0, b_t=0.2 * (t1 - t0), solution="sps",
            device=args.device).query(windows)
err = np.abs(F - ref).max()
print(f"max |RFS - direct| = {err:.2e}  (exact, as the paper claims)")

# 5. non-polynomial kernels, same index machinery (§7)
for k in ("exponential", "cosine", "gaussian"):
    Fk = TNKDE(net, events, g=50.0, b_s=800.0, b_t=0.2 * (t1 - t0),
               solution="rfs", spatial_kernel=k, device=args.device).query(windows[:1])
    c = np.corrcoef(Fk[0], F[0])[0, 1]
    print(f"kernel {k:12s}: corr vs triangular = {c:.3f}")

if not err <= EXACT_TOL * max(np.abs(ref).max(), 1.0):
    sys.exit(f"quickstart: RFS is {err:.3e} from the direct computation")
