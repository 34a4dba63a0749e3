"""Streaming TN-KDE on the PyTorch port: serve heatmaps while events keep
arriving (DRFS, §5; ``examples/streaming_kde.py`` through ``repro_torch``).

New events append to pending buffers (scanned by queries immediately — no
rebuild) and a geometric ``seal`` merges them incrementally when they reach
25% of the sealed set. With ``engine='auto'`` the queries run on the
device-resident engine of the port on the card (``--device cpu``: the same
engine on the CPU, each kernel's plain version). Exits non-zero if the
streamed index does not answer like a fresh build.

    PYTHONPATH=src python examples/streaming_kde_torch.py
    PYTHONPATH=src python examples/streaming_kde_torch.py --device cpu
"""
import argparse
import sys

import numpy as np

from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from repro_torch.data.spatial import make_dataset

FRESH_TOL = 1e-10  # max dev relative to max |fresh| (chip_smoke.py's SPS_TOL: exact DRFS)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# 1. a calibrated synthetic replica of the paper's Berkeley dataset,
#    re-ordered into a time-sorted stream (the streaming contract)
net, events, meta = make_dataset("berkeley", scale=0.03, seed=0)
order = np.argsort(events.time, kind="stable")
stream = Events(events.edge_id[order], events.pos[order], events.time[order])
print(f"network: |V|={meta['V']} |E|={meta['E']}; stream of N={stream.n} events")


def window(lo, hi):
    return Events(stream.edge_id[lo:hi], stream.pos[lo:hi], stream.time[lo:hi])


# 2. bootstrap the index from the first half of the stream
n0 = stream.n // 2
t0, t1 = stream.time.min(), stream.time.max()
model = TNKDE(
    net, window(0, n0),
    g=50.0,
    b_s=600.0,
    b_t=0.2 * (t1 - t0),
    solution="drfs",        # the streaming index
    engine="auto",          # the device-resident engine
    drfs_depth=7,           # tree depth H: accuracy/size dial (§5.2)
    drfs_exact_leaf=True,   # beyond-paper: scan boundary leaves -> exact
    device=args.device,
)
print(f"bootstrapped with {n0} events on engine={model.engine_desc}")

# 3. the serving loop: ingest a batch, query a batch of windows, repeat
ts = list(np.linspace(t0 + 0.25 * (t1 - t0), t1 - 0.05 * (t1 - t0), 5))
cuts = np.linspace(n0, stream.n, 5).astype(int)
for lo, hi in zip(cuts[:-1], cuts[1:]):
    model.insert(window(lo, hi))  # pending buffers; auto-seals at 25%
    F = model.query(ts)  # [W, L] heatmap, every window in one device pass
    print(
        f"ingested {hi - lo:5d} events "
        f"(pending={model.index._n_pending}, structure epoch={model.index.revision}) "
        f"-> peak density {F.max():.3f}, mass {F.sum():.1f}"
    )

# 4. exactness spot-check: the streamed index answers like a fresh build
fresh = TNKDE(
    net, window(0, stream.n),
    g=50.0, b_s=600.0, b_t=0.2 * (t1 - t0),
    solution="drfs", engine="numpy", drfs_depth=7, drfs_exact_leaf=True,
    device=args.device,
)
F_fresh = fresh.query(ts)
dev = np.abs(F - F_fresh).max()
print(f"streamed vs fresh-rebuild max dev: {dev:.2e}")

# 5. the work the streaming machinery did outside the tree walk
print(
    f"stats: atoms={model.stats.n_atoms} "
    f"pending pairs scanned={model.stats.n_pending_scanned} "
    f"partial-leaf pairs scanned={model.stats.n_partial_scanned}"
)

if not dev <= FRESH_TOL * max(np.abs(F_fresh).max(), 1.0):
    sys.exit(f"streaming_kde: the streamed index is {dev:.3e} from a fresh build")
