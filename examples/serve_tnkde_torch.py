"""End-to-end serving walkthrough on the PyTorch port
(``examples/serve_tnkde.py`` through ``repro_torch``): a snapshot-
isolated, micro-batched TN-KDE query server answering online temporal-window
requests while DRFS streaming ingestion proceeds between pumps. Runs on the
card unless --device cpu is given.

What it shows, in order:
  1. micro-batching — heterogeneous requests coalesce into one
     window-batched engine pass per (profile, epoch) group;
  2. snapshot isolation — a request admitted BEFORE an insert is answered
     from its pinned revision even though it is flushed after (the script
     exits non-zero if the later pin does not see the streamed events);
  3. the epoch-keyed result cache — repeats of a hot window are served
     without touching the engines;
  4. the closed-loop load harness — the same mix through the server vs the
     sequential one-request-at-a-time loop.

    PYTHONPATH=src python examples/serve_tnkde_torch.py
    PYTHONPATH=src python examples/serve_tnkde_torch.py --device cpu
"""
import argparse
import sys

import numpy as np

from repro_torch.core import TNKDE
from repro_torch.core.events import Events
from repro_torch.data.spatial import make_dataset
from repro_torch.serve import (
    ProfileConfig,
    TNKDEServer,
    make_request_mix,
    run_sequential,
    run_server,
)

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

# -- a calibrated synthetic replica of the Berkeley dataset; hold back 10%
#    of the events (by time) as the live stream
net, ev, meta = make_dataset("berkeley", scale=0.05, seed=0)
order = np.argsort(ev.time, kind="stable")
cut = int(ev.n * 0.9)
base = Events(ev.edge_id[order[:cut]], ev.pos[order[:cut]], ev.time[order[:cut]])
stream = Events(ev.edge_id[order[cut:]], ev.pos[order[cut:]], ev.time[order[cut:]])
t0, t1 = float(ev.time.min()), float(ev.time.max())
b_t = 0.25 * (t1 - t0)
print(f"network |V|={meta['V']} |E|={meta['E']}; base={base.n} stream={stream.n}")

prof = ProfileConfig(g=50.0, b_s=800.0, b_t=b_t, drfs_depth=7)
server = TNKDEServer(net, base, {"default": prof}, batch_cap=6, window_cap=8,
                     device=args.device)
print("profiles: " + ", ".join(
    f"{name}={m.engine_desc}" for name, m in server.models.items()))

# -- 1+2: pin a request, mutate, pin another, then flush ONE pump ----------
# the streamed tail is the latest 10% of events, so a window ending at t1
# sees the insert — the earlier pin must NOT
hot_t = t1 - b_t
server.submit([hot_t], tag="pinned-before-insert")
server.insert(Events(stream.edge_id[:200], stream.pos[:200], stream.time[:200]))
server.submit([hot_t], tag="pinned-after-insert")
resp = {r.tag: r for r in server.pump()}
a, b = resp["pinned-before-insert"], resp["pinned-after-insert"]
print(f"same window, two pinned revisions: epoch {a.stats.epoch} mass="
      f"{a.heat.sum():.1f}  vs  epoch {b.stats.epoch} mass={b.heat.sum():.1f}")
if not b.heat.sum() > a.heat.sum():
    sys.exit("serve_tnkde: the later pin must see the streamed events")

# -- 3: the hot-window cache ----------------------------------------------
server.submit([hot_t], tag="hot")
hot = {r.tag: r for r in server.pump()}["hot"]
print(f"hot repeat: cache_hits={hot.stats.cache_hits} "
      f"windows_evaluated={hot.stats.windows_evaluated} (served without engines)")

# -- 4: the load harness — the same mix from the same starting state
#    through both loops (fresh instances so neither inherits cache or
#    epoch state from the demo above). Kernels are cold here, so first-use
#    cost lands on whoever flushes first ------------------------------------
state = Events(
    np.concatenate([base.edge_id, stream.edge_id[:200]]),
    np.concatenate([base.pos, stream.pos[:200]]),
    np.concatenate([base.time, stream.time[:200]]),
)
mix = make_request_mix(
    Events(stream.edge_id[200:], stream.pos[200:], stream.time[200:]),
    t0 + b_t, t1 - b_t, n_requests=12, stream_every=6, max_windows=2, seed=7,
)
srv2 = TNKDEServer(net, state, {"default": prof}, batch_cap=6, window_cap=8,
                   device=args.device)
batched = run_server(srv2, mix).summary()
sequential = run_sequential(TNKDE(net, state, **prof.to_kwargs(), device=args.device),
                            mix).summary()
print(f"batched:    {batched['throughput_rps']:6.2f} req/s  "
      f"p50={batched['p50_ms']:.0f}ms p95={batched['p95_ms']:.0f}ms")
print(f"sequential: {sequential['throughput_rps']:6.2f} req/s  "
      f"p50={sequential['p50_ms']:.0f}ms p95={sequential['p95_ms']:.0f}ms")
s = srv2.stats
print(f"load-harness server totals: {s.n_requests} requests in {s.n_batches} "
      f"batches; windows requested={s.n_windows_requested} "
      f"evaluated={s.n_windows_evaluated}; cache hits={srv2.cache.hits}")
