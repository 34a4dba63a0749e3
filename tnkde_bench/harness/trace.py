"""Host spans and the device trace of a ``--trace 1`` run.

Spans are recorded by the benchmark around its calls into the program
(``build``, ``first_query``, ``dispatch``, ``result``, ``admit``, ``pump``)
with the host clock, kept in memory. In a traced run each span is also a
``torch.profiler.record_function`` range, so the device trace and the host
spans share one clock: an idle gap of the device is attributed to the host
span that covers it.
"""
from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

__all__ = ["Spans", "DeviceTrace", "PORT_KERNELS", "is_port_kernel", "is_copy"]

SPAN_PREFIX = "bench."

# The port's hand-written CUDA kernels, by a part of the symbol each
# csrc/*.cu defines (src/repro_torch/kernels/csrc).
PORT_KERNELS = ("fused_walk_kernel", "fused_leaf_kernel", "segment_add_f64_kernel",
                "tree_query_f64_kernel", "dyn_leaf_query_f64_kernel", "minplus_kernel",
                "flash_fwd_kernel", "flash_bf16_kernel")


def is_port_kernel(name: str) -> bool:
    return any(k in name for k in PORT_KERNELS)


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class Spans:
    """Named host intervals. ``span(name)`` times the block it wraps; with
    ``annotate`` it also marks the block for the profiler."""

    def __init__(self):
        self.times = defaultdict(list)
        self.annotate = False

    @contextlib.contextmanager
    def span(self, name: str):
        ctx = contextlib.nullcontext()
        if self.annotate:
            import torch

            ctx = torch.profiler.record_function(SPAN_PREFIX + name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.times[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return float(sum(self.times.get(name, ())))


def _ns(ev, what):
    f = getattr(ev, f"{what}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, f"{what}_us")() * 1000)


class DeviceTrace:
    """What the profiler saw over a traced window: device intervals (kernels
    and copies) and the benchmark's host spans, on one clock."""

    def __init__(self, prof, window_s: float):
        import torch

        self.window_s = float(window_s)
        self.kernels = defaultdict(float)  # name -> device seconds
        dev, host = [], []
        for ev in prof.profiler.kineto_results.events():
            name = ev.name()
            start = _ns(ev, "start")
            dur = _ns(ev, "duration")
            on_device = ev.device_type() == torch.autograd.DeviceType.CUDA
            if on_device and not (name.startswith(SPAN_PREFIX) or ev.is_user_annotation()):
                dev.append((start, start + dur))
                self.kernels[name] += dur * 1e-9
            elif not on_device and name.startswith(SPAN_PREFIX):
                host.append((start, start + dur, name[len(SPAN_PREFIX):]))
        dev.sort()
        merged = []
        for s, e in dev:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        self.idle = self._gaps(merged, host)

    @staticmethod
    def _gaps(merged, host):
        """Seconds of device idle time by the host span that covers the
        middle of each gap between busy intervals."""
        by = defaultdict(float)
        host = sorted(host)
        starts = [h[0] for h in host]
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            mid = (e0 + s1) // 2
            name = "other"
            # the latest-starting span that covers the gap (spans nest shallowly)
            for j in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
                if host[j][1] >= mid:
                    name = host[j][2]
                    break
                if mid - host[j][0] > 10**9:
                    break
            by[name] += (s1 - e0) * 1e-9
        return by

    def kernel_seconds(self, part: str) -> float:
        return float(sum(v for k, v in self.kernels.items() if part in k))

    def breakdown(self) -> dict:
        """The 10 device operations that took most time (names cut to 160
        characters) and the 10 host spans the device idled under most."""
        ops = [(k[:160], v) for k, v in sorted(self.kernels.items(), key=lambda kv: -kv[1])[:10]]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
