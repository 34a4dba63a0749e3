"""Serving launcher of the port: ``python -m repro_torch.launch.serve``.

Two workloads, selected with --workload, as in the reference package's
``repro.launch.serve``:

  tnkde  — (default) the paper's: a TN-KDE query server
           (``repro_torch.serve.TNKDEServer``) answering batched *online*
           temporal-window requests against a build-once streaming DRFS
           index: requests pin MVCC snapshots at admission, inserts land
           between pumps, coalesced requests share one window-batched engine
           pass, repeats hit the epoch-keyed result cache. ``--executor``
           picks the device executor (``fused`` by default: the
           hand-written ``fused_leaf`` kernel), ``--device`` where it runs
           (``cuda`` by default; ``cpu`` runs the kernels' plain versions).
  lm     — reduced same-family miniature of ``--arch``: one prefill of
           random prompts, then greedy decode steps (``--attn-impl kernel``
           runs the hand-written ``flash_attention``).

  PYTHONPATH=src python -m repro_torch.launch.serve --workload tnkde --device cpu

Durability (DESIGN.md §8): ``--wal-dir`` logs every insert before it is
applied, ``--ckpt-dir`` writes a coordinated atomic checkpoint when the run
completes, and ``--restore`` recovers a crashed server (checkpoint + WAL
replay) before serving. The WAL and checkpoint formats are the reference
package's. ``--replicas N`` serves through the epoch-consistent
``ReplicaRouter`` (every replica on the same device), ``--hedge-ms`` arms
straggler hedging, ``--resync`` rebuilds quarantined replicas.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.registry import get_model

__all__ = ["serve_tnkde", "serve_lm", "main"]


def serve_tnkde(
    *,
    n_requests: int = 10,
    dataset: str = "berkeley",
    scale: float = 0.02,
    g: float = 50.0,
    b_s: float = 1000.0,
    window_frac: float = 0.25,
    stream_every: int = 4,
    max_windows: int = 3,
    rate_hz=None,
    batch_cap: int = 8,
    mode: str = "continuous",
    n_slots: int = 32,
    replicas: int = 1,
    hedge_ms=None,
    resync: bool = False,
    slo_ms=None,
    warmup: bool = True,
    open_loop: bool = False,
    sequential: bool = False,
    wal_dir=None,
    ckpt_dir=None,
    restore: bool = False,
    deadline_s=None,
    max_queued=None,
    executor: str = "fused",
    device="cuda",
    seed: int = 0,
    log_fn=print,
):
    """Online batched TN-KDE serving with streaming inserts (DRFS).

    Builds the index once over 90% of the events, then drives the serving
    subsystem with a mix of 1..max_windows-center requests and periodic
    inserts of the held-back stream. ``mode='continuous'`` (default) runs
    the slot-scheduled double-buffered engine of DESIGN.md §10;
    ``'microbatch'`` the barrier batcher. ``replicas>1`` serves
    through the self-healing epoch-consistent
    :class:`~repro.serve.ReplicaRouter`; ``hedge_ms`` arms straggler
    hedging and ``resync`` auto-rebuilds quarantined replicas (needs
    ``wal_dir``).
    ``slo_ms`` sets a per-request deadline AND arms hopeless-shed admission
    control against the flush-time EWMA. ``warmup`` loads every kernel with
    one probe of the widest window class per profile before traffic (after
    restore, when restoring), so the measured run loads no library. ``executor`` is the
    profile's device executor ('fused' launches ``fused_leaf``, 'kernel'
    the kernel tier, 'packed' plain PyTorch) and ``device`` where every
    model runs (the card by default; 'cpu' runs the kernels' plain
    versions). ``rate_hz=None`` saturates (closed
    loop); a finite rate replays Poisson arrivals, via the open-loop driver
    when ``open_loop`` is set. Returns the per-request latency list
    (seconds; completion − scheduled arrival under the server).
    """
    from repro_torch.core import TNKDE
    from repro_torch.core.events import Events
    from repro_torch.data import spatial
    from repro_torch.serve import (
        ProfileConfig,
        ReplicaRouter,
        TNKDEServer,
        make_request_mix,
        run_open_loop,
        run_sequential,
        run_server,
    )

    net, ev, meta = spatial.make_dataset(dataset, scale=scale, seed=seed)
    # hold back 10% of events (by time) as the live stream
    order = np.argsort(ev.time, kind="stable")
    cut = int(ev.n * 0.9)
    base = Events(ev.edge_id[order[:cut]], ev.pos[order[:cut]], ev.time[order[:cut]])
    stream = Events(ev.edge_id[order[cut:]], ev.pos[order[cut:]], ev.time[order[cut:]])
    t0, t1 = float(ev.time.min()), float(ev.time.max())
    b_t = window_frac * (t1 - t0)
    prof = ProfileConfig(g=g, b_s=b_s, b_t=b_t, drfs_depth=8, executor=executor)
    workload = make_request_mix(
        stream, t0 + b_t, t1 - b_t,
        n_requests=n_requests, stream_every=stream_every,
        max_windows=max_windows, seed=seed + 7,
    )

    t_build = time.perf_counter()
    if sequential:
        if wal_dir or ckpt_dir or restore:
            raise ValueError(
                "durability flags (--wal-dir/--ckpt-dir/--restore) require "
                "the server path; drop --sequential"
            )
        model = TNKDE(net, base, device=device, **prof.to_kwargs())
        log_fn(
            f"[serve-tnkde] sequential dataset={dataset} x{scale} |V|={meta['V']} "
            f"|E|={meta['E']} N={meta['N']} lixels={model.n_lixels} "
            f"build={time.perf_counter()-t_build:.2f}s"
        )
        rep = run_sequential(model, workload)
    else:
        # --slo-ms is the user-facing SLO: it bounds each request's useful
        # lifetime AND arms hopeless-shed admission (continuous core only)
        ddl = deadline_s
        slo_margin = None
        if slo_ms is not None:
            slo = float(slo_ms) / 1e3
            ddl = slo if ddl is None else min(ddl, slo)
            slo_margin = 1.0
        server_kw = dict(
            mode=mode, batch_cap=batch_cap, n_slots=n_slots,
            default_deadline_s=ddl, max_queued=max_queued,
            slo_margin=slo_margin, device=device,
        )
        if replicas > 1:
            # the router owns durability fleet-wide: ONE WAL for N replicas
            # (mutations logged once), one checkpoint donor, and resync()
            # rebuilding quarantined replicas from ckpt + WAL suffix
            server = ReplicaRouter(
                net, base, {"default": prof}, replicas=replicas,
                hedge_ms=hedge_ms, auto_resync=resync, ckpt_dir=ckpt_dir,
                **server_kw,
            )
        else:
            if hedge_ms is not None or resync:
                raise ValueError(
                    "--hedge-ms/--resync are fleet features; use --replicas>1"
                )
            server = TNKDEServer(net, base, {"default": prof}, **server_kw)
        if wal_dir:
            from repro_torch.core import WriteAheadLog

            wal = WriteAheadLog(wal_dir)
            if restore:
                rr = server.restore(ckpt_dir, wal=wal, attach=True)
                log_fn(
                    f"[serve-tnkde] recovered: ckpt step={rr.restored_step} "
                    f"replayed {rr.n_records} records / {rr.n_events} events "
                    f"(seq {rr.from_seq}->{rr.to_seq}, torn "
                    f"{rr.n_truncated_bytes}B) in "
                    f"{rr.restore_seconds + rr.replay_seconds:.3f}s"
                )
            else:
                server.attach_wal(wal)
        elif restore:
            raise ValueError("--restore needs --wal-dir (the log to replay)")
        if warmup:
            # after restore on purpose: warmup runs against the RECOVERED
            # index state, so the serving run that follows is the one the
            # zero-load guarantee covers
            w = server.warmup()
            log_fn(
                f"[serve-tnkde] warmup: classes={w.get('window_classes')} "
                f"CUDA libraries {w['jit_entries_before']}->"
                f"{w['jit_entries_after']} in {w['seconds']:.2f}s"
            )
        n_lix = (
            server.servers[0] if replicas > 1 else server
        ).models["default"].n_lixels
        log_fn(
            f"[serve-tnkde] dataset={dataset} x{scale} |V|={meta['V']} |E|={meta['E']} "
            f"N={meta['N']} lixels={n_lix} "
            f"build={time.perf_counter()-t_build:.2f}s mode={mode} "
            f"replicas={replicas} slots={n_slots} "
            f"engine={(server.servers[0] if replicas > 1 else server).models['default'].engine_desc} "
            f"device={device} "
            f"rate={'saturated' if rate_hz is None else f'{rate_hz:g}/s'}"
            + (f" slo={slo_ms:g}ms" if slo_ms is not None else "")
            + (f" wal={wal_dir}" if wal_dir else "")
        )
        if open_loop:
            if rate_hz is None:
                raise ValueError("--open-loop needs a finite --rate")
            rep = run_open_loop(server, workload, rate_hz=rate_hz, seed=seed + 11)
        else:
            rep = run_server(server, workload, rate_hz=rate_hz, seed=seed + 11)
        sj = server.stats_json()
        log_fn(
            f"[serve-tnkde] {sj['n_requests']} requests in {sj['n_batches']} "
            f"flushes; windows req={sj['n_windows_requested']} "
            f"eval={sj['n_windows_evaluated']} "
            f"occupancy={sj['batch_occupancy']:.2f} "
            f"cuda_libraries={sj['jit_entries']}"
        )
        if sj["n_shed"] or sj["n_expired"] or sj["n_errors"]:
            log_fn(
                f"[serve-tnkde] degraded service: shed={sj['n_shed']} "
                f"expired={sj['n_expired']} "
                f"hopeless={sj.get('n_hopeless_shed', 0)} "
                f"errors={sj['n_errors']}"
            )
        if replicas > 1:
            log_fn(
                f"[serve-tnkde] fleet: health={sj['health']} "
                f"failovers={sj['n_failovers']} hedges={sj['n_hedges']} "
                f"(wins={sj['n_hedge_wins']}) "
                f"quarantines={sj['n_quarantines']} resyncs={sj['n_resyncs']}"
            )
        if ckpt_dir:
            seq = server.checkpoint(ckpt_dir)
            log_fn(f"[serve-tnkde] checkpointed {ckpt_dir} @ seq {seq}")
    summ = rep.summary()
    if "p50_ms" in summ:
        log_fn(
            f"[serve-tnkde] done: {summ['throughput_rps']:.2f} req/s "
            f"p50={summ['p50_ms']:.1f}ms p95={summ['p95_ms']:.1f}ms "
            f"p99={summ['p99_ms']:.1f}ms"
        )
    else:  # every request shed or errored: nothing was answered ok
        log_fn(f"[serve-tnkde] done: no requests answered ok "
               f"(shed={summ.get('n_shed', 0)} errors={summ.get('n_errors', 0)})")
    return list(rep.latencies)


def serve_lm(*, arch: str = "qwen2.5-3b", prompt_len: int = 32, decode_len: int = 16,
             batch: int = 4, attn_impl: str = "auto", device="cuda", log_fn=print):
    """Prefill ``batch`` prompts of ``prompt_len`` tokens and decode
    ``decode_len`` greedy tokens; returns the decoded tokens, one [batch]
    array per step."""
    cfg = reduce_for_smoke(get_config(arch))
    model = get_model(cfg)
    params = model.init(0, device=device)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)), dtype=torch.long,
                           device=device)
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, {"tokens": toks}, attn_impl=attn_impl)
    # pad the cache for decode_len more tokens
    cache = {k: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, decode_len)) for k, c in cache.items()}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    log_fn(f"[serve-lm] {arch} prefill {prompt_len} toks x{batch}: {time.perf_counter()-t0:.2f}s")
    out = []
    tok = torch.argmax(logits, -1)
    for i in range(decode_len):
        logits, cache = model.decode_step(params, tok, cache, prompt_len + i)
        tok = torch.argmax(logits, -1)
        out.append(tok.cpu().numpy())
    log_fn(f"[serve-lm] decoded {decode_len} steps; sample: {[int(o[0]) for o in out[:8]]}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="serve a workload on the PyTorch port")
    ap.add_argument("--workload", choices=["tnkde", "lm"], default="tnkde")
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    ap.add_argument("--executor", default="fused", choices=["auto", "packed", "fused", "kernel"],
                    help="device executor of the TN-KDE profile (default: fused)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--dataset", default="berkeley")
    ap.add_argument("--scale", type=float, default=0.02)
    ap.add_argument("--rate", type=float, default=None,
                    help="Poisson arrival rate (req/s); default: saturated")
    ap.add_argument("--batch-cap", type=int, default=8,
                    help="max requests coalesced into one micro-batch (--microbatch mode)")
    core = ap.add_mutually_exclusive_group()
    core.add_argument("--continuous", dest="mode", action="store_const",
                      const="continuous", default="continuous",
                      help="slot-scheduled continuous batching with double-buffered "
                           "dispatch (default)")
    core.add_argument("--microbatch", dest="mode", action="store_const", const="microbatch",
                      help="barrier-synchronized micro-batching (A/B baseline)")
    ap.add_argument("--slots", type=int, default=32,
                    help="continuous engine slot count (admission surface)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through N epoch-consistent engine replicas on the same "
                         "device (queries least-loaded, mutations to all, per-replica "
                         "circuit breakers with exact failover)")
    ap.add_argument("--hedge-ms", type=float, default=None,
                    help="hedge requests older than this on a straggling replica with a "
                         "duplicate on a healthy one; first ok wins (needs --replicas>1)")
    ap.add_argument("--resync", action="store_true",
                    help="auto-rebuild quarantined replicas at the pump tail from "
                         "checkpoint + WAL replay (needs --replicas>1 and --wal-dir)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="per-request SLO (ms): deadline + hopeless-shed admission "
                         "control against the flush-time EWMA")
    ap.add_argument("--no-warmup", dest="warmup", action="store_false",
                    help="skip the warmup pass (the first flushes then load the kernels)")
    ap.add_argument("--open-loop", action="store_true",
                    help="open-loop arrivals (needs --rate): admissions on the true "
                         "clock, p99 honest under overload")
    ap.add_argument("--sequential", action="store_true",
                    help="one-request-at-a-time loop on a bare TNKDE (baseline)")
    ap.add_argument("--wal-dir", default=None,
                    help="write-ahead log dir: inserts are durable before they apply")
    ap.add_argument("--ckpt-dir", default=None,
                    help="write a coordinated checkpoint here when the run completes")
    ap.add_argument("--restore", action="store_true",
                    help="recover a crashed server first: restore the latest committed "
                         "checkpoint (if any) and replay the WAL suffix")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request deadline (seconds); expired requests get a typed "
                         "error instead of an engine pass")
    ap.add_argument("--max-queued", type=int, default=None,
                    help="bound the admission queue; beyond it submissions are shed "
                         "with a retryable queue_full error")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--attn-impl", default="auto", choices=["auto", "dense", "blocked", "kernel"])
    args = ap.parse_args(argv)
    if args.workload == "tnkde":
        serve_tnkde(
            n_requests=args.requests, dataset=args.dataset, scale=args.scale,
            rate_hz=args.rate, batch_cap=args.batch_cap,
            mode=args.mode, n_slots=args.slots, replicas=args.replicas,
            hedge_ms=args.hedge_ms, resync=args.resync,
            slo_ms=args.slo_ms, warmup=args.warmup, open_loop=args.open_loop,
            sequential=args.sequential,
            wal_dir=args.wal_dir, ckpt_dir=args.ckpt_dir,
            restore=args.restore, deadline_s=args.deadline,
            max_queued=args.max_queued, executor=args.executor, device=args.device,
        )
    else:
        serve_lm(arch=args.arch, attn_impl=args.attn_impl, device=args.device)


if __name__ == "__main__":
    main()
