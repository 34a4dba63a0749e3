"""Serving launcher of the port: ``python -m repro_torch.launch.serve
--workload lm``.

``serve_lm`` mirrors ``repro.launch.serve.serve_lm``: the reduced
same-family miniature of ``--arch`` (``reduce_for_smoke``), seeded weights,
one prefill of ``batch`` random prompts, then greedy decode steps from the
padded cache. ``attn_impl`` is passed through to the prefill
(``'kernel'`` runs the hand-written ``flash_attention``). It runs on the
card unless ``device='cpu'`` is asked for. The TN-KDE serve tier
(``--workload tnkde``) is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models.registry import get_model

__all__ = ["serve_lm", "main"]


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
    ap.add_argument("--workload", choices=["tnkde", "lm"], default="lm")
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--attn-impl", default="auto", choices=["auto", "dense", "blocked", "kernel"])
    ap.add_argument("--device", default="cuda", help="'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    if args.workload == "tnkde":
        raise NotImplementedError("--workload tnkde: the TN-KDE serve tier is not ported yet "
                                  "(ROADMAP A7)")
    serve_lm(arch=args.arch, attn_impl=args.attn_impl, device=args.device)


if __name__ == "__main__":
    main()
