"""Train a small LM end-to-end with the PyTorch port on the deterministic
synthetic pipeline, with checkpoints, auto-resume and the watchdog — the
same trainer ``python -m repro_torch.launch.train`` runs. Defaults give a
~5M-param qwen2.5-family model; --full-100m scales to ~100M params. Trains
on the card unless --device cpu is given.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 200
    PYTHONPATH=src python examples/train_lm_torch.py --full-100m --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --steps 20 --device cpu
"""
import argparse
import dataclasses

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.launch.train import run_training

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=200)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=128)
ap.add_argument("--lr", type=float, default=1e-3)
ap.add_argument("--ckpt-dir", default="runs/train_lm_torch")
ap.add_argument("--full-100m", action="store_true")
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

cfg = reduce_for_smoke(get_config("qwen2.5-3b"))
if args.full_100m:
    cfg = dataclasses.replace(
        cfg, d_model=512, n_layers=8, n_heads=8, n_kv=2, head_dim=64,
        d_ff=1536, vocab=32768,
    )
print(f"arch family={cfg.family} params≈{cfg.param_count()/1e6:.1f}M device={args.device}")
_, _, losses = run_training(
    cfg,
    steps=args.steps,
    global_batch=args.batch,
    seq_len=args.seq,
    lr=args.lr,
    warmup=20,
    ckpt_dir=args.ckpt_dir,
    ckpt_every=50,
    device=args.device,
)
print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} steps")
