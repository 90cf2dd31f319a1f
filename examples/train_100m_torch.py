"""End-to-end driver on the PyTorch port: train a ~100M-parameter model for
a few hundred steps with the single-process substrate — AdamW with fp32
master weights, WSD schedule, grad accumulation, activation checkpointing,
async checkpoints, restart-safe data order.

    PYTHONPATH=src python examples/train_100m_torch.py [--steps 300] [--tiny]
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu --tiny --steps 4

(--tiny shrinks to ~10M for a fast smoke on a CPU; the default ~100M
configuration is sized for a run on the card. Checkpoints go to
build/train_100m unless --ckpt-dir says otherwise.)
"""
import argparse
from pathlib import Path

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.core.lp import plan_range
from repro_torch.data import DataConfig, SynthConfig, make_source
from repro_torch.model import transformer as T
from repro_torch.parallel.context import ParallelContext
from repro_torch.train import OptConfig, TrainConfig, checkpoint as CK
from repro_torch.train.trainer import init_state, make_train_step

PC = ParallelContext()
ROOT = Path(__file__).resolve().parent.parent


def build_cfg(tiny: bool) -> ArchConfig:
    if tiny:
        return ArchConfig(name="lm-10m", family="dense", n_layers=6,
                          d_model=256, n_heads=8, n_kv_heads=4, d_ff=1024,
                          vocab_size=2048,
                          block_pattern=(LayerSpec(),))
    return ArchConfig(name="lm-100m", family="dense", n_layers=12,
                      d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                      vocab_size=32768,
                      block_pattern=(LayerSpec(),))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--lp", action="store_true",
                    help="train WITH layer pairs active (LP-aware training)")
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build" / "train_100m"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    cfg = build_cfg(args.tiny)
    plan = plan_range(cfg, 2, cfg.n_layers - 2) if args.lp else None
    ms = T.build_structure(cfg, plan=plan, tp=1)
    print(f"{cfg.name}: {T.param_count(ms) / 1e6:.1f}M params, "
          f"effective depth {ms.effective_depth}/{cfg.n_layers}, on {dev}")

    tc = TrainConfig(
        opt=OptConfig(lr=6e-4, warmup_steps=args.steps // 10,
                      total_steps=args.steps, schedule="wsd",
                      weight_decay=0.1),
        accum=args.accum, remat=True)
    src = make_source(DataConfig(seq_len=args.seq_len,
                                 global_batch=args.global_batch),
                      SynthConfig(vocab_size=cfg.vocab_size))
    state = init_state(ms, torch.Generator(device=dev).manual_seed(0), PC, tc,
                       device=dev)
    step = make_train_step(ms, PC, tc)
    ckpt = CK.AsyncCheckpointer(args.ckpt_dir)

    tokens_per_step = args.seq_len * args.global_batch
    try:
        for s in range(args.steps):
            state, m = step(state, {k: x.to(dev) for k, x in src.batch_at(s).items()})
            if s % 20 == 0 or s == args.steps - 1:
                print(f"[{s:4d}] loss={float(m['loss']):.4f} "
                      f"lr={float(m['lr']):.2e} "
                      f"tokens={(s + 1) * tokens_per_step:,}", flush=True)
            if (s + 1) % 100 == 0:
                ckpt.save(state, s + 1)
        ckpt.save(state, args.steps)
    finally:
        ckpt.wait()
    print(f"done; checkpoints in {args.ckpt_dir}")
    return state


if __name__ == "__main__":
    main()
