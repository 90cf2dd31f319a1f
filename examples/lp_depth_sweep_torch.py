"""Example on the PyTorch port: the accuracy/latency trade-off of LP at
serving time.

    PYTHONPATH=src python examples/lp_depth_sweep_torch.py            # on the card
    PYTHONPATH=src python examples/lp_depth_sweep_torch.py --device cpu

Trains a small model once, then sweeps the effective depth (the paper's Δ
knob), reporting perplexity and the structural decode-cost proxy (number of
TP sync points per token = 2 x effective depth) — a miniature of the
paper's Fig. 1 trade-off curve.
"""
import argparse
import math

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.lp import extract_layers, lp_convert, plan_for_depth
from repro_torch.data import DataConfig, SynthConfig, eval_ppl_batch, make_source
from repro_torch.model import transformer as T
from repro_torch.parallel.context import ParallelContext
from repro_torch.train import OptConfig, TrainConfig
from repro_torch.train.trainer import (init_state, leaf_infos, make_train_step,
                                       params_from_master)

PC = ParallelContext()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=250)
    args = ap.parse_args(argv)
    dev = args.device

    cfg = reduced_config(get_config("yi-6b"), n_layers=10)
    ms = T.build_structure(cfg, tp=1)
    tc = TrainConfig(opt=OptConfig(lr=2e-3, warmup_steps=min(20, args.steps),
                                   total_steps=args.steps))
    state = init_state(ms, torch.Generator(device=dev).manual_seed(0), PC, tc,
                       device=dev)
    step = make_train_step(ms, PC, tc)
    sc = SynthConfig(vocab_size=cfg.vocab_size)
    src = make_source(DataConfig(seq_len=64, global_batch=8), sc)
    for s in range(args.steps):
        state, m = step(state, {k: x.to(dev) for k, x in src.batch_at(s).items()})
    print(f"trained: final loss {float(m['loss']):.3f}")

    params = params_from_master(state["master"], leaf_infos(ms, tc),
                                torch.float32).tree()
    layers = extract_layers(params["segments"], ms.segments)

    @torch.no_grad()
    def ppl(p, m_):
        b = eval_ppl_batch(torch.Generator().manual_seed(99), sc, 64, 8)
        _, parts = T.loss_fn(p, {k: x.to(dev) for k, x in b.items()}, ms=m_, pc=PC)
        return math.exp(float(parts["xent"]))

    print(f"\n{'depth':>6s} {'Δ':>3s} {'syncs/token':>12s} {'ppl':>8s}")
    rows = []
    for depth in range(cfg.n_layers, cfg.n_layers - 5, -1):
        plan = plan_for_depth(cfg, depth)
        segs, seg_params = lp_convert(cfg, layers, plan)
        p = dict(params, segments=seg_params)
        m_ = T.build_structure(cfg, plan=plan, tp=1)
        rows.append((depth, plan.delta, ppl(p, m_)))
        print(f"{depth:6d} {plan.delta:3d} {2 * depth:12d} {rows[-1][2]:8.3f}")
    return rows


if __name__ == "__main__":
    main()
