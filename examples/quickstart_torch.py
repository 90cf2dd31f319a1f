"""Quickstart on the PyTorch port: convert a model to Layer Parallelism and
serve it.

    PYTHONPATH=src python examples/quickstart_torch.py            # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Walks the port's public API end to end on a small model:
  1. build a model, 2. train it briefly, 3. apply the retraining-free LP
  merge at a chosen effective depth, 4. check perplexity before/after,
  5. generate text with the LP model.
"""
import argparse
import math

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.lp import extract_layers, lp_convert, plan_for_depth
from repro_torch.data import DataConfig, SynthConfig, eval_ppl_batch, make_source
from repro_torch.model import transformer as T
from repro_torch.parallel.context import ParallelContext
from repro_torch.serve import ServeConfig, generate
from repro_torch.train import OptConfig, TrainConfig
from repro_torch.train.trainer import (init_state, leaf_infos, make_train_step,
                                       params_from_master)

PC = ParallelContext()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    dev = args.device

    # 1. A small llama-family model (reduced tinyllama, 8 layers).
    cfg = reduced_config(get_config("tinyllama-1.1b"), n_layers=8)
    ms = T.build_structure(cfg, tp=1)
    print(f"model: {cfg.name}, {cfg.n_layers} layers, "
          f"{T.param_count(ms) / 1e6:.1f}M params, on {dev}")

    # 2. Train briefly on the synthetic corpus.
    tc = TrainConfig(opt=OptConfig(lr=2e-3, warmup_steps=min(20, args.steps),
                                   total_steps=args.steps))
    state = init_state(ms, torch.Generator(device=dev).manual_seed(0), PC, tc,
                       device=dev)
    step = make_train_step(ms, PC, tc)
    src = make_source(DataConfig(seq_len=64, global_batch=8),
                      SynthConfig(vocab_size=cfg.vocab_size))
    for s in range(args.steps):
        state, m = step(state, {k: x.to(dev) for k, x in src.batch_at(s).items()})
        if s % 50 == 0:
            print(f"  step {s}: loss {float(m['loss']):.3f}")
    # fp32 weights from the master copy
    params = params_from_master(state["master"], leaf_infos(ms, tc),
                                torch.float32).tree()

    # 3. Retraining-free LP conversion: depth 8 -> 6 (two pairs).
    plan = plan_for_depth(cfg, 6)
    print(f"LP plan: pairs={plan.pairs} -> effective depth "
          f"{plan.effective_depth(cfg.n_layers)}")
    layers = extract_layers(params["segments"], ms.segments)
    segs, seg_params = lp_convert(cfg, layers, plan)
    lp_params = dict(params, segments=seg_params)
    ms_lp = T.build_structure(cfg, plan=plan, tp=1)

    # 4. Perplexity before/after (paper Fig. 6 in miniature).
    @torch.no_grad()
    def ppl(p, m):
        b = eval_ppl_batch(torch.Generator().manual_seed(99),
                           SynthConfig(vocab_size=cfg.vocab_size), 64, 8)
        _, parts = T.loss_fn(p, {k: x.to(dev) for k, x in b.items()}, ms=m, pc=PC)
        return math.exp(float(parts["xent"]))

    print(f"ppl vanilla = {ppl(params, ms):.3f}")
    print(f"ppl LP      = {ppl(lp_params, ms_lp):.3f}  "
          "(modest increase, zero retraining)")

    # 5. Generate with the LP model.
    sv = ServeConfig(max_len=128, temperature=0.8, cache_dtype=torch.float32)
    prompts = src.batch_at(0)["tokens"][:2, :16].to(dev)
    out = generate(lp_params, prompts, 16, ms=ms_lp, pc=PC, sv=sv,
                   generator=torch.Generator(device=dev).manual_seed(7))
    print("generated:", out[0].tolist())
    return out


if __name__ == "__main__":
    main()
