"""End-to-end training driver with the fault-tolerance loop.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 20 --eff-depth 3 --n-layers 4 --ckpt-dir build/run1
    PYTHONPATH=src python -m repro_torch.launch.train --no-reduced \
        --eff-depth 16 --finetune-lp-only --param-dtype bfloat16 \
        --schedule linear --lr 1e-4 --weight-decay 0.01 --warmup 10

The first runs a reduced model on the CPU; the second fine-tunes the LP
pairs of tinyllama-1.1b at its published widths on the card (the paper's
Table 2 recipe: AdamW, linear decay from 1e-4). Every ``RunConfig`` field
is a flag; booleans take ``--x`` / ``--no-x``. The loop is restart-safe:
batches are a pure function of the step, checkpoints commit atomically,
and a run with a checkpoint in ``--ckpt-dir`` resumes from its LATEST.
``repro_torch.launch.elastic`` wraps the loop with bounded retries.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.core.lp import EMPTY_PLAN, plan_for_depth
from repro_torch.data import DataConfig, SynthConfig, make_source
from repro_torch.model import transformer as T
from repro_torch.parallel.context import ParallelContext
from repro_torch.train import OptConfig, TrainConfig, checkpoint as CK
from repro_torch.train.trainer import init_state, make_train_step


@dataclasses.dataclass
class RunConfig:
    arch: str = "tinyllama-1.1b"
    reduced: bool = True          # small widths (reduced_config)
    n_layers: int = 0             # 0 -> family default (reduced only)
    eff_depth: int = 0            # 0 -> no LP
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    lr: float = 3e-3
    warmup: int = 20
    schedule: str = "wsd"         # wsd | cosine | linear | const
    weight_decay: float = 0.1
    accum: int = 1
    remat: bool = False
    finetune_lp_only: bool = False
    param_dtype: str = "float32"  # a torch dtype name: float32 | bfloat16
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    seed: int = 0
    log_every: int = 10
    device: str = "cuda"


class Watchdog:
    """Detects a hung step (straggler, dead host) so a supervisor can kill
    the run and restart it from the last checkpoint."""

    def __init__(self, timeout_s: float = 600.0):
        self.timeout_s = timeout_s
        self._last = time.monotonic()

    def tick(self):
        now = time.monotonic()
        dt = now - self._last
        self._last = now
        if dt > self.timeout_s:
            raise TimeoutError(f"step exceeded watchdog budget ({dt:.0f}s)")


def build(rc: RunConfig):
    """(cfg, ms, tc, src) of a run."""
    cfg = get_config(rc.arch)
    if rc.reduced:
        cfg = reduced_config(cfg, n_layers=rc.n_layers or None)
    plan = plan_for_depth(cfg, rc.eff_depth) if rc.eff_depth else EMPTY_PLAN
    ms = T.build_structure(cfg, plan=plan, tp=1)
    tc = TrainConfig(
        opt=OptConfig(lr=rc.lr, warmup_steps=rc.warmup, total_steps=rc.steps,
                      schedule=rc.schedule, weight_decay=rc.weight_decay),
        accum=rc.accum, remat=rc.remat, param_dtype=getattr(torch, rc.param_dtype),
        finetune_lp_only=rc.finetune_lp_only)
    src = make_source(DataConfig(seq_len=rc.seq_len,
                                 global_batch=rc.global_batch, seed=rc.seed),
                      SynthConfig(vocab_size=cfg.vocab_size))
    return cfg, ms, tc, src


def train_loop(rc: RunConfig, *, state=None, hook=None) -> Dict[str, Any]:
    """Run (or resume) the training loop on ``rc.device``. Returns the final
    state, the logged metrics (``history``), ``ms`` and ``cfg``.
    ``hook(step, metrics)`` runs after every step: the failure-injection
    point of the elastic tests."""
    cfg, ms, tc, src = build(rc)
    pc = ParallelContext()
    step_fn = make_train_step(ms, pc, tc)
    ckpt = CK.AsyncCheckpointer(rc.ckpt_dir) if rc.ckpt_dir else None
    start_step = 0
    if state is None:
        if rc.ckpt_dir and CK.latest_step(rc.ckpt_dir) is not None:
            state = CK.logical_to_state(CK.restore(rc.ckpt_dir, CK.logical_like(ms)),
                                        ms, pc, tc, device=rc.device)
            start_step = state["step"]
            print(f"[resume] from step {start_step}", flush=True)
        else:
            gen = torch.Generator(device=rc.device).manual_seed(rc.seed)
            state = init_state(ms, gen, pc, tc, device=rc.device)

    wd = Watchdog()
    history = []
    try:
        for step in range(start_step, rc.steps):
            batch = {k: x.to(rc.device) for k, x in src.batch_at(step).items()}
            state, metrics = step_fn(state, batch)
            wd.tick()
            if hook is not None:
                hook(step, metrics)
            if step % rc.log_every == 0 or step == rc.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                history.append({"step": step, **m})
                print(f"[{step:5d}] loss={m['loss']:.4f} xent={m['xent']:.4f} "
                      f"gnorm={m['grad_norm']:.3f} lr={m['lr']:.2e}", flush=True)
            if ckpt and (step + 1) % rc.ckpt_every == 0:
                ckpt.save(state, step + 1)
        if ckpt:
            ckpt.save(state, rc.steps)
    finally:
        if ckpt:
            ckpt.wait()   # a save in flight commits before the loop returns or raises
    return {"state": state, "history": history, "ms": ms, "cfg": cfg}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    for f in dataclasses.fields(RunConfig):
        name = "--" + f.name.replace("_", "-")
        if isinstance(f.default, bool):
            ap.add_argument(name, action=argparse.BooleanOptionalAction,
                            default=f.default)
        else:
            ap.add_argument(name, type=type(f.default) if f.default is not None
                            else str, default=f.default)
    args = ap.parse_args(argv)
    train_loop(RunConfig(**{f.name: getattr(args, f.name)
                            for f in dataclasses.fields(RunConfig)}))


if __name__ == "__main__":
    main()
