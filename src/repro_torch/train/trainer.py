"""Single-process trainer: AdamW train step, eval step and state.

The JAX package's trainer at world size 1. Its state, in the JAX names:

  params : the model's weights in ``param_dtype`` (a ``ModelParams``)
  master : fp32 master weights, one tensor per leaf in the PARAM shape
  m, v   : AdamW moments, like master
  step   : the number of steps taken (an int)

The JAX package keeps master, m and v as flat ZeRO shards ``(dp, tp,
chunk)``; at one rank those hold the same numbers in another shape, and the
checkpoint (``train/checkpoint.py``) stores the param-shaped form either
way. The flat layout, FSDP leaves and gradient compression are functions
of ranks and are not ported.

The step: gradients of ``loss_fn`` through its differentiable forward (the
kernels have no backward: ``transformer.loss_fn(differentiable=True)``
runs their torch versions on any device), cast to fp32 (averaged over
``accum`` microbatches), clipped by the global norm, then AdamW on the
master weights, which are cast back into ``params``. The state is updated
in place, as the JAX package's step donates its state.

``finetune_lp_only`` (paper Table 2) trains the LP pairs' leaves only:
they get ``requires_grad``, every other leaf stays frozen and takes no
update at all. The JAX package masks the gradients only and still applies
the weight decay to every leaf, so its frozen leaves shrink by (1 - lr·wd)
each step (ROADMAP §3); the port does not copy that.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import torch

from repro_torch.model import transformer as T
from repro_torch.model.params import (ModelParams, as_tree, tree_items,
                                      tree_leaves, tree_map)
from repro_torch.parallel.context import ParallelContext
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm, schedule_lr)


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum: int = 1                  # gradient-accumulation microbatches
    remat: bool = False             # activation checkpointing per group
    param_dtype: Any = torch.float32
    finetune_lp_only: bool = False  # paper Table 2: train LP segments only


@dataclass(frozen=True)
class LeafInfo:
    wd: float           # weight-decay mask: 1.0 for matrices (ndim >= 2)
    trainable: bool


def leaf_infos(ms: T.ModelStructure, tc: TrainConfig) -> List[LeafInfo]:
    """One ``LeafInfo`` per weight, in ``tree_leaves`` order."""
    tmpl = T.model_template(ms)
    pair_segs = {i for i, seg in enumerate(ms.segments) if seg.group.pair}

    def trainable(path: str) -> bool:
        if not tc.finetune_lp_only:
            return True
        top, _, rest = path.partition("/")
        return top == "segments" and int(rest.split("/")[0]) in pair_segs

    return [LeafInfo(1.0 if len(pd.shape) >= 2 else 0.0, trainable(path))
            for path, pd in tree_items(tmpl)]


def params_from_master(tree, infos: List[LeafInfo], dtype) -> ModelParams:
    """``ModelParams`` holding a copy of ``tree`` in ``dtype``, with
    ``requires_grad`` on the trainable leaves only."""
    params = ModelParams(tree_map(lambda x: x.detach().to(dtype, copy=True), tree))
    for p, li in zip(tree_leaves(params.tree()), infos):
        p.requires_grad_(li.trainable)
    return params


def state_from_params(params32, ms: T.ModelStructure, pc: ParallelContext,
                      tc: TrainConfig) -> Dict[str, Any]:
    """Fresh optimizer state around EXISTING weights (e.g. an LP-converted
    model about to be recovery-fine-tuned, paper Table 2), on their device.
    The weights are copied, never aliased."""
    tree = as_tree(params32)
    master = tree_map(lambda x: x.detach().to(torch.float32, copy=True), tree)
    return {
        "params": params_from_master(master, leaf_infos(ms, tc), tc.param_dtype),
        "master": master,
        "m": tree_map(torch.zeros_like, master),
        "v": tree_map(torch.zeros_like, master),
        "step": 0,
    }


def init_state(ms: T.ModelStructure, generator, pc: ParallelContext,
               tc: TrainConfig, *, device="cuda") -> Dict[str, Any]:
    """Train state around random weights from ``generator`` (which must
    live on ``device``; the card unless the caller asks for "cpu")."""
    params32 = T.init_params(ms, generator, torch.float32, device=device)
    return state_from_params(params32, ms, pc, tc)


def make_train_step(ms: T.ModelStructure, pc: ParallelContext, tc: TrainConfig):
    """step_fn(state, batch) -> (state, metrics {"loss", "xent",
    "grad_norm", "lr"}); the state is updated in place. ``batch`` holds
    tensors on the weights' device with the batch on axis 0, which
    ``accum`` must divide."""
    infos = leaf_infos(ms, tc)
    train_idx = [i for i, li in enumerate(infos) if li.trainable]
    if not train_idx:
        raise ValueError("nothing to train: finetune_lp_only trains the LP "
                         "pairs, and the plan has none")

    def loss_of(tree, micro):
        return T.loss_fn(tree, micro, ms=ms, pc=pc, remat=tc.remat,
                         differentiable=True)

    def grads_of(tree, leaves, micro):
        loss, parts = loss_of(tree, micro)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), parts["xent"].detach(), [g.float() for g in grads]

    def compute_grads(tree, leaves, batch):
        if tc.accum == 1:
            return grads_of(tree, leaves, batch)
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
        xents = []
        for i in range(tc.accum):
            micro = {k: x.reshape(tc.accum, x.shape[0] // tc.accum,
                                  *x.shape[1:])[i] for k, x in batch.items()}
            loss, xent, grads = grads_of(tree, leaves, micro)
            acc = [a + g / tc.accum for a, g in zip(acc, grads)]
            loss_sum = loss_sum + loss / tc.accum
            xents.append(xent)
        return loss_sum, torch.stack(xents).mean(), acc

    def step_fn(state, batch):
        tree = as_tree(state["params"])
        flat = tree_leaves(tree)
        leaves = [flat[i] for i in train_idx]
        loss, xent, grads = compute_grads(tree, leaves, batch)

        grads, gnorm = clip_by_global_norm(grads, tc.opt.grad_clip)
        lr = schedule_lr(tc.opt, state["step"])
        master = tree_leaves(state["master"])
        m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
        with torch.no_grad():
            for i, g in zip(train_idx, grads):
                np_, nm, nv = adamw_update(g, m[i], v[i], master[i],
                                           state["step"], tc.opt, lr=lr,
                                           wd_mask=infos[i].wd)
                master[i].copy_(np_)
                m[i].copy_(nm)
                v[i].copy_(nv)
                flat[i].copy_(np_)            # cast to param_dtype
        state["step"] += 1
        return state, {"loss": loss, "xent": xent, "grad_norm": gnorm, "lr": lr}

    return step_fn


def make_eval_step(ms: T.ModelStructure, pc: ParallelContext):
    """eval_fn(params, batch) -> {"loss", "xent"}: ``loss_fn`` under
    ``torch.no_grad`` through the serving forward, so a CUDA tensor runs
    the kernels."""
    @torch.no_grad()
    def eval_fn(params, batch):
        loss, parts = T.loss_fn(params, batch, ms=ms, pc=pc)
        return {"loss": loss, "xent": parts["xent"]}
    return eval_fn
