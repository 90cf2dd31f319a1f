"""Distributed trainer: the ZeRO-sharded AdamW train step, the eval step and
the train state of one rank of a (pod, data, model) grid.

The JAX package's trainer, where one process runs each rank's part (the
JAX package runs one ``shard_map`` program). Its state, in the JAX names,
as one rank holds it:

  params : the model's weights in ``param_dtype`` (a ``ModelParams``), the
           rank's tp shard of every regular leaf, and of every FSDP leaf
           (``ms.fsdp`` segments) its (count, 1, 1, chunk) view of the
           flat (count, data, tp, chunk) layout (``parallel/fsdp.py``)
  master : fp32 master weights: of a regular leaf the rank's ``[dp_index,
           tp_index]`` row of the flat (dp, tp, chunk) ZeRO layout (at dp =
           1 the row is the whole tp-local leaf, kept in its own shape), of
           an FSDP leaf its (count, 1, 1, chunk) view
  m, v   : AdamW moments, like master
  step   : the number of steps taken (an int)
  err    : with ``compress_pod``, the int8 compression's error feedback:
           (pod, chunk) per regular leaf (the rank's view of JAX's (dp, tp,
           pod, chunk)), the leaf's own view per FSDP leaf

At one rank the state is the param-shaped one the checkpoint
(``train/checkpoint.py``) stores; ``checkpoint.state_to_logical`` gathers it
from any grid.

The step: gradients of ``loss_fn`` through its differentiable forward (the
kernels have no backward: ``transformer.loss_fn(differentiable=True)``
runs their torch versions on any device), cast to fp32 (averaged over
``accum`` microbatches), then, leaf by leaf, the collective schedule of the
JAX package's step:

  * a tp-replicated leaf used inside a tp phase (every one but the
    embedding's): one sum over the tp ranks (each holds its part,
    ``parallel/context.py``)
  * a regular leaf: one sum-and-scatter over dp (``psum_scatter_dp``), or
    with ``compress_pod`` a sum-and-scatter over data, then the int8
    compressed sum over pods (``parallel/compress.py``)
  * an FSDP leaf: summed over data by the gather's backward; across pods
    one sum (or the compressed one)
  * the global norm: one sum over tp, one over dp; the clip
  * AdamW on the rank's shard; the fresh forward tensor of a regular leaf
    by one gather over dp (FSDP leaves stay flat)

``make_grad_fn`` is the step up to the clip, ``make_train_step`` the whole
step. One fp32 copy of each gradient is held: at dp = 1 the shard is the
gradient itself, and the clip scales it in place.

The gradients are those of tp = 1 on the global batch: the collectives'
backwards are chosen by site (``parallel/context.py``). The JAX package's
sharded step reads tp times them (ROADMAP §3); Adam and the clip hide it.
The state is updated in place, as the JAX package's step donates its state.

``finetune_lp_only`` (paper Table 2) trains the LP pairs' leaves only:
they get ``requires_grad``, every other leaf stays frozen and takes no
update at all. The JAX package masks the gradients only and still applies
the weight decay to every leaf, so its frozen leaves shrink by (1 - lr·wd)
each step (ROADMAP §3); the port does not copy that.

The grid has no pipeline axis, as the JAX package's has none: its GPipe
stages (``parallel/pp.py``) run a forward over a group of stage ranks of
their own, and no trainer differentiates them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from repro_torch.model import transformer as T
from repro_torch.model.params import (ModelParams, as_tree, tree_items,
                                      tree_leaves, tree_map)
from repro_torch.parallel import fsdp as F
from repro_torch.parallel import zero
from repro_torch.parallel.compress import compress_psum
from repro_torch.parallel.context import ParallelContext
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         clip_by_global_norm_, schedule_lr)


@dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum: int = 1                  # gradient-accumulation microbatches
    remat: bool = False             # activation checkpointing per group
    param_dtype: Any = torch.float32
    compress_pod: bool = False      # int8 + error feedback across pods
    finetune_lp_only: bool = False  # paper Table 2: train LP segments only


@dataclass(frozen=True)
class LeafInfo:
    wd: float                 # weight-decay mask: 1.0 for matrices (ndim >= 2)
    trainable: bool
    tp_sharded: bool = False      # distinct values across the tp ranks?
    fsdp: bool = False
    tp_sum: bool = False          # its gradient is summed over the tp ranks


def leaf_infos(ms: T.ModelStructure, tc: TrainConfig) -> List[LeafInfo]:
    """One ``LeafInfo`` per weight, in ``tree_leaves`` order. An FSDP
    leaf's weight decay and tp flag are those of the tensor it stores."""
    tmpl = T.model_template(ms)
    pair_segs = {i for i, seg in enumerate(ms.segments) if seg.group.pair}
    flags = {}
    if ms.fsdp:
        for i, meta in enumerate(T.segment_metas(ms)):
            for (path, _), wd, tpf in zip(tree_items(meta.tmpl, f"segments/{i}/"),
                                          meta.wd_flags, meta.tp_flags):
                flags[path] = (wd, tpf)

    def info(path: str, pd) -> LeafInfo:
        top, _, rest = path.partition("/")
        trainable = (not tc.finetune_lp_only
                     or (top == "segments" and int(rest.split("/")[0]) in pair_segs))
        wd, tpf = flags.get(path, (1.0 if len(pd.shape) >= 2 else 0.0,
                                   pd.split is not None))
        # The embedding's leaves are used before the first tp phase, where
        # each rank holds the whole gradient; every other replicated leaf
        # is used inside a phase, where it holds its part.
        return LeafInfo(wd, trainable, tpf, path in flags,
                        not tpf and top != "embed")

    return [info(path, pd) for path, pd in tree_items(tmpl)]


def params_from_master(tree, infos: List[LeafInfo], dtype) -> ModelParams:
    """``ModelParams`` holding a copy of ``tree`` (the rank's weights) in
    ``dtype``, with ``requires_grad`` on the trainable leaves only."""
    params = ModelParams(tree_map(lambda x: x.detach().to(dtype, copy=True), tree))
    for p, li in zip(tree_leaves(params.tree()), infos):
        p.requires_grad_(li.trainable)
    return params


def _check_grid(ms: T.ModelStructure, pc: ParallelContext) -> None:
    if ms.tp != pc.tp_size:
        raise ValueError(f"the structure is built for tp={ms.tp}, the context "
                         f"has {pc.tp_size} tp ranks")
    if ms.fsdp and ms.fsdp_data != pc.data_size:
        raise ValueError(f"FSDP shards over {ms.fsdp_data} data ranks, the "
                         f"context has {pc.data_size}")


# ---------------------------------------------------------------------------
# Flat-state packing for REGULAR leaves (GLOBAL tensors)
# ---------------------------------------------------------------------------

def to_flat_global(x: torch.Tensor, split: Optional[int], pc: ParallelContext,
                   parts: int = 1) -> torch.Tensor:
    """GLOBAL param tensor -> GLOBAL flat fp32 state leaf (dp, tp, chunk):
    row [i, r] is chunk i of tp rank r's shard, flattened and zero-padded
    to a multiple of dp."""
    tp, dp = pc.tp_size, pc.dp_size
    rows = F.to_tp_rows(x, split, parts, tp)
    pad = (-rows.shape[1]) % dp
    if pad:
        rows = torch.cat([rows, rows.new_zeros((tp, pad))], dim=1)
    return rows.reshape(tp, dp, -1).transpose(0, 1).float()


def from_flat_global(flat: torch.Tensor, shape, split: Optional[int],
                     pc: ParallelContext, parts: int = 1,
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``to_flat_global`` (the mesh-agnostic checkpoint path)."""
    tp = pc.tp_size
    loc = tuple(n // tp if i == split else n for i, n in enumerate(shape))
    rows = flat.transpose(0, 1).reshape(tp, -1)
    return F.from_tp_rows(rows, tuple(shape), loc, split, parts, tp).to(dtype)


def master_row(x: torch.Tensor, pc: ParallelContext) -> torch.Tensor:
    """A rank's fp32 state of a regular leaf from its tp-local tensor: row
    ``dp_index`` of the (dp, chunk) flat view (at dp = 1 the whole leaf, in
    its own shape). A copy."""
    x = x.detach().float()
    return (x if pc.dp_size == 1 else zero.shard_tree(x, pc)).clone()


def _chunk(numel: int, pc: ParallelContext) -> int:
    return -(-numel // pc.dp_size)


def err_init(params_tree, infos: List[LeafInfo], pc: ParallelContext):
    """Zero error feedback: (pod, chunk) per regular leaf, the leaf's own
    view per FSDP leaf."""
    it = iter(infos)

    def make(x):
        li = next(it)
        shape = x.shape if li.fsdp else (pc.pod_size, _chunk(x.numel(), pc))
        return torch.zeros(shape, dtype=torch.float32, device=x.device)

    return tree_map(make, params_tree)


def state_from_params(params32, ms: T.ModelStructure, pc: ParallelContext,
                      tc: TrainConfig) -> Dict[str, Any]:
    """Fresh optimizer state around EXISTING weights (e.g. an LP-converted
    model about to be recovery-fine-tuned, paper Table 2), on their device:
    ``params32`` holds this rank's weights (its tp shards, its FSDP views).
    The weights are copied, never aliased."""
    _check_grid(ms, pc)
    tree = as_tree(params32)
    infos = leaf_infos(ms, tc)
    it = iter(infos)
    master = tree_map(lambda x: (x.detach().float().clone() if next(it).fsdp
                                 else master_row(x, pc)), tree)
    state = {
        "params": params_from_master(tree, infos, tc.param_dtype),
        "master": master,
        "m": tree_map(torch.zeros_like, master),
        "v": tree_map(torch.zeros_like, master),
        "step": 0,
    }
    if tc.compress_pod:
        state["err"] = err_init(tree, infos, pc)
    return state


def init_state(ms: T.ModelStructure, generator, pc: ParallelContext,
               tc: TrainConfig, *, device="cuda") -> Dict[str, Any]:
    """This rank's train state around random weights from ``generator``
    (which must live on ``device``; the card unless the caller asks for
    "cpu"): every rank draws the same global weights and keeps its part."""
    params32 = T.init_params(ms, generator, torch.float32, device=device,
                             rank=pc.tp_index() if ms.tp > 1 else None,
                             data_index=pc.data_index())
    return state_from_params(params32, ms, pc, tc)


# ---------------------------------------------------------------------------
# Gradient reduction
# ---------------------------------------------------------------------------

def _reduce_grads(g32, err, pc: ParallelContext, tc: TrainConfig):
    """A regular leaf's local fp32 gradient -> this rank's flat shard of
    the dp-mean gradient (chunk,), and the new error feedback. At dp = 1
    the shard is a view of ``g32``."""
    dp = pc.dp_size
    if dp == 1:
        return g32.reshape(-1), err
    if pc.pod_size == 1 or not tc.compress_pod:
        return zero.scatter_grads(g32, pc).div_(dp), err
    flat = zero.flatten_leaf(g32, dp)                  # (dp, chunk)
    chunk = flat.shape[1]
    s1 = pc.psum_scatter_data(flat.reshape(pc.pod_size, pc.data_size, chunk), axis=1)
    s2, new_err = compress_psum(s1.reshape(pc.pod_size, chunk), pc, err)
    return s2[pc.pod_index()] / dp, new_err


def _reduce_grads_fsdp(g32, err, pc: ParallelContext, tc: TrainConfig):
    """An FSDP leaf's gradient, summed over data by the gather's backward:
    finish the mean across pods."""
    if pc.pod_size > 1:
        if tc.compress_pod:
            g32, err = compress_psum(g32, pc, err)
        else:
            g32 = pc.psum_pod(g32)
    return g32.reshape(-1).div_(pc.dp_size), err


# ---------------------------------------------------------------------------
# The steps
# ---------------------------------------------------------------------------

def make_grad_fn(ms: T.ModelStructure, pc: ParallelContext, tc: TrainConfig):
    """grad_fn(state, batch) -> (loss, xent, shards): this rank's loss and
    xent on its rows, and for each trainable leaf, in ``tree_leaves``
    order, this rank's flat fp32 shard of the dp-mean gradient, laid out
    as its ``state["master"]`` leaf viewed flat (the step's reduction,
    before the clip). With ``compress_pod`` it updates ``state["err"]`` in
    place. ``batch`` holds this rank's rows (tensors on the weights'
    device, the batch on axis 0, which ``accum`` must divide)."""
    _check_grid(ms, pc)
    infos = leaf_infos(ms, tc)
    train_idx = [i for i, li in enumerate(infos) if li.trainable]
    if not train_idx:
        raise ValueError("nothing to train: finetune_lp_only trains the LP "
                         "pairs, and the plan has none")

    def grads_of(tree, leaves, micro):
        loss, parts = T.loss_fn(tree, micro, ms=ms, pc=pc, remat=tc.remat,
                                differentiable=True)
        grads, seen = list(torch.autograd.grad(loss, leaves)), set()
        for k, g in enumerate(grads):   # to fp32, one leaf at a time
            g = g.float()
            if g.data_ptr() in seen:    # autograd may hand two leaves one
                g = g.clone()           # tensor; the step scales in place
            seen.add(g.data_ptr())
            grads[k] = g
        return loss.detach(), parts["xent"].detach(), grads

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

    def grad_fn(state, batch):
        tree = as_tree(state["params"])
        flat = tree_leaves(tree)
        loss, xent, grads = compute_grads(tree, [flat[i] for i in train_idx], batch)
        errs = tree_leaves(state["err"]) if "err" in state else None
        with torch.no_grad():
            for k, i in enumerate(train_idx):
                g, grads[k] = grads[k], None        # one copy of each gradient
                if infos[i].tp_sum:
                    g = pc.psum_tp(g)
                e = errs[i] if errs is not None else None
                grads[k], ne = (_reduce_grads_fsdp if infos[i].fsdp
                                else _reduce_grads)(g, e, pc, tc)
                if ne is not None and ne is not e:
                    e.copy_(ne)
        return loss, xent, grads

    return grad_fn


def make_train_step(ms: T.ModelStructure, pc: ParallelContext, tc: TrainConfig):
    """step_fn(state, batch) -> (state, metrics {"loss", "xent",
    "grad_norm", "lr"}), this rank's step; the state is updated in place.
    ``batch`` holds this rank's rows (``make_grad_fn``). Every rank of the
    grid runs it on its own rows, in step."""
    grad_fn = make_grad_fn(ms, pc, tc)
    infos = leaf_infos(ms, tc)
    train_idx = [i for i, li in enumerate(infos) if li.trainable]

    def step_fn(state, batch):
        loss, xent, shards = grad_fn(state, batch)
        flat = tree_leaves(as_tree(state["params"]))
        master = tree_leaves(state["master"])
        m, v = tree_leaves(state["m"]), tree_leaves(state["v"])
        with torch.no_grad():
            # Global norm: the shards partition (data x leaves); FSDP leaves
            # are replicated over pods (divide by pod); tp-sharded leaves
            # sum over the tp ranks, replicated ones count once.
            dev = shards[0].device
            sq_sh = torch.zeros((), dtype=torch.float32, device=dev)
            sq_rp = torch.zeros((), dtype=torch.float32, device=dev)
            for s, i in zip(shards, train_idx):
                contrib = torch.sum(torch.square(s))
                if infos[i].fsdp:
                    contrib = contrib / pc.pod_size
                if infos[i].tp_sharded:
                    sq_sh = sq_sh + contrib
                else:
                    sq_rp = sq_rp + contrib
            gnorm = clip_by_global_norm_(shards, tc.opt.grad_clip,
                                         pc.psum_dp(pc.psum_tp(sq_sh) + sq_rp))

            lr = schedule_lr(tc.opt, state["step"])
            for k, i in enumerate(train_idx):
                p_row, m_row, v_row = (master[i].view(-1), m[i].view(-1),
                                       v[i].view(-1))
                np_, nm, nv = adamw_update(shards[k], m_row, v_row, p_row,
                                           state["step"], tc.opt, lr=lr,
                                           wd_mask=infos[i].wd)
                shards[k] = None
                p_row.copy_(np_)
                m_row.copy_(nm)
                v_row.copy_(nv)
                if infos[i].fsdp or pc.dp_size == 1:
                    flat[i].copy_(np_.view(flat[i].shape))
                else:   # the fresh forward tensor: one gather over dp
                    flat[i].copy_(zero.gather_params(np_, flat[i], pc, flat[i].dtype))
        state["step"] += 1
        return state, {"loss": pc.pmean_dp(loss), "xent": pc.pmean_dp(xent),
                       "grad_norm": gnorm, "lr": lr}

    return step_fn


def batch_shard(batch, pc: ParallelContext):
    """This rank's rows of a GLOBAL batch: block ``dp_index`` of ``dp_size``
    along axis 0 (JAX's ``batch_pspecs``: the batch split over the dp
    axes, replicated over tp)."""
    if pc.dp_size == 1:
        return batch

    def rows(x):
        if x.shape[0] % pc.dp_size:
            raise ValueError(f"a batch of {x.shape[0]} rows does not split over "
                             f"{pc.dp_size} dp ranks")
        n = x.shape[0] // pc.dp_size
        return x[pc.dp_index() * n:(pc.dp_index() + 1) * n]

    return {k: rows(x) for k, x in batch.items()}


def make_sharded_train_step(ms: T.ModelStructure, pc: ParallelContext,
                            tc: TrainConfig):
    """The JAX package's ``make_sharded_train_step`` for one rank: fn(state,
    global_batch) -> (state, metrics), run by every rank of ``pc``'s grid
    on the same global batch (each takes its rows, ``batch_shard``) and its
    own state (``init_state``, ``state_from_params``,
    ``checkpoint.logical_to_state`` or ``bridge.state_from_numpy``). The
    metrics are the same on every rank."""
    step = make_train_step(ms, pc, tc)
    return lambda state, batch: step(state, batch_shard(batch, pc))


def make_eval_step(ms: T.ModelStructure, pc: ParallelContext):
    """eval_fn(params, batch) -> {"loss", "xent"}: ``loss_fn`` under
    ``torch.no_grad`` through the serving forward, so a CUDA tensor runs
    the kernels; at dp > 1 ``batch`` is the rank's rows and the metrics the
    mean over the dp ranks."""
    @torch.no_grad()
    def eval_fn(params, batch):
        loss, parts = T.loss_fn(params, batch, ms=ms, pc=pc)
        return {"loss": pc.pmean_dp(loss), "xent": pc.pmean_dp(parts["xent"])}
    return eval_fn
