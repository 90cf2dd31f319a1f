"""Explicit-collective parallel context, backed by ``torch.distributed``.

All model code takes a ``ParallelContext`` and calls its collective helpers,
with the method names of the JAX package's context. Where the JAX package
runs one program inside ``shard_map``, the port runs one process per rank:
every rank executes the same code on its own shard (SPMD), and the
context's collectives are calls over the ranks' process groups.

The ranks form a grid (pod, data, model), as JAX's mesh ``("pod", "data",
"model")``: ``model`` is Megatron tensor parallelism (the tp group), ``pod``
x ``data`` pure data parallelism (the dp group; gradients are averaged over
it, ``data`` inside a pod, ``pod`` across pods). A rank's number in the
world is ``(pod * data_size + data) * model_size + model``, the order in
which ``jax.make_mesh`` lays host devices out, so ``dp_index`` picks the
batch rows JAX's ``batch_pspecs`` gives the same rank.

At size 1 every helper of an axis is the identity and that axis has no
group. Above 1 the context carries the groups; a context without one
raises at its first collective instead of running as one rank. Build it
with ``make_context`` (serving: the world is the tp group), ``init_context``
(which also initialises the world with the backend the caller names:
``"nccl"`` for one card per rank, or ``"gloo"``, CUDA or CPU tensors, ranks
may share a card; nothing picks a backend for the caller), or
``make_grid_context`` (a world of pod x data x model ranks).

Every collective is an ``all_reduce``, on gloo and NCCL alike: a gather
writes the rank's block into a zero buffer and sums (gloo's ``all_gather``
takes CPU tensors only), a sum-and-scatter sums and keeps the rank's block
(gloo has no reduce-scatter). ``ALL_REDUCES`` counts the sums and maxima,
by operation, ``ALL_GATHERS`` the gathers and ``SCATTERS`` the
sum-and-scatters, as ``kernels.ops.LAUNCHES`` counts kernel launches: each
moves only where a collective is issued (never at size 1), forward and
backward alike, so a caller can hold a step's count to LP's halving or to
what its leaf list predicts. ``COLLECTIVES`` records each of them in
order: what it computes, what it issues (one all_reduce), the buffer's
bytes, the group's size and axis (``analysis.roofline.collective_bytes``
prices them). ``reset_all_reduces`` empties all four.

``make_dry_context`` gives one rank's context on a grid whose groups
record their collectives and communicate nothing (the dry run,
``launch/dryrun.py``): it runs a rank's step on "meta" tensors, with no
process group and no device; a dry group given a tensor off meta raises.

Under autograd (the sharded trainer) each collective a forward runs has the
backward of Megatron's convention: the gradient of a tensor every rank
holds alike (the residual stream) is whole on every rank, and inside a tp
phase (between ``phase_in`` and ``phase_out``) it is the rank's part.

  ``psum_tp``        a sum whose result every rank then uses alike (a
                     phase exit, the embedding, the cross-entropy's sums):
                     the backward is the identity.
  ``psum_tp_local``  a sum whose result each rank then uses for its own
                     channels (Mamba's ``x_proj``): the backward sums too.
  ``phase_in``       without sp the identity, whose backward sums the
                     ranks' parts (Megatron's f); with sp an all-gather
                     along the sequence, whose backward sums and scatters.
  ``phase_out``      without sp ``psum_tp``; with sp a sum-and-scatter
                     along the sequence, whose backward gathers.
  ``shard_seq``      the rank's block of the sequence; the backward gathers.
  ``split_grad_tp``  the identity, whose backward divides by tp: a value
                     every rank computes alike inside a phase that leaves
                     it without a sum (the MoE aux loss).

A weight every tp rank holds alike and uses inside a phase (a norm scale, a
router, replicated kv projections) so gets the rank's part of its gradient,
which the trainer sums over the tp group; the embedding's, used before the
first phase, is whole already. ``pmax_tp`` and the dp helpers have no
backward: on a tensor that autograd tracks they raise.

The pipeline axis is no field of the context, as in the JAX package: GPipe
stages (``parallel/pp.py``) take a group of stage ranks of their own.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")

#: all_reduce calls (sums, maxima) issued by the contexts of this process.
ALL_REDUCES = {"sum": 0, "max": 0}
#: gathers issued by the contexts of this process (one all_reduce each).
ALL_GATHERS = {"gather": 0}
#: sum-and-scatters issued by the contexts of this process (one all_reduce each).
SCATTERS = {"scatter": 0}
#: the newest collectives of the contexts of this process, real and dry, in
#: order: {"computed": "sum" | "max" | "gather" | "scatter", "issues":
#: "all_reduce", "bytes": the buffer's, "group": the group's size, "axis":
#: "tp" | "dp" | "data" | "pod"}. Bounded, so that a server that never
#: resets it does not grow: ``recorded`` refuses a log that dropped any.
COLLECTIVES: Deque[Dict[str, Any]] = deque(maxlen=1 << 16)


def reset_all_reduces() -> None:
    """Zero ``ALL_REDUCES``, ``ALL_GATHERS`` and ``SCATTERS``; empty
    ``COLLECTIVES``."""
    for counts in (ALL_REDUCES, ALL_GATHERS, SCATTERS):
        for op in counts:
            counts[op] = 0
    COLLECTIVES.clear()


def recorded() -> List[Dict[str, Any]]:
    """The collectives since the last ``reset_all_reduces``, as a list;
    raises when there were more than ``COLLECTIVES`` keeps."""
    n = sum(ALL_REDUCES.values()) + ALL_GATHERS["gather"] + SCATTERS["scatter"]
    if n != len(COLLECTIVES):
        raise RuntimeError(f"{n} collectives since the last reset, "
                           f"{len(COLLECTIVES)} recorded: reset more often")
    return list(COLLECTIVES)


class DryGroup:
    """The process group of one axis of a dry context: a collective over it
    is recorded and communicates nothing, on "meta" tensors only."""

    def __init__(self, axis: str, size: int):
        self.axis, self.size = axis, size

    def __repr__(self) -> str:
        return f"DryGroup({self.axis!r}, {self.size})"


# ---------------------------------------------------------------------------
# Raw collectives over one group (no autograd)
# ---------------------------------------------------------------------------

def _need(group, size: int, what: str):
    if group is None:
        raise RuntimeError(
            f"a {what} axis of size {size} has no process group: build the "
            "context with make_context() or make_grid_context() from an "
            "initialised torch.distributed group")


def _all_reduce(buf, group, size, what, computed, op="sum"):
    """The one call every collective issues: all_reduce ``buf`` in place
    over ``group`` (SUM, or MAX for ``op="max"``), recorded in
    ``COLLECTIVES``. Over a dry group it records and leaves ``buf``."""
    dry = isinstance(group, DryGroup)
    if dry and buf.device.type != "meta":
        raise RuntimeError(
            f"a dry {what} group takes meta tensors, not {buf.device}: it "
            "records collectives and cannot stand in for ranks on data")
    COLLECTIVES.append({"computed": computed, "issues": "all_reduce",
                        "bytes": buf.numel() * buf.element_size(),
                        "group": size, "axis": what})
    if not dry:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)


def _sum(x, group, size, what="tp", op="sum"):
    _need(group, size, what)
    y = x.contiguous().clone()   # in place on a copy: x stays as it was
    _all_reduce(y, group, size, what, op, op)
    ALL_REDUCES[op] += 1
    return y


def _gather(x, group, size, index, axis, tiled=True, what="tp"):
    """The ranks' ``x`` in group order: concatenated along ``axis``
    (``tiled``) or stacked on a new axis ``axis``. Each rank writes its
    ``x`` into its block of a zero buffer and one all_reduce(SUM) adds the
    blocks, which is exact (x + 0 == x)."""
    _need(group, size, what)
    buf = x.new_zeros((size, *x.shape))
    buf[index] = x
    _all_reduce(buf, group, size, what, "gather")
    ALL_GATHERS["gather"] += 1
    if not tiled:
        return buf.movedim(0, axis)
    return torch.cat(buf.unbind(0), dim=axis)


def _scatter(x, group, size, index, axis, what="tp"):
    """The sum over the group of ``x``, cut into ``size`` blocks along
    ``axis``: this rank's block. One all_reduce, then the block."""
    _need(group, size, what)
    n = x.shape[axis]
    if n % size:
        raise ValueError(f"axis {axis} of {tuple(x.shape)} does not divide "
                         f"into {size} blocks")
    y = x.contiguous().clone()
    _all_reduce(y, group, size, what, "scatter")
    SCATTERS["scatter"] += 1
    w = n // size
    return y.narrow(axis, index * w, w).clone(memory_format=torch.contiguous_format)


def _block(x, size, index, axis):
    w = x.shape[axis] // size
    return x.narrow(axis, index * w, w)


# ---------------------------------------------------------------------------
# Collectives with a backward (autograd Functions)
# ---------------------------------------------------------------------------

class _SumIdentity(torch.autograd.Function):
    """Forward: the sum over the group. Backward: the identity."""

    @staticmethod
    def forward(ctx, x, group, size):
        return _sum(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumSum(torch.autograd.Function):
    """Forward and backward: the sum over the group."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _sum(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, ctx.size), None, None


class _IdentitySum(torch.autograd.Function):
    """Forward: the identity. Backward: the sum over the group."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, ctx.size), None, None


class _GatherScatter(torch.autograd.Function):
    """Forward: the group's blocks gathered along ``axis``. Backward: the
    sum over the group, this rank's block."""

    @staticmethod
    def forward(ctx, x, group, size, index, axis, what):
        ctx.args = (group, size, index, axis, what)
        return _gather(x, group, size, index, axis, what=what)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None, None, None


class _ScatterGather(torch.autograd.Function):
    """Forward: the sum over the group, this rank's block along ``axis``.
    Backward: the blocks gathered."""

    @staticmethod
    def forward(ctx, x, group, size, index, axis):
        ctx.args = (group, size, index, axis)
        return _scatter(x, group, size, index, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None, None


class _SliceGather(torch.autograd.Function):
    """Forward: this rank's block along ``axis`` of a tensor every rank
    holds alike. Backward: the blocks' gradients gathered."""

    @staticmethod
    def forward(ctx, x, group, size, index, axis):
        ctx.args = (group, size, index, axis)
        return _block(x, size, index, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None, None


class _ScaleGrad(torch.autograd.Function):
    """Forward: the identity. Backward: the gradient times ``factor``."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


def _tracked(x) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def _refuse_tracked(x, what: str) -> None:
    if _tracked(x):
        raise NotImplementedError(
            f"{what} has no backward: call it on a tensor autograd does not "
            "track (detach it, or run under torch.no_grad())")


# ---------------------------------------------------------------------------
# The context
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ParallelContext:
    tp_size: int = 1
    rank: int = 0               # this process's rank in the tp group (tp index)
    group: Any = None           # torch.distributed process group of the tp ranks
    sp: bool = False            # sequence-parallel residual stream
    seq_axis: int = 1           # which tensor dim is "sequence" in activations
    dp_size: int = 1            # pod x data
    pod_size: int = 1           # leading "pod" factor of the dp axes
    dp_rank: int = 0            # this process's index on the dp axes
    dp_group: Any = None        # the pod x data ranks of this tp index
    data_group: Any = None      # the data ranks of this pod and tp index
    pod_group: Any = None       # the pod ranks of this data and tp index

    def __post_init__(self):
        if self.tp_size < 1 or not 0 <= self.rank < self.tp_size:
            raise ValueError(f"rank {self.rank} of tp_size {self.tp_size}")
        if (self.pod_size < 1 or self.dp_size % self.pod_size
                or not 0 <= self.dp_rank < self.dp_size):
            raise ValueError(f"dp rank {self.dp_rank} of dp_size {self.dp_size} "
                             f"over {self.pod_size} pods")

    @property
    def tp(self) -> int:
        return self.tp_size

    @property
    def data_size(self) -> int:
        return self.dp_size // self.pod_size

    def with_sp(self, sp: bool) -> "ParallelContext":
        return replace(self, sp=sp)

    def tp_index(self) -> int:
        return self.rank

    def dp_index(self) -> int:
        return self.dp_rank

    def data_index(self) -> int:
        return self.dp_rank % self.data_size

    def pod_index(self) -> int:
        return self.dp_rank // self.data_size

    # -- collectives over the TP axis (identity at size 1) --------------
    def psum_tp(self, x):
        """Sum over the tp ranks, for a result every rank then uses alike:
        the backward is the identity."""
        if self.tp_size == 1:
            return x
        if _tracked(x):
            return _SumIdentity.apply(x, self.group, self.tp_size)
        return _sum(x, self.group, self.tp_size)

    def psum_tp_local(self, x):
        """Sum over the tp ranks, for a result each rank then uses for its
        own channels: the backward sums the ranks' gradients too."""
        if self.tp_size == 1:
            return x
        if _tracked(x):
            return _SumSum.apply(x, self.group, self.tp_size)
        return _sum(x, self.group, self.tp_size)

    def pmax_tp(self, x):
        if self.tp_size == 1:
            return x
        _refuse_tracked(x, "pmax_tp")
        return _sum(x, self.group, self.tp_size, op="max")

    def all_gather_tp(self, x, axis: int, *, tiled: bool = True):
        """The ranks' ``x`` in rank order: concatenated along ``axis``
        (``tiled``), or stacked on a new axis ``axis``, as JAX's
        ``lax.all_gather``. Tiled, under autograd, its backward sums the
        gathered gradient over the ranks and keeps the rank's block (the
        gathered tensor feeds each rank's own part of a phase)."""
        if self.tp_size == 1:
            return x if tiled else x.unsqueeze(axis)
        if _tracked(x):
            if not tiled:
                raise NotImplementedError("an untiled all_gather_tp has no backward")
            return _GatherScatter.apply(x, self.group, self.tp_size, self.rank,
                                        axis, "tp")
        return _gather(x, self.group, self.tp_size, self.rank, axis, tiled)

    def psum_scatter_tp(self, x, axis: int):
        """Sum over the tp ranks, cut along ``axis``: the rank's block. The
        backward gathers the blocks' gradients."""
        if self.tp_size == 1:
            return x
        if _tracked(x):
            return _ScatterGather.apply(x, self.group, self.tp_size, self.rank, axis)
        return _scatter(x, self.group, self.tp_size, self.rank, axis)

    def split_grad_tp(self, x):
        """The identity, whose backward divides the gradient by tp: for a
        value every rank computes alike inside a phase and that leaves it
        without a sum, so that its gradient, whole on every rank, becomes
        the rank's part, as every other gradient inside the phase is."""
        if self.tp_size == 1 or not _tracked(x):
            return x
        return _ScaleGrad.apply(x, 1.0 / self.tp_size)

    # -- phase boundaries (the paper's sync points) ---------------------
    # A phase is one column-parallel -> local -> row-parallel region; an LP
    # pair runs two layers' phase in one, so it syncs once where two layers
    # sync twice. Without sequence parallelism the entry is the identity
    # (no collective forward) and the exit one all-reduce.
    def phase_in(self, x, axis: Optional[int] = None):
        """Enter a TP phase: make the activation full-sequence."""
        if self.tp_size == 1:
            return x
        if self.sp:
            return self.all_gather_tp(x, self.seq_axis if axis is None else axis)
        if _tracked(x):
            return _IdentitySum.apply(x, self.group, self.tp_size)
        return x

    def phase_out(self, x, axis: Optional[int] = None):
        """Exit a TP phase: combine row-parallel partial sums."""
        if self.sp:
            return self.psum_scatter_tp(x, self.seq_axis if axis is None else axis)
        return self.psum_tp(x)

    def shard_seq(self, x):
        """Slice a replicated activation down to this rank's seq shard
        (used when entering an SP region, right after the embedding sum);
        the identity without sequence parallelism."""
        if not self.sp or self.tp_size == 1:
            return x
        seq = x.shape[self.seq_axis]
        if seq % self.tp_size:
            raise ValueError(f"sequence {seq} does not divide over tp={self.tp_size}")
        if _tracked(x):
            return _SliceGather.apply(x, self.group, self.tp_size, self.rank,
                                      self.seq_axis)
        return _block(x, self.tp_size, self.rank, self.seq_axis)

    # -- data-parallel helpers (no backward) -----------------------------
    def psum_dp(self, x):
        if self.dp_size == 1:
            return x
        _refuse_tracked(x, "psum_dp")
        return _sum(x, self.dp_group, self.dp_size, "dp")

    def pmean_dp(self, x):
        if self.dp_size == 1:
            return x
        return self.psum_dp(x) / self.dp_size

    def psum_scatter_dp(self, x, axis: int = 0):
        if self.dp_size == 1:
            return x
        _refuse_tracked(x, "psum_scatter_dp")
        return _scatter(x, self.dp_group, self.dp_size, self.dp_rank, axis, "dp")

    def all_gather_dp(self, x, axis: int = 0, *, tiled: bool = True):
        if self.dp_size == 1:
            return x if tiled else x.unsqueeze(axis)
        _refuse_tracked(x, "all_gather_dp")
        return _gather(x, self.dp_group, self.dp_size, self.dp_rank, axis, tiled, "dp")

    def psum_scatter_data(self, x, axis: int = 0):
        """Sum over the data ranks of this pod, cut along ``axis``."""
        if self.data_size == 1:
            return x
        _refuse_tracked(x, "psum_scatter_data")
        return _scatter(x, self.data_group, self.data_size, self.data_index(),
                        axis, "data")

    def all_gather_data(self, x, axis: int = 0):
        """The data ranks' blocks of this pod, concatenated along ``axis``.
        Under autograd its backward sums the gradient over the data ranks
        and keeps the rank's block: FSDP's gather, whose backward is the
        ZeRO-3 reduce-scatter of the gradients."""
        if self.data_size == 1:
            return x
        if _tracked(x):
            return _GatherScatter.apply(x, self.data_group, self.data_size,
                                        self.data_index(), axis, "data")
        return _gather(x, self.data_group, self.data_size, self.data_index(),
                       axis, what="data")

    def psum_pod(self, x):
        if self.pod_size == 1:
            return x
        _refuse_tracked(x, "psum_pod")
        return _sum(x, self.pod_group, self.pod_size, "pod")

    def pmax_pod(self, x):
        if self.pod_size == 1:
            return x
        _refuse_tracked(x, "pmax_pod")
        return _sum(x, self.pod_group, self.pod_size, "pod", op="max")


def make_context(group=None, *, sp: bool = False) -> ParallelContext:
    """The context of this process in an initialised process group
    (``group`` None: the default group) taken as the tp group, with no
    data parallelism (serving). One rank gives the identity context with
    no group."""
    if not dist.is_initialized():
        raise RuntimeError("make_context needs an initialised torch.distributed "
                           "process group (init_context, or "
                           "torch.distributed.init_process_group)")
    size = dist.get_world_size(group)
    if size == 1:
        return ParallelContext(sp=sp)
    return ParallelContext(tp_size=size, rank=dist.get_rank(group),
                           group=group if group is not None else dist.group.WORLD,
                           sp=sp)


def grid_ranks(pod: int, data: int, model: int):
    """{axis: [the world ranks of each group of that axis]} of a (pod,
    data, model) grid numbered ``(p * data + d) * model + m``: "model" the
    tp groups, "data" the data groups, "pod" the pod groups, "dp" the
    pod x data groups, each in the order every rank creates them."""
    def r(p, d, m):
        return (p * data + d) * model + m
    return {
        "model": [[r(p, d, m) for m in range(model)]
                  for p in range(pod) for d in range(data)],
        "data": [[r(p, d, m) for d in range(data)]
                 for p in range(pod) for m in range(model)],
        "pod": [[r(p, d, m) for p in range(pod)]
                for d in range(data) for m in range(model)],
        "dp": [[r(p, d, m) for p in range(pod) for d in range(data)]
               for m in range(model)],
    }


def make_grid_context(pod: int, data: int, model: int, *,
                      sp: bool = False) -> ParallelContext:
    """This process's context on a (pod, data, model) grid that is the
    whole initialised world (its size must be pod x data x model). Every
    rank creates every group (``dist.new_group``), in the same order, as
    torch.distributed requires; an axis of size 1 gets none."""
    if not dist.is_initialized():
        raise RuntimeError("make_grid_context needs an initialised "
                           "torch.distributed world (init_context)")
    world = dist.get_world_size()
    if world != pod * data * model:
        raise ValueError(f"a ({pod}, {data}, {model}) grid needs {pod * data * model} "
                         f"ranks, the world has {world}")
    me = dist.get_rank()
    sizes = {"model": model, "data": data, "pod": pod, "dp": pod * data}
    mine = {}
    for axis, groups in grid_ranks(pod, data, model).items():
        for ranks in groups:
            if sizes[axis] == 1:
                continue
            g = dist.new_group(ranks)
            if me in ranks:
                mine[axis] = g
    m, dp = me % model, me // model
    return ParallelContext(tp_size=model, rank=m, group=mine.get("model"), sp=sp,
                           dp_size=pod * data, pod_size=pod, dp_rank=dp,
                           dp_group=mine.get("dp"), data_group=mine.get("data"),
                           pod_group=mine.get("pod"))


def make_dry_context(pod: int, data: int, model: int, *, rank: int = 0,
                     sp: bool = False) -> ParallelContext:
    """World rank ``rank``'s context on a (pod, data, model) grid numbered as
    ``grid_ranks`` numbers it, whose groups are ``DryGroup``s: no process
    and no device. Each collective is recorded in ``COLLECTIVES`` and
    returns what one rank's view gives: a sum the rank's input, a gather
    the rank's block among zero blocks, a sum-and-scatter the rank's
    block. Its tensors must lie on "meta"."""
    n = pod * data * model
    if min(pod, data, model) < 1 or not 0 <= rank < n:
        raise ValueError(f"rank {rank} of a ({pod}, {data}, {model}) grid")

    def group(axis, size):
        return DryGroup(axis, size) if size > 1 else None
    return ParallelContext(tp_size=model, rank=rank % model,
                           group=group("tp", model), sp=sp,
                           dp_size=pod * data, pod_size=pod, dp_rank=rank // model,
                           dp_group=group("dp", pod * data),
                           data_group=group("data", data), pod_group=group("pod", pod))


def init_context(*, backend: str, init_method: str, world_size: int,
                 rank: int) -> ParallelContext:
    """Initialise the default process group with ``backend`` ("nccl": one
    card per rank; "gloo": CUDA or CPU tensors, ranks may share a card)
    and return this rank's context, the world being the tp group.
    ``init_method`` is where the ranks meet: ``tcp://localhost:<port>`` or
    ``file://<path>``. The caller places its tensors
    (``torch.cuda.set_device`` for NCCL) and ends the group with
    ``torch.distributed.destroy_process_group``. A grid of data and model
    ranks is ``make_grid_context`` over the world this makes."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return make_context()
