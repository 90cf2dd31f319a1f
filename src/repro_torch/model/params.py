"""Parameter templates, tree helpers and the module that owns the weights.

Model modules describe their parameters as trees (nested dicts and lists) of
``PD`` descriptors, as in the JAX package: GLOBAL shapes, and the axis each
leaf splits over the tensor-parallel ranks (``split``, JAX's "model" entry
of the leaf's PartitionSpec). From a template ``init_tree`` makes tensors
(a rank's shard of them at tp > 1), ``split_tree`` gives the split axes
and ``shard_tree`` cuts a global tree to one rank's shard. A split axis
that concatenates ``parts`` equal blocks (Mamba's ``w_in`` = [x; z]) is cut
block by block: rank r keeps the r-th piece of every block, in block order.
The layer math takes plain trees of tensors; ``ModelParams``
is the ``nn.Module`` that owns them, so ``.to(device)`` and ``state_dict``
work, and ``ModelParams.tree()`` hands the layer functions the same tensors
as a plain tree.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch import nn


@dataclass(frozen=True)
class PD:
    """Descriptor of one parameter tensor."""

    shape: Tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones
    fan_in: Optional[int] = None  # None -> last-but-one dim (or last)
    dtype: Any = None  # None -> use the build dtype
    split: Optional[int] = None  # axis cut over the tp ranks; None: replicated
    parts: int = 1               # equal blocks along ``split``, each cut over the ranks


def tree_map(fn, tree, *rest):
    """Map ``fn`` over the leaves of nested dicts/lists/tuples (dict keys in
    sorted order, as JAX flattens them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


def tree_items(tree, prefix=""):
    """[(path, leaf)] in ``tree_map``'s order; a path joins the dict keys
    and list indices from the root with "/" (``master/segments/0/attn/wq``),
    as the JAX package's checkpoint names its leaves."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in tree_items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [item for i, x in enumerate(tree)
                for item in tree_items(x, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def tree_structure(tree):
    """Nested key structure without the leaves (for template comparison)."""
    return tree_map(lambda _: None, tree)


def split_tree(tmpl):
    """The ``split`` axis of every leaf of a template (None: replicated)."""
    return tree_map(lambda pd: pd.split, tmpl)


def parts_tree(tmpl):
    """The ``parts`` of every leaf of a template (1: one block)."""
    return tree_map(lambda pd: pd.parts, tmpl)


def shard_slice(shape, split: Optional[int], tp: int, rank: int,
                parts: int = 1):
    """Index of rank ``rank``'s shard of a global leaf of ``shape``: the
    ``split`` axis cut into ``tp`` equal blocks, the others whole. With
    ``parts`` > 1 the axis is ``parts`` equal blocks laid end to end, each
    cut into ``tp``: the rank's piece of every block, in block order (a
    list of indices on that axis, so the shard is a copy)."""
    if split is None or tp == 1:
        return (slice(None),) * len(shape)
    n = shape[split]
    if n % (tp * parts):
        raise ValueError(f"axis {split} of {tuple(shape)} does not divide by "
                         f"tp={tp}"
                         + (f" in each of {parts} parts" if parts > 1 else ""))
    w = n // (tp * parts)
    if parts == 1:
        cut = slice(rank * w, (rank + 1) * w)
    else:
        cut = [b * (n // parts) + rank * w + i for b in range(parts) for i in range(w)]
    return tuple(cut if i == split else slice(None) for i in range(len(shape)))


def shard_tree(tree, splits, tp: int, rank: int, parts=None):
    """Rank ``rank``'s shard of a global tree (tensors or numpy arrays):
    each leaf cut along its ``splits`` axis (``split_tree`` of the
    template), block by block where ``parts`` (``parts_tree`` of the
    template; None: one block each) says so; as views where the leaf type
    slices to views and the leaf is one block."""
    if parts is None:
        parts = tree_map(lambda _: 1, splits)
    return tree_map(lambda x, ax, n: x[shard_slice(x.shape, ax, tp, rank, n)],
                    tree, splits, parts)


def local_shape(pd: PD, tp: int):
    return tuple(n // tp if i == pd.split else n for i, n in enumerate(pd.shape))


def init_tree(tmpl, generator: torch.Generator, dtype=torch.float32,
              device=None, *, tp: int = 1, rank: int = 0):
    """Tensors for a template: normal * fan_in^-0.5, zeros or ones. Leaves
    draw from ``generator`` in JAX's flatten order; the bits differ from
    JAX's ``init_tree``, the distribution does not. ``generator`` must live
    on ``device``.

    A stacked leaf ([n, (2,) D, F]) is drawn one matrix at a time, in fp32,
    and cast into its slice of the output: the fp32 transient is one
    layer's matrix, not the whole leaf (granite-34b's stacked ``w_up`` would
    be ~27 GB in fp32).

    At ``tp`` > 1 the result is rank ``rank``'s shard: every matrix is drawn
    whole, so each rank draws the same global weights from the same seed
    (those of ``tp`` 1 where the global shapes agree), and only the rank's
    block of it is kept."""
    device = torch.device(device if device is not None else generator.device)

    def make(pd: PD):
        dt = pd.dtype or dtype
        shape = local_shape(pd, tp)
        if pd.init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if pd.init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        fan = pd.fan_in
        if fan is None:
            fan = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        out = torch.empty(shape, dtype=dt, device=device)
        cut = shard_slice(pd.shape, pd.split, tp, rank, pd.parts)
        if len(pd.shape) <= 2:
            x = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                            device=device)
            out.copy_(x[cut].mul_(fan ** -0.5))
            return out
        # Every matrix of the stack is drawn; the rank's are kept, in order.
        keep = torch.zeros(pd.shape[:-2], dtype=torch.bool)
        keep[cut[:-2]] = True
        mats = iter(out.view(-1, *shape[-2:]))
        for kept in keep.reshape(-1).tolist():
            x = torch.randn(pd.shape[-2:], generator=generator,
                            dtype=torch.float32, device=device)
            if kept:
                next(mats).copy_(x[cut[-2:]].mul_(fan ** -0.5))
        return out

    return tree_map(make, tmpl)


def stack_tmpl(tmpl, n: int):
    """Template for ``n`` stacked copies (segments / LP pairs): prepend a
    leading axis to every descriptor, keeping each one's fan-in; the split
    axis moves one to the right."""

    def bump(pd: PD) -> PD:
        fan = pd.fan_in if pd.fan_in is not None else (
            pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1])
        return PD(shape=(n, *pd.shape), init=pd.init, fan_in=fan,
                  dtype=pd.dtype,
                  split=None if pd.split is None else pd.split + 1,
                  parts=pd.parts)

    return tree_map(bump, tmpl)


def stack_trees(trees):
    """Stack a list of identical-structure param trees along a new axis 0."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


# ---------------------------------------------------------------------------
# The module that owns the weights
# ---------------------------------------------------------------------------

def _to_module(node):
    if isinstance(node, (list, tuple)):
        return nn.ModuleList([_to_module(x) for x in node])
    if not isinstance(node, dict):
        raise TypeError(f"param tree node of type {type(node).__name__}")
    if all(isinstance(v, torch.Tensor) for v in node.values()):
        return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False)
                                 for k, v in node.items()})
    if any(isinstance(v, torch.Tensor) for v in node.values()):
        return _MixedDict(node)
    return nn.ModuleDict({k: _to_module(v) for k, v in node.items()})


class _MixedDict(nn.Module):
    """A tree dict that holds tensors beside subtrees (a MoE layer: the
    experts' weights beside its ``shared`` expert)."""

    def __init__(self, node):
        super().__init__()
        for k, v in node.items():
            if isinstance(v, torch.Tensor):
                self.register_parameter(k, nn.Parameter(v, requires_grad=False))
            else:
                self.add_module(k, _to_module(v))


def _from_module(m):
    if isinstance(m, nn.ParameterDict):
        return {k: v for k, v in m.items()}
    if isinstance(m, _MixedDict):
        return {**m._parameters, **{k: _from_module(v) for k, v in m._modules.items()}}
    if isinstance(m, nn.ModuleList):
        return [_from_module(x) for x in m]
    return {k: _from_module(v) for k, v in m.items()}


class ModelParams(nn.ModuleDict):
    """A model's weights (``embed`` / ``segments`` / ``final_norm``), with
    the JAX package's tree structure and names. State-dict keys follow the
    tree: ``segments.0.attn.wq``."""

    def __init__(self, tree):
        super().__init__({k: _to_module(v) for k, v in tree.items()})

    def tree(self):
        """The weights as a plain nested dict/list of tensors (no copy)."""
        return _from_module(self)


def as_tree(params):
    """Accept either ``ModelParams`` or a plain tree."""
    return params.tree() if isinstance(params, ModelParams) else params
