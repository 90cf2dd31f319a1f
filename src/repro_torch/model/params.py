"""Parameter templates, tree helpers and the module that owns the weights.

Model modules describe their parameters as trees (nested dicts and lists) of
``PD`` descriptors, as in the JAX package. From a template ``init_tree``
makes tensors. The layer math takes plain trees of tensors; ``ModelParams``
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


def tree_structure(tree):
    """Nested key structure without the leaves (for template comparison)."""
    return tree_map(lambda _: None, tree)


def init_tree(tmpl, generator: torch.Generator, dtype=torch.float32,
              device=None):
    """Tensors for a template: normal * fan_in^-0.5, zeros or ones. Leaves
    draw from ``generator`` in JAX's flatten order; the bits differ from
    JAX's ``init_tree``, the distribution does not. ``generator`` must live
    on ``device``."""
    device = torch.device(device if device is not None else generator.device)

    def make(pd: PD):
        dt = pd.dtype or dtype
        if pd.init == "zeros":
            return torch.zeros(pd.shape, dtype=dt, device=device)
        if pd.init == "ones":
            return torch.ones(pd.shape, dtype=dt, device=device)
        fan = pd.fan_in
        if fan is None:
            fan = pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1]
        x = torch.randn(pd.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * fan ** -0.5).to(dt)

    return tree_map(make, tmpl)


def stack_tmpl(tmpl, n: int):
    """Template for ``n`` stacked copies (segments / LP pairs): prepend a
    leading axis to every descriptor, keeping each one's fan-in."""

    def bump(pd: PD) -> PD:
        fan = pd.fan_in if pd.fan_in is not None else (
            pd.shape[-2] if len(pd.shape) >= 2 else pd.shape[-1])
        return PD(shape=(n, *pd.shape), init=pd.init, fan_in=fan,
                  dtype=pd.dtype)

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
        raise TypeError(f"param tree dict mixes tensors and subtrees: "
                        f"{sorted(node)}")
    return nn.ModuleDict({k: _to_module(v) for k, v in node.items()})


def _from_module(m):
    if isinstance(m, nn.ParameterDict):
        return {k: v for k, v in m.items()}
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
