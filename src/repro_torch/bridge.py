"""Weight bridge: a JAX param tree, converted to numpy, -> the port's weights.

The caller converts on its side (``jax.tree.map(np.asarray, params)``); this
module imports no JAX. The tree keeps the JAX package's structure —
``embed`` / ``segments`` / ``final_norm`` (and ``enc_segments`` /
``enc_norm`` for an encoder-decoder; the ``lnx`` / ``xattn`` leaves of its
cross-attention layers sit in the decoder's segments), with segment leaves
stacked ``[count, (2,) ...]`` as ``transformer.model_template`` builds
them — which is the port's structure too, so both packages then compute
the same function.

At tp > 1 (``shard_from_numpy``) the tree is the GLOBAL one the JAX
package builds for a tp-structured model, and each rank keeps its shard:
every leaf is cut on the host along its split axis
(``transformer.param_pspecs``, block by block where ``param_parts`` says
the axis concatenates blocks: Mamba's ``w_in``) before anything is copied,
so no process puts another rank's shard on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.model.params import ModelParams, shard_tree, tree_leaves, tree_map


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree, *, device="cuda",
                      dtype: Optional[torch.dtype] = None) -> ModelParams:
    """numpy param tree -> ``ModelParams`` on ``device`` (the card unless
    the caller asks for "cpu"), cast to ``dtype`` when given."""
    return ModelParams(tree_map(lambda a: _tensor(a, device, dtype), tree))


def shard_from_numpy(tree, ms, rank: int, *, data_index: int = 0, device="cuda",
                     dtype: Optional[torch.dtype] = None) -> ModelParams:
    """Rank ``rank``'s shard of a GLOBAL numpy param tree of the structure
    ``ms`` (built at its tp, as the JAX package's ``init_params`` makes
    it), as ``ModelParams`` on ``device``; ``rank`` is the rank's tp index.

    FSDP (``ms.fsdp``): every segment leaf, a flat (count, data, tp, chunk)
    one or, with ``ms.quant``, an int8 value or fp32 scale leaf of the same
    layout, becomes the rank's (count, 1, 1, chunk) view at data index
    ``data_index``; int8 shards keep their types (``dtype`` casts the other
    leaves)."""
    from repro_torch.model.transformer import param_parts, param_pspecs
    from repro_torch.parallel.fsdp import rank_view
    specs, parts = param_pspecs(ms), param_parts(ms)
    keys = [k for k in tree if not (ms.fsdp and k == "segments")]
    out = params_from_numpy(shard_tree({k: tree[k] for k in keys},
                                       {k: specs[k] for k in keys}, ms.tp, rank,
                                       {k: parts[k] for k in keys}),
                            device=device, dtype=dtype).tree()
    if ms.fsdp:
        out["segments"] = tree_map(
            lambda a: _tensor(rank_view(a, data_index, rank), device,
                              None if ms.quant else dtype), tree["segments"])
    return ModelParams(out)


def state_from_numpy(state, ms, pc, tc, *, device="cuda"):
    """This rank's train state (``train.trainer``'s layout) from the JAX
    package's GLOBAL train state as numpy arrays (``jax.tree.map(np.asarray,
    state)`` of its ``init_state`` / a step's output at ``pc``'s grid, built
    for ``ms``): the rank's tp shard of every regular param, its ``[dp_index,
    tp_index]`` row of every flat (dp, tp, chunk) master, m and v leaf (at
    dp = 1 in the leaf's own shape), its (count, 1, 1, chunk) view of every
    FSDP (count, data, tp, chunk) leaf, its (pod, chunk) error feedback.
    Pure data movement: no value changes; the params in ``tc.param_dtype``
    with ``requires_grad`` on ``tc``'s trainable leaves
    (``trainer.params_from_master``)."""
    from repro_torch.model.params import tree_items
    from repro_torch.model.transformer import model_template, param_parts, param_pspecs
    from repro_torch.parallel.fsdp import rank_view
    from repro_torch.train.trainer import leaf_infos, params_from_master
    tmpl = model_template(ms)
    if pc.tp_size > 1 and any(n > 1 for n in tree_leaves(param_parts(ms))):
        raise NotImplementedError(
            "a leaf whose split axis concatenates blocks (Mamba's w_in): the JAX "
            "package's flat rows at tp > 1 cut it otherwise (ROADMAP §3)")
    t, d, dp = pc.tp_index(), pc.data_index(), pc.dp_index()
    is_fsdp = [ms.fsdp and path.startswith("segments/") for path, _ in tree_items(tmpl)]
    params = shard_tree(state["params"], param_pspecs(ms), ms.tp, t, param_parts(ms))
    if ms.fsdp:
        params["segments"] = tree_map(lambda a: rank_view(a, d, t),
                                      state["params"]["segments"])
    shapes = [np.shape(a) for a in tree_leaves(params)]

    def rank_part(tree, regular):
        it = iter(zip(is_fsdp, shapes))

        def one(a):
            fsdp, shape = next(it)
            return _tensor(rank_view(a, d, t) if fsdp else regular(a[dp, t], shape),
                           device, None)
        return tree_map(one, tree)

    # at dp = 1 a row is the whole tp-local leaf (no padding): its own shape
    row = (lambda r, shape: r.reshape(shape)) if pc.dp_size == 1 else (lambda r, _: r)
    out = {"params": params_from_master(tree_map(lambda a: _tensor(a, device, None),
                                                 params),
                                        leaf_infos(ms, tc), tc.param_dtype),
           **{key: rank_part(state[key], row) for key in ("master", "m", "v")},
           "step": int(np.asarray(state["step"]))}
    if "err" in state:
        out["err"] = rank_part(state["err"], lambda r, _: r)
    return out
