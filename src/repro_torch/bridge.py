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

from repro_torch.model.params import ModelParams, shard_tree, tree_map


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


def shard_from_numpy(tree, ms, rank: int, *, device="cuda",
                     dtype: Optional[torch.dtype] = None) -> ModelParams:
    """Rank ``rank``'s shard of a GLOBAL numpy param tree of the structure
    ``ms`` (built at its tp, as the JAX package's ``init_params`` makes
    it), as ``ModelParams`` on ``device``."""
    from repro_torch.model.transformer import param_parts, param_pspecs
    return params_from_numpy(shard_tree(tree, param_pspecs(ms), ms.tp, rank,
                                        param_parts(ms)),
                             device=device, dtype=dtype)
