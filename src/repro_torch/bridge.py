"""Weight bridge: a JAX param tree, converted to numpy, -> the port's weights.

The caller converts on its side (``jax.tree.map(np.asarray, params)``); this
module imports no JAX. The tree keeps the JAX package's structure —
``embed`` / ``segments`` / ``final_norm`` (and ``enc_segments`` /
``enc_norm`` for an encoder-decoder; the ``lnx`` / ``xattn`` leaves of its
cross-attention layers sit in the decoder's segments), with segment leaves
stacked ``[count, (2,) ...]`` as ``transformer.model_template`` builds
them — which is the port's structure too, so both packages then compute
the same function.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.model.params import ModelParams, tree_map


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
