"""Architecture registry. Importing this package registers the
architectures the port runs so far: the dense decoders tinyllama-1.1b,
yi-6b (GQA, hd 128), minicpm-2b (MHA) and granite-34b (MQA, LayerNorm,
GeLU MLP with biases, learned positions), falcon-mamba-7b (Mamba-1,
attention-free) and recurrentgemma-9b (RG-LRU recurrent blocks and local
attention at hd 256), and the mixture-of-experts pair dbrx-132b (16
experts, top 4, LayerNorm) and llama4-scout (16 experts, top 1, a shared
expert; three chunked-attention layers, then one global layer without
positions), the prefix-LM paligemma-3b (a Gemma decoder behind 256 patch
embeddings that attend bidirectionally) and the encoder-decoder
whisper-medium (a bidirectional encoder over 1500 frame embeddings, a
decoder with cross-attention). Each module is a copy of the JAX package's
file of the same name, and so is ``shapes.py``: the four input shapes of
the dry run's 40 (architecture x shape) cells."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    LayerSpec,
    get_config,
    list_archs,
    reduced_config,
    register,
)
from repro_torch.configs.shapes import (  # noqa: F401
    ALL_SHAPES,
    SHAPES,
    ShapeConfig,
    applicable,
    cells,
)

# Registration side effects — one module per architecture.
from repro_torch.configs import (  # noqa: F401
    dbrx_132b,
    falcon_mamba_7b,
    granite_34b,
    llama4_scout,
    minicpm_2b,
    paligemma_3b,
    recurrentgemma_9b,
    tinyllama_1b,
    whisper_medium,
    yi_6b,
)

ASSIGNED_ARCHS = (
    "yi-6b",
    "minicpm-2b",
    "granite-34b",
    "tinyllama-1.1b",
    "whisper-medium",
    "recurrentgemma-9b",
    "falcon-mamba-7b",
    "llama4-scout-17b-a16e",
    "dbrx-132b",
    "paligemma-3b",
)
