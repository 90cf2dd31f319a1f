"""Architecture registry. Importing this package registers the
architectures the port runs so far: tinyllama-1.1b (attention + MLP) and
falcon-mamba-7b (Mamba-1, attention-free)."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    LayerSpec,
    get_config,
    list_archs,
    reduced_config,
    register,
)

# Registration side effects — one module per architecture.
from repro_torch.configs import falcon_mamba_7b, tinyllama_1b  # noqa: F401
