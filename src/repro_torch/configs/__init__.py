"""Architecture registry. Importing this package registers the
architectures the port runs so far (tinyllama-1.1b)."""
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    LayerSpec,
    get_config,
    list_archs,
    reduced_config,
    register,
)

# Registration side effects — one module per architecture.
from repro_torch.configs import tinyllama_1b  # noqa: F401
