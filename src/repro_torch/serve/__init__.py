"""One-shot serving (prefill + decode loop)."""
from repro_torch.serve.bucketing import PREFILL_ATTN_IMPL  # noqa: F401
from repro_torch.serve.engine import (  # noqa: F401
    ServeConfig,
    generate,
    make_prefill,
    make_serve_step,
)
