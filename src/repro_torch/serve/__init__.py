"""Serving: one-shot generation and the continuous-batching engine."""
from repro_torch.serve.bucketing import (  # noqa: F401
    PREFILL_ATTN_IMPL,
    bucket_for,
    default_buckets,
    rows_for_bucket,
    validate_buckets,
)
from repro_torch.serve.engine import (  # noqa: F401
    AdmissionConfig,
    DegradeConfig,
    PagedEngine,
    PagedServeConfig,
    ServeConfig,
    SpecConfig,
    TelemetryConfig,
    generate,
    make_paged_bucket_prefill_fn,
    make_prefill,
    make_serve_step,
)
from repro_torch.serve.faults import (  # noqa: F401
    ALL_FAULT_KINDS,
    BlockTableCorruptionError,
    DeadlineExceededError,
    FaultEvent,
    FaultPlan,
    InvalidRequestError,
    LoadShedError,
    NonFiniteLogitsError,
    PageAccountingError,
    PoisonedPromptError,
    QueueFullError,
    ServeError,
    error_kind,
)
from repro_torch.serve.telemetry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Histogram,
    ProgramCache,
    RequestSpan,
    SpanEvent,
    SpanStateError,
    Telemetry,
)
from repro_torch.serve.prefix_cache import (  # noqa: F401
    PrefixCache,
    RadixNode,
)
from repro_torch.serve.scheduler import (  # noqa: F401
    CANCELLED,
    COHORT_DEGRADED,
    COHORT_MAIN,
    EXPIRED,
    FAILED,
    FINISHED,
    QUEUED,
    RUNNING,
    TERMINAL_STATES,
    PagePool,
    Request,
    Scheduler,
)
