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
    sharded_generate,
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
from repro_torch.serve.trace import (  # noqa: F401
    build_trace,
    dumps_trace,
    strip_wall,
    validate_trace,
    write_trace,
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
from repro_torch.serve.speculative import (  # noqa: F401
    COHORT_SPEC_DRAFT,
    COHORT_SPEC_VERIFY,
    SpecEpisode,
    accept_length,
    build_draft_step,
    build_verify_batch,
    commit_tokens,
    draft_plan_for,
    spec_eligible,
    stale_span,
)
from repro_torch.serve.paged_cache import (  # noqa: F401
    rewind_plan,
    rewind_tokens,
    scatter_prefill_rows,
)
