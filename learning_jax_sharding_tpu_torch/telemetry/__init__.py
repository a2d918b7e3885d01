"""Telemetry: measurement and diagnosis of the port's serving loop.

Port of ``learning_jax_sharding_tpu/telemetry`` (slice E's core):

* :mod:`.registry`: counters, gauges and fixed-bucket histograms with a
  JSON snapshot and Prometheus text exposition;
* :mod:`.spans`: nested spans, instants and async intervals, bridged into
  ``torch.profiler.record_function`` and exported as Chrome trace JSON and
  JSONL;
* :mod:`.flight_recorder`: a bounded ring of structured events with a
  post-mortem ``dump()`` bundle;
* :mod:`.ledger`: the goodput ledger, every second of a loop's wall clock
  in exactly one bucket, with a reconciliation invariant;
* :mod:`.slo`: streaming percentiles and SLO targets with burn rates;
* :mod:`.tracecontext`: request-scoped traces and their critical paths;
* :mod:`.watchdog`: the training loop's non-finite and loss-spike probe,
  the hang heartbeat and NaN localization.

Consumers: ``models.serving.ContinuousEngine`` (its registry, tracer,
recorder, ledger and ``trace_sink``) and ``training.loop.fit``. Not ported
yet: ``compile_watch``, ``devview``, ``commscope`` and ``economics``.
"""

from learning_jax_sharding_tpu_torch.telemetry.flight_recorder import (  # noqa: F401
    FlightRecorder,
    artifact_dir,
    default_flight_recorder,
)
from learning_jax_sharding_tpu_torch.telemetry.ledger import (  # noqa: F401
    BUCKETS,
    GoodputLedger,
)
from learning_jax_sharding_tpu_torch.telemetry.registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    escape_label_value,
    labeled_name,
    snapshot_prometheus_text,
)
from learning_jax_sharding_tpu_torch.telemetry.slo import (  # noqa: F401
    SLOMonitor,
    SLOTarget,
    StreamingPercentile,
)
from learning_jax_sharding_tpu_torch.telemetry.spans import (  # noqa: F401
    Tracer,
    default_tracer,
    device_sync,
)
from learning_jax_sharding_tpu_torch.telemetry.tracecontext import (  # noqa: F401
    STAGES,
    TraceStore,
    merge_tracers,
)
from learning_jax_sharding_tpu_torch.telemetry.watchdog import (  # noqa: F401
    Heartbeat,
    NonFiniteError,
    Watchdog,
    localize_nan,
)
