"""Run-wide telemetry and the serving path's observability.

Counterpart of ``pumiumtally_tpu/obs``:
  * ``walk_stats`` — the per-walk stats vector's schema;
  * ``registry`` — labeled counters, gauges and histograms with
    ``snapshot()`` and Prometheus text;
  * ``recorder`` / ``telemetry`` — the per-move flight recorder and the
    facade helper behind ``PumiTally.telemetry()``;
  * ``convergence`` — the batch statistics' monitor;
  * ``trace`` — the per-job span tracer, its black box and the checks
    of one job's trace;
  * ``aggregate`` / ``slo`` / ``profile`` — registry aggregation,
    multi-window burn-rate SLOs, utilization gauges and
    capture-on-anomaly profiling (``PUMI_TPU_PROFILE=anomaly``);
  * ``fleetview`` — a serving fleet's picture rendered or checked from
    its directory or a live router (``python -m
    pumiumtally_tpu_torch.obs.fleetview [--check]``);
  * ``exporter`` — ``/metrics``, ``/healthz``, ``/buildz`` and the
    owner's endpoints over HTTP (``PUMI_TPU_PROM_PORT=<port>``; 0 picks
    an ephemeral one).

Env knobs: ``PUMI_TPU_METRICS=jsonl:/path`` streams every flight record
to that file; ``PUMI_TPU_LOG_JSON=1`` renders the logger's records as
JSON; ``PUMI_TPU_TRACE=off`` turns span emission off.
"""
from .aggregate import (
    FLEETSTATS_FILE,
    FLEETSTATS_SCHEMA,
    FleetAggregator,
    render_snapshot_prometheus,
)
from .convergence import (
    CONV_FIELDS,
    CONV_IDX,
    CONV_LEN,
    ConvergenceMonitor,
    conv_to_dict,
    reduce_chip_conv,
)
from .exporter import MetricsExporter, maybe_start_exporter
from .profile import FleetProfiler, profile_mode
from .recorder import FLIGHT_SCHEMA, FlightRecorder
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
)
from .slo import SLO, SLOEvaluator, default_slos
from .telemetry import TallyTelemetry
from .trace import (
    NO_PARENT,
    TRACE_SCHEMA,
    SpanTracer,
    check_job_trace,
    chrome_trace,
    job_trace,
    load_trace_records,
    trace_enabled,
)
from .walk_stats import (
    IDX,
    WALK_STATS_FIELDS,
    WALK_STATS_LEN,
    reduce_chip_stats,
    stats_to_dict,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "FlightRecorder",
    "FLIGHT_SCHEMA",
    "SpanTracer",
    "NO_PARENT",
    "TRACE_SCHEMA",
    "chrome_trace",
    "trace_enabled",
    "job_trace",
    "check_job_trace",
    "load_trace_records",
    "TallyTelemetry",
    "MetricsExporter",
    "maybe_start_exporter",
    "FleetAggregator",
    "FLEETSTATS_FILE",
    "FLEETSTATS_SCHEMA",
    "render_snapshot_prometheus",
    "SLO",
    "SLOEvaluator",
    "default_slos",
    "FleetProfiler",
    "profile_mode",
    "IDX",
    "WALK_STATS_FIELDS",
    "WALK_STATS_LEN",
    "stats_to_dict",
    "reduce_chip_stats",
    "CONV_FIELDS",
    "CONV_LEN",
    "CONV_IDX",
    "ConvergenceMonitor",
    "conv_to_dict",
    "reduce_chip_conv",
]
