"""Telemetry (the port of `nanorlhf_tpu/telemetry/`): cross-thread span
tracing with a flight-recorder ring (tracer.py, Chrome trace-event JSON),
analytic MFU/throughput accounting with a kernel-build recompile counter
(mfu.py), the run-health plane — streaming anomaly detection over the
metric stream (health.py) plus a live /metrics · /healthz · /statusz HTTP
exporter (exporter.py) — the per-sample lineage ledger (lineage.py), the
latency histograms (hist.py) and the rollout/train overlap meter
(overlap.py). All but mfu.py are copies of the JAX modules; mfu.py reads
the card through torch. The exported names are the JAX package's, minus
its jax.monitoring event name, plus `OverlapMeter`."""

from nanorlhf_tpu_torch.telemetry.exporter import (
    StatusExporter,
    render_prometheus,
    render_prometheus_histograms,
    validate_prometheus_text,
)
from nanorlhf_tpu_torch.telemetry.health import (
    DEFAULT_RULES,
    SLO_RULES,
    HealthConfig,
    HealthMonitor,
    HealthRule,
)
from nanorlhf_tpu_torch.telemetry.hist import (
    LatencyHub,
    StreamingHistogram,
    percentiles_from_samples,
)
from nanorlhf_tpu_torch.telemetry.lineage import (
    LineageLedger,
    chains,
    drop_histogram,
    read_ledger,
)
from nanorlhf_tpu_torch.telemetry.mfu import (
    CPU_PEAK_FLOPS,
    PEAK_FLOPS_PER_CHIP,
    RecompileCounter,
    flops_param_count,
    peak_flops_per_chip,
    recompile_counter,
    update_flops,
)
from nanorlhf_tpu_torch.telemetry.overlap import OverlapMeter
from nanorlhf_tpu_torch.telemetry.tracer import (
    SpanTracer,
    validate_trace_events,
    validate_trace_file,
)

__all__ = [
    "CPU_PEAK_FLOPS",
    "DEFAULT_RULES",
    "HealthConfig",
    "HealthMonitor",
    "HealthRule",
    "LatencyHub",
    "LineageLedger",
    "OverlapMeter",
    "PEAK_FLOPS_PER_CHIP",
    "RecompileCounter",
    "SLO_RULES",
    "SpanTracer",
    "StatusExporter",
    "StreamingHistogram",
    "chains",
    "drop_histogram",
    "flops_param_count",
    "peak_flops_per_chip",
    "percentiles_from_samples",
    "read_ledger",
    "recompile_counter",
    "render_prometheus",
    "render_prometheus_histograms",
    "update_flops",
    "validate_prometheus_text",
    "validate_trace_events",
    "validate_trace_file",
]
