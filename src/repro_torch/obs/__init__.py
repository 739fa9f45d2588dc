"""Observability (port of `repro/obs`): one telemetry spine for every
execution path of the port.

  gauges    pure reductions over the resident buffer and the push-sum
            weights + host meters (wire bytes, device memory)
  graph     collaboration-graph gauges: contraction estimate, per-edge
            attribution, similarity
  record    versioned record schema (round/tick/serve/graph/alert), the
            reference's constants, so each package reads the other's files
  sink      MetricsSink protocol: Null / Ring / Jsonl / Tee
  flight    FlightRecorder sink wrapper: anomaly gates + post-mortems
  profiler  maybe_trace (torch.profiler) + PhaseTimer (perf_counter)
  report    `python -m repro_torch.obs.report run.jsonl [--check|--graph|
            --diff|--postmortem]`

Instrumentation is off by default and gated by `AlgoSpec.telemetry`;
with it off every round is the uninstrumented program bit for bit, and
with it on the state that flows on is unchanged bit for bit.
"""
from . import gauges, record
from .flight import FlightRecorder
from .gauges import accounted_bytes, peak_device_memory
from .profiler import PhaseTimer, maybe_trace
from .record import (SCHEMA_VERSION, alert_record, graph_record,
                     round_record, serve_record, tick_record)
from .sink import (NULL_SINK, JsonlSink, MetricsSink, NullSink, RingSink,
                   TeeSink)

__all__ = [
    "gauges", "record",
    "accounted_bytes", "peak_device_memory",
    "PhaseTimer", "maybe_trace",
    "SCHEMA_VERSION", "round_record", "tick_record", "serve_record",
    "graph_record", "alert_record",
    "MetricsSink", "NullSink", "RingSink", "JsonlSink", "TeeSink",
    "NULL_SINK", "FlightRecorder",
]
