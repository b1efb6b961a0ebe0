"""repro_torch.obs — observability: span tracing, Perfetto export, metrics, profiler spans.

  trace    — ``Tracer``: deterministic span/instant/counter/async events with
             sim-clock (event loop) or dispatch-index timestamps; a no-op
             when disabled, so every seam defaults to zero overhead
  export   — Chrome/Perfetto ``trace_event`` JSON: chips→processes,
             affiliations/lanes→threads; canonical byte-stable serialisation
             plus the structural validator CI uses
  metrics  — in-process registry (labelled counters, gauges, fixed-bucket
             histograms) with a plain-dict ``snapshot()``; the cluster
             router's shed/fault books live here
  spans    — ``span(name)``: wall-clock spans inside the port on
             ``torch.profiler``'s clock (the same clock as the device's
             kernels and copies); a shared no-op while no profiler records

Two seams, two clocks: ``Tracer`` is simulated time (the simulator's and the
serving model's timelines, byte-stable), ``span`` is real time (what the host
does while the card runs, read from a profiler trace).

Quick use (see docs/observability.md for the full seam map)::

    from repro_torch import serve
    from repro_torch.obs import Tracer, write_chrome_trace

    tracer = Tracer()
    result = serve.serve_cluster(jobs, chip, n_chips=4, tracer=tracer)
    write_chrome_trace(tracer, "fleet.json")   # open in ui.perfetto.dev
"""

from .export import (
    dumps_chrome_trace,
    to_chrome_trace,
    validate_chrome_trace,
    write_chrome_trace,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry
from .spans import span
from .trace import Tracer

__all__ = [
    "Tracer",
    "to_chrome_trace",
    "dumps_chrome_trace",
    "write_chrome_trace",
    "validate_chrome_trace",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "span",
]
