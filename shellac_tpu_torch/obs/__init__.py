"""shellac_tpu_torch.obs: metrics, request tracing and the flight
recorder of the port's serving path.

The port's counterpart of `shellac_tpu/obs/`, limited to what the HTTP
server exposes: the dependency-free metrics core (`metrics.py`), the
request span and the serving and engine instrument bundles
(`trace.py`), and the trace-id header contract with the flight recorder
behind `/debug/requests` (`events.py`). The fleet, SLO, incident, spool
and trace-report layers are not ported yet.
"""

from shellac_tpu_torch.obs.events import (
    REQUEST_ID_HEADER,
    TRACE_HEADER,
    FlightRecorder,
    adopt_trace,
    format_trace_header,
    new_trace_id,
    parse_trace_header,
)
from shellac_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
    linear_buckets,
    log_buckets,
    set_default_registry,
)
from shellac_tpu_torch.obs.trace import (
    STEP_PHASES,
    EngineMetrics,
    RequestTrace,
    ServeMetrics,
)

__all__ = [
    "FlightRecorder",
    "TRACE_HEADER",
    "REQUEST_ID_HEADER",
    "new_trace_id",
    "parse_trace_header",
    "format_trace_header",
    "adopt_trace",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "get_registry",
    "set_default_registry",
    "log_buckets",
    "linear_buckets",
    "EngineMetrics",
    "RequestTrace",
    "ServeMetrics",
    "STEP_PHASES",
]
