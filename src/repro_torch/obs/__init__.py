"""repro_torch.obs — in-loop telemetry (port of ``repro/obs``).

* :mod:`repro_torch.obs.metrics` — *what* to record: the paper's per-round
  theory quantities (prox-gradient mapping, consensus errors, tracking
  error, momentum variance), cohort size and bytes on the wire.
* :mod:`repro_torch.obs.record` — *how*: a device ring buffer copied to
  the host once every B logged rows.
* :mod:`repro_torch.obs.trace` / :mod:`repro_torch.obs.sinks` — profiler
  annotations, dispatch-vs-blocked timers, and the JSONL / CSV / in-memory
  event sinks.

Attributes resolve lazily (PEP 562): ``repro_torch.core`` modules
annotate their phases through :mod:`repro_torch.obs.trace` while
:mod:`repro_torch.obs.metrics` imports them back.
"""
import importlib

#: public name -> defining submodule
_EXPORTS = {
    "DEFAULT_METRICS": "metrics", "MetricSpec": "metrics",
    "prox_gap_sq": "metrics", "round_values": "metrics",
    "traced_payload_row_bytes": "metrics", "traced_round_bytes": "metrics",
    "tracking_error": "metrics",
    "Telemetry": "record", "TelemetryCarry": "record",
    "CsvSink": "sinks", "JsonlSink": "sinks", "MemorySink": "sinks",
    "validate_event": "sinks", "validate_jsonl": "sinks",
    "PHASES": "trace", "RoundTimer": "trace", "Timing": "trace",
    "annotate": "trace", "block_until_ready": "trace",
    "profile_capture": "trace", "time_fn": "trace",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'repro_torch.obs' has no attribute {name!r}")
    value = getattr(importlib.import_module(f"repro_torch.obs.{module}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
