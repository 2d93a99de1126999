"""Pluggable host-side sinks for recorded telemetry events (port of
``repro/obs/sinks.py``; the schema and the JSONL lines are the
reference's, byte for byte).

A *sink* receives fully-materialised **event dicts** — one per logged
round per config — from the recorder's host flush.  Events are plain
Python scalars by the time a sink sees them (the recorder converts the
device buffer), so sinks never touch torch.  The canonical event shape::

    {"config": 0, "round": 10, "prox_grad_sq": 0.031, "consensus_x": ...}

``config`` is the sweep-axis index (0 for unswept runs); ``round`` is
1-based like ``FederatedTrainer`` history.  Metric keys vary with the
run's :class:`~repro_torch.obs.metrics.MetricSpec`; missing metrics are
simply absent, never None.

Sinks are mutable run-time state of a :class:`~repro_torch.obs.record.
Telemetry` instance: swapping them changes where events go and nothing
else (neither the trajectory nor the recorder's host copies).
"""
from __future__ import annotations

import csv
import io
import json
import math
import os
from typing import Iterable, Optional

#: Keys every event carries regardless of MetricSpec.
EVENT_KEYS = ("config", "round")


def validate_event(event: dict, names: Optional[Iterable[str]] = None
                   ) -> None:
    """Raise ValueError unless ``event`` matches the telemetry schema.

    Schema: ``config`` and ``round`` are non-negative ints; every other
    key is a finite-or-NaN float; with ``names`` given, the metric keys
    must be exactly that set.  Used by the in-memory sink (always) and
    :func:`validate_jsonl` (on emitted logs).
    """
    for key in EVENT_KEYS:
        if key not in event:
            raise ValueError(f"event missing {key!r}: {event}")
        v = event[key]
        if not isinstance(v, int) or isinstance(v, bool) or v < 0:
            raise ValueError(f"event[{key!r}] must be a non-negative int, "
                             f"got {v!r}")
    metrics = {k: v for k, v in event.items() if k not in EVENT_KEYS}
    for key, v in metrics.items():
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ValueError(f"event[{key!r}] must be a number, got {v!r}")
        if isinstance(v, float) and math.isinf(v):
            raise ValueError(f"event[{key!r}] is infinite")
    if names is not None and set(metrics) != set(names):
        raise ValueError(f"event metrics {sorted(metrics)} != spec "
                         f"{sorted(names)}")


def validate_jsonl(path: str, names: Optional[Iterable[str]] = None
                   ) -> int:
    """Validate every line of a JSONL event log; return the event count."""
    count = 0
    with open(path) as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not JSON: {e}") from e
            validate_event(event, names)
            count += 1
    return count


class MemorySink:
    """Keeps events in a list; the default sink and the test workhorse.

    ``stream(name, config=)`` returns one metric's values in emission
    order — the recorded *trajectory* the theory tests assert on.
    """

    def __init__(self, validate: bool = True):
        self.events: list = []
        self._validate = validate

    def write(self, events) -> None:
        if self._validate:
            for e in events:
                validate_event(e)
        self.events.extend(events)

    def close(self) -> None:
        pass

    def rounds(self, config: int = 0) -> list:
        return [e["round"] for e in self.events if e["config"] == config]

    def stream(self, name: str, config: int = 0) -> list:
        return [e[name] for e in self.events
                if e["config"] == config and name in e]

    def configs(self) -> list:
        return sorted({e["config"] for e in self.events})


class JsonlSink:
    """Appends one JSON object per event to ``path`` (the event log).

    Line-buffered append: each flush lands whole lines, so a crashed run
    leaves a valid prefix.  Validate with :func:`validate_jsonl`.
    """

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh: Optional[io.TextIOBase] = open(self.path, "a")

    def write(self, events) -> None:
        if self._fh is None:
            raise ValueError(f"JsonlSink({self.path!r}) is closed")
        for e in events:
            self._fh.write(json.dumps(e, sort_keys=True) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class CsvSink:
    """Writes events as CSV rows; the header is fixed by the first batch.

    Columns are ``config, round, <metrics in first-event order>``; later
    events missing a column write empty cells, extra keys are dropped
    (CSV is rectangular — use JSONL for schema-evolving logs).
    """

    def __init__(self, path: str):
        self.path = str(path)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh: Optional[io.TextIOBase] = open(self.path, "w", newline="")
        self._writer = None
        self._fields: Optional[list] = None

    def write(self, events) -> None:
        if self._fh is None:
            raise ValueError(f"CsvSink({self.path!r}) is closed")
        for e in events:
            if self._writer is None:
                self._fields = list(EVENT_KEYS) + [
                    k for k in e if k not in EVENT_KEYS]
                self._writer = csv.DictWriter(
                    self._fh, fieldnames=self._fields, extrasaction="ignore")
                self._writer.writeheader()
            self._writer.writerow(e)
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
