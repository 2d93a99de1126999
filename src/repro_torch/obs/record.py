"""The telemetry recorder: a device ring buffer, copied to the host only
when it fills (port of ``repro/obs/record.py``).

A host read per round would make the host wait for the card every round.
So, as in the reference, recording a round writes on the device only:

* :class:`TelemetryCarry` — a ring buffer of ``(B, K)`` fp32 values and
  ``(B,)`` int32 round numbers on the state's device (``(S, B, K)`` and
  ``(S, B)`` for a sweep: one stream a configuration), the count of
  rows written and, per stream tag, the rows already handed to the sinks.
  Both are host ints, as the port's ``DepositumState.t`` is: in eager
  PyTorch the cadence is decided on the host, so they are known without a
  read.
* :meth:`Telemetry.record` — writes one metric row into the buffer (a
  device copy; nothing is read back) when the round hits the cadence
  (``log_every``), or when ``force`` (the final round).
* :meth:`Telemetry.emit` — where the reference hands the buffer to an
  ``io_callback`` every round, this copies it to the host only when every
  row of it is unflushed (the next record would overwrite one): once
  every ``B`` logged rows.  :meth:`Telemetry.sync` (and ``close``,
  ``events``, ``stream``, and the end of every run that records) copies
  what is left.  One copy of a sweep's buffer flushes all S streams, whose
  events carry ``config = s``.  ``host_copies`` counts the copies.

Sinks (:mod:`repro_torch.obs.sinks`) are mutable run-time state of the
``Telemetry`` instance; swapping sinks changes neither the trajectory nor
the copies.  The emission progress lives on the carry, so every run (a
fresh :meth:`Telemetry.init_carry`) starts at 0 and a second run on one
instance emits its rows too (the reference's is kept a tag, and drops a
second run's rows until ``reset``).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Sequence

import torch

from repro_torch._device import resolve_device
from repro_torch.obs.metrics import MetricSpec
from repro_torch.obs.sinks import JsonlSink, MemorySink
from repro_torch.obs.trace import annotate


class TelemetryCarry(NamedTuple):
    """Recording state beside the training state.

    ``vals[..., i % B, :]`` holds the ``i``-th logged row (ring buffer),
    ``rounds[..., i % B]`` its 1-based round number, ``count`` the rows
    written, ``emitted[tag]`` the rows stream ``tag`` has handed to the
    sinks.  :meth:`Telemetry.record` writes into ``vals`` and ``rounds`` in
    place and returns the carry with the new count; the ``emitted`` dict is
    shared by a carry and its successors.
    """

    vals: torch.Tensor    # (B, K) f32, or (S, B, K)
    rounds: torch.Tensor  # (B,) i32, or (S, B)
    count: int            # rows written (host int)
    emitted: dict         # tag -> rows already in the sinks (host ints)


class Telemetry:
    """Recorder: a :class:`MetricSpec` + mutable host sinks."""

    def __init__(self, spec: MetricSpec = MetricSpec(),
                 sinks: Optional[Sequence[Any]] = None):
        self.spec = spec
        self.sinks = list(sinks) if sinks is not None else [MemorySink()]
        # (tags, the newest emitted carry) of each buffer with unflushed rows
        self._pending: list = []
        self.host_copies = 0       # buffer copies to the host so far

    # -- constructors -----------------------------------------------------
    @classmethod
    def memory(cls, spec: MetricSpec = MetricSpec()) -> "Telemetry":
        return cls(spec, [MemorySink()])

    @classmethod
    def jsonl(cls, path: str, spec: MetricSpec = MetricSpec(),
              keep_memory: bool = True) -> "Telemetry":
        """JSONL event log at ``path`` (+ a MemorySink for programmatic
        access unless ``keep_memory=False``)."""
        sinks = [JsonlSink(path)]
        if keep_memory:
            sinks.append(MemorySink())
        return cls(spec, sinks)

    @property
    def memory_sink(self) -> Optional[MemorySink]:
        for s in self.sinks:
            if isinstance(s, MemorySink):
                return s
        return None

    # -- device side ------------------------------------------------------
    def init_carry(self, n_configs: Optional[int] = None, *,
                   device="cuda") -> TelemetryCarry:
        """An empty buffer on ``device``; ``n_configs`` S gives one ring a
        sweep point."""
        dev = resolve_device(device)
        lead = () if n_configs is None else (int(n_configs),)
        B, K = self.spec.buffer, self.spec.n_metrics
        carry = TelemetryCarry(
            vals=torch.zeros(lead + (B, K), dtype=torch.float32, device=dev),
            rounds=torch.zeros(lead + (B,), dtype=torch.int32, device=dev),
            count=0, emitted={})
        return carry

    @staticmethod
    def _done(carry: TelemetryCarry, tags: tuple) -> int:
        """Rows of ``carry``'s buffer every one of ``tags`` has emitted."""
        return min(carry.emitted.get(t, 0) for t in tags)

    def _unpend(self, carry: TelemetryCarry):
        """Drop ``carry``'s buffer from the pending list; its entry, or
        None."""
        for i, entry in enumerate(self._pending):
            if entry[1].emitted is carry.emitted:
                return self._pending.pop(i)
        return None

    def pack(self, values: dict) -> torch.Tensor:
        """One ``(K,)`` f32 row in ``spec.names`` order (``(S, K)`` from
        (S,) values)."""
        missing = [n for n in self.spec.names if n not in values]
        if missing:
            raise KeyError(f"metric values missing {missing}; "
                           f"spec wants {self.spec.names}")
        return torch.stack([torch.as_tensor(values[n], dtype=torch.float32)
                            for n in self.spec.names], dim=-1)

    def record(self, carry: TelemetryCarry, values: dict, r: int,
               log_every: int, *, force: bool = False) -> TelemetryCarry:
        """Write round ``r`` (0-based) into the buffer iff it hits the
        cadence (``(r + 1) % log_every == 0``) or ``force``."""
        if not (force or (r + 1) % max(int(log_every), 1) == 0):
            return carry
        B = self.spec.buffer
        pending = self._unpend(carry)
        if pending is not None:
            # an emitted row not yet flushed would be overwritten: flush it
            tags, emitted = pending
            old = carry.count - B
            if self._done(carry, tags) <= old < emitted.count:
                self._flush(emitted, tags)
            else:
                self._pending.append(pending)
        with annotate("telemetry"):
            row = self.pack(values)
            idx = carry.count % B
            carry.vals[..., idx, :] = row.to(carry.vals.device)
            carry.rounds[..., idx] = r + 1
        return carry._replace(count=carry.count + 1)

    def _tags(self, carry: TelemetryCarry, tag) -> tuple:
        if carry.vals.ndim == 2:
            return (0 if tag is None else int(tag),)
        S = carry.vals.shape[0]
        return tuple(range(S)) if tag is None else tuple(int(t) for t in tag)

    def emit(self, carry: TelemetryCarry, tag=None) -> None:
        """Hand the buffer's new rows to the sinks when it is full of them
        (one host copy every ``B`` logged rows); otherwise keep it for
        :meth:`sync`.  ``tag`` names the stream (default 0); for a sweep's
        carry, a sequence of S tags (default ``range(S)``)."""
        tags = self._tags(carry, tag)
        done = self._done(carry, tags)
        if carry.count - done >= self.spec.buffer:
            self._flush(carry, tags)
        elif carry.count > done:
            self._unpend(carry)
            self._pending.append((tags, carry))

    def record_and_emit(self, carry: TelemetryCarry, values: dict, r: int,
                        log_every: int, *, tag=None,
                        force: bool = False) -> TelemetryCarry:
        carry = self.record(carry, values, r, log_every, force=force)
        self.emit(carry, tag)
        return carry

    # -- host side --------------------------------------------------------
    def _flush(self, carry: TelemetryCarry, tags: tuple) -> None:
        """Copy the buffer to the host and write its unflushed rows."""
        self._unpend(carry)
        with annotate("telemetry"):
            vals = carry.vals.cpu().numpy()
            rounds = carry.rounds.cpu().numpy()
        self.host_copies += 1
        if vals.ndim == 2:
            vals, rounds = vals[None], rounds[None]
        B, count = self.spec.buffer, carry.count
        progress = carry.emitted
        events = []
        for s, tag in enumerate(tags):
            done = progress.get(tag, 0)
            for i in range(max(done, count - B), count):
                row = vals[s, i % B]
                event = {"config": tag, "round": int(rounds[s, i % B])}
                event.update((name, float(row[k]))
                             for k, name in enumerate(self.spec.names))
                events.append(event)
            progress[tag] = max(done, count)
        if events:
            for sink in self.sinks:
                sink.write(events)

    def sync(self) -> None:
        """Copy every buffer that still holds unflushed rows to the sinks."""
        for tags, carry in list(self._pending):
            self._flush(carry, tags)

    def close(self) -> None:
        self.sync()
        for sink in self.sinks:
            sink.close()

    def reset(self) -> None:
        """Flush every pending buffer.  (The progress lives on each carry,
        and each :meth:`init_carry` starts at 0, so a new run on this
        instance emits its rows without a reset.)"""
        self.sync()

    def events(self, config: int = 0) -> list:
        """Events from the memory sink (after :meth:`sync`)."""
        self.sync()
        sink = self.memory_sink
        if sink is None:
            raise ValueError("no MemorySink attached")
        return [e for e in sink.events if e["config"] == config]

    def stream(self, name: str, config: int = 0) -> list:
        """One metric's recorded trajectory, in emission order."""
        self.sync()
        sink = self.memory_sink
        if sink is None:
            raise ValueError("no MemorySink attached")
        return sink.stream(name, config)
