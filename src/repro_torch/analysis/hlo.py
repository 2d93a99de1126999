"""Collective traffic of the port's own collectives, in the shape of
``repro/analysis/hlo.py``.

The reference regexes XLA's post-partitioning HLO for its collective ops
and sums their per-device payloads, because ``cost_analysis()`` has no
collective bytes.  The port compiles no HLO: its collectives are calls on a
:class:`~repro_torch.launch.mesh.ShardAxis`.  So instead of parsing a
program, a backend built with :class:`CountingAxis` for its axis
(:func:`counting`) records every call as it happens — its kind, under XLA's names (``all-gather``, ``all-reduce``,
``collective-permute``), and the bytes this process puts on the wire (the
operand it contributes; a ``ppermute`` counts only when this process
sends).  :func:`parse_collectives` / :func:`collective_bytes` read the
records into the reference's ``{kind: {"count", "bytes"}}`` and its total,
per device, the numerator of the roofline's collective term.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

import torch

from repro_torch.launch.mesh import ShardAxis


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class CountingAxis(ShardAxis):
    """The shard axis ``axis`` that records each collective it runs in
    ``records`` (``(kind, bytes)`` pairs).  ``pmean`` and the client
    reductions run through the counted ``psum``."""

    def __init__(self, axis: ShardAxis):
        super().__init__(axis.name, axis.size, axis.index, axis.group,
                         axis.ranks)
        self.records: list[tuple[str, int]] = []

    def reset(self) -> None:
        self.records.clear()

    def ppermute(self, x, perm):
        if any(src == self.index and dst != self.index for src, dst in perm):
            self.records.append(("collective-permute", _nbytes(x)))
        return super().ppermute(x, perm)

    def all_gather(self, x, tiled: bool = True):
        self.records.append(("all-gather", _nbytes(x)))
        return super().all_gather(x, tiled)

    def psum(self, x):
        self.records.append(("all-reduce", _nbytes(x)))
        return super().psum(x)


def counting(backend):
    """A copy of the sharded ``backend`` whose axis is a
    :class:`CountingAxis`: every mixer built from the copy counts (read
    ``copy.axis``); the backend itself is left as it was."""
    return dataclasses.replace(backend, axis_wrapper=CountingAxis)


def parse_collectives(records) -> dict[str, dict[str, float]]:
    """``{kind: {"count": c, "bytes": b}}`` from a :class:`CountingAxis`
    (or its ``records``): bytes sent per device, summed per kind."""
    records = getattr(records, "records", records)
    out: dict = defaultdict(lambda: {"count": 0, "bytes": 0})
    for kind, b in records:
        out[kind]["count"] += 1
        out[kind]["bytes"] += b
    return dict(out)


def collective_bytes(records) -> int:
    """Total bytes this device put on the wire."""
    return int(sum(v["bytes"] for v in parse_collectives(records).values()))
