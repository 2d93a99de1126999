"""Tracing and timing hooks: name the phases, time the rounds (port of
``repro/obs/trace.py``).

* :func:`annotate` — a ``torch.profiler.record_function`` range (host
  timeline of a ``torch.profiler`` capture) plus an NVTX range on the
  card, named with the DEPOSITUM phase vocabulary below.
* :class:`RoundTimer` / :func:`time_fn` — wall-clock timing that separates
  **blocked** time (each call waited for: ``torch.cuda.synchronize`` on
  the result's device) from **dispatch** time (issue only: the host's
  share of an asynchronous queue).
* :func:`profile_capture` — opt-in ``torch.profiler`` capture around a
  block, written as a Chrome trace into a directory.  Gated by an explicit
  flag (or ``REPRO_PROFILE_DIR``) because captures are large.

Metrics, records and sinks: :mod:`repro_torch.obs.metrics`,
:mod:`repro_torch.obs.record` and :mod:`repro_torch.obs.sinks`.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

#: DEPOSITUM phase names used by the in-tree annotations.
PHASES = ("local_step", "gossip", "compress_pack", "compress_unpack",
          "fused_kernel", "telemetry")


@contextlib.contextmanager
def annotate(name: str):
    """Name a code region for profiler traces (host range + NVTX range)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _tensors(value: Any):
    """Every tensor of a value: a tensor, a NamedTuple / tuple / list / dict
    tree of them (a ``DepositumState`` included), or anything else (none)."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _tensors(v)


def block_until_ready(value: Any) -> Any:
    """Wait for the work behind ``value``: synchronise each CUDA device
    its tensors live on (CPU tensors are ready when returned)."""
    devices = {t.device for t in _tensors(value) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return value


class Timing(NamedTuple):
    """Per-iteration wall times in microseconds."""

    blocked_us: float   # every iteration waited for — the honest one
    dispatch_us: float  # issue-only loop, one final wait (async queue cost)


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 3
            ) -> Timing:
    """Time ``fn(*args)``: blocked per iteration, then dispatch only."""
    for _ in range(warmup):
        block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        block_until_ready(fn(*args))
    blocked = (time.perf_counter() - t0) / iters * 1e6
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args)
    dispatch = (time.perf_counter() - t0) / iters * 1e6
    block_until_ready(out)  # drain before the next measurement starts
    return Timing(blocked, dispatch)


class RoundTimer:
    """Accumulates blocked vs dispatch wall time across training rounds.

    Usage inside a host round loop::

        timer = RoundTimer()
        for r in range(rounds):
            with timer.round():
                state, aux = round_fn(state, batches)   # dispatch
        timer.block_on(state)                           # drain once

    ``round()`` times the host's issue of one round; :meth:`block_on`
    waits for a final value (``torch.cuda.synchronize`` on the devices of
    its tensors) and attributes the wait to blocked time.
    """

    def __init__(self):
        self.rounds = 0
        self.dispatch_s = 0.0
        self.blocked_s = 0.0

    @contextlib.contextmanager
    def round(self):
        t0 = time.perf_counter()
        yield
        self.dispatch_s += time.perf_counter() - t0
        self.rounds += 1

    def block_on(self, value) -> None:
        t0 = time.perf_counter()
        block_until_ready(value)
        self.blocked_s += time.perf_counter() - t0

    def timing(self) -> Timing:
        """Mean per-round Timing; blocked = dispatch + wait, amortised."""
        n = max(1, self.rounds)
        dispatch = self.dispatch_s / n * 1e6
        blocked = (self.dispatch_s + self.blocked_s) / n * 1e6
        return Timing(blocked, dispatch)

    def summary(self) -> dict:
        t = self.timing()
        return {"rounds": self.rounds,
                "blocked_us_per_round": t.blocked_us,
                "dispatch_us_per_round": t.dispatch_us}


@contextlib.contextmanager
def profile_capture(log_dir: Optional[str] = None, *,
                    enabled: Optional[bool] = None):
    """Opt-in ``torch.profiler`` capture around a block.

    Enabled when ``enabled=True``, or when ``enabled`` is None and the
    ``REPRO_PROFILE_DIR`` env var is set (its value is the default
    ``log_dir``).  Traces the host and, where a card is present, the
    device; on exit writes ``trace.json`` (Chrome trace format) into the
    directory.  Disabled, it is a no-op context — callers wrap their run
    loop unconditionally and flip the flag.
    """
    env_dir = os.environ.get("REPRO_PROFILE_DIR")
    if enabled is None:
        enabled = env_dir is not None
    if not enabled:
        yield None
        return
    target = log_dir or env_dir or "profile"
    os.makedirs(target, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield target
    prof.export_chrome_trace(os.path.join(target, "trace.json"))
