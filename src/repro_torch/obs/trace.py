"""Tracing and timing hooks: the program's spans and counters, and round
timers (port of ``repro/obs/trace.py``).

* :func:`annotate` / :func:`layer` / :func:`recomputed` — a span: a host
  range in the active ``torch.profiler`` (on the trace's clock, with no
  device-side copy but for ``fused_kernel``'s) and a row of the in-memory
  :data:`STORE`.
  :func:`layer` also records the span's backward half, from gradient hooks
  at its output and its inputs (no autograd node is added: the gradients
  are the same bits).  Every span name is a key of :data:`SPANS`.
* :func:`count` — the counters of :data:`COUNTERS`.
* :class:`RoundTimer` / :func:`time_fn` — wall-clock timing that separates
  **blocked** time (each call waited for: ``torch.cuda.synchronize`` on
  the result's device) from **dispatch** time (issue only: the host's
  share of an asynchronous queue).
* :func:`profile_capture` — opt-in ``torch.profiler`` capture around a
  block, written as a Chrome trace into a directory.  Gated by an explicit
  flag (or ``REPRO_PROFILE_DIR``) because captures are large.

Spans and counters record only while tracing is :func:`on`: while a
``torch.profiler.profile`` or ``torch.autograd.profiler.emit_nvtx`` is
active (the latter turns every range into an NVTX range for Nsight), or
inside :func:`recording`.  Off, a span site costs that one check.  The
store holds one tracing session: it is emptied at the first span site
after tracing turns on, and keeps at most :attr:`SpanStore.CAPACITY`
spans.  A row is a few machine integers, so recording makes no Python
objects for the collector to walk.  Device times come from pooled CUDA
timing events, taken only inside :func:`recording` (under a profiler the
window is host-bound and the trace has the device's own times) and
resolved when the store is read, so recording adds no host
synchronisation.

Metrics, records and sinks: :mod:`repro_torch.obs.metrics`,
:mod:`repro_torch.obs.record` and :mod:`repro_torch.obs.sinks`.
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from array import array
from typing import Any, Callable, NamedTuple, Optional

import torch

#: every span the program records -> what it covers
SPANS = {
    "round": "one trainer round (FederatedTrainer.run's loop body)",
    "round.batch": "next(batch_iter): the round's batches",
    "round.program": "the client take (a view) and local_then_comm_round: "
                     "the round's DEPOSITUM steps",
    "round.log": "the history record and client_mean_loss's readback",
    "run.sync": "the synchronise at the end of each run() call",
    "model_step": "one client's forward and backward and the copy of its "
                  "gradients into the stacked tree (launch/steps.py)",
    "grad_copy": "the copy of one client's gradients into the stacked tree",
    "block": "one decoder block of a training forward, its remat "
             "checkpoint's set-up included, and its backward half",
    "remat": "a remat checkpoint's recompute of a block (in the backward "
             "half of the block's last layer)",
    "attention": "a decoder block's attention_train: QKV projections, "
                 "qk-norm, RoPE, the scores or flash, the output projection",
    "mlp": "the feed-forward mlp() of a dense block",
    "mla": "multi-head latent attention's projections inside attention: "
           "q, the compressed KV and its norm, the per-head keys and "
           "values, YaRN RoPE on the RoPE parts",
    "moe": "the routed half of a DeepSeekMoE layer (expert_share): route, "
           "dispatch, the held experts, combine",
    "moe.route": "the fp32 router over all experts and the greedy top-k",
    "moe.dispatch": "the (token, expert) rows sorted by held expert on the "
                    "device, the group offsets, the rows' inputs gathered",
    "moe.experts": "the held experts' three grouped products and SwiGLU",
    "moe.combine": "the rows weighted by their gates and summed per token",
    "shared_expert": "a DeepSeekMoE layer's shared experts (one SwiGLU)",
    "loss_head": "the transformer's final norm and the head's logits",
    "ce": "the fp32 cross-entropy of the logits (every family)",
    "local_step": "the unfused momentum / prox / tracking updates",
    "gossip": "one mix of a tree",
    "fused_kernel": "one grouped sweep launch with its tables",
    "compress_pack": "a compressed payload's packing",
    "compress_unpack": "a compressed payload's unpacking",
    "telemetry": "the recorder's device writes and host copies",
}

#: every counter the program keeps -> what it counts
COUNTERS = {
    "cast_bytes": "bytes read plus written by the model's explicit floating "
                  "dtype conversions that change the dtype (forward and "
                  "recompute; autograd's backward casts are not counted)",
}

#: a span's phase: "recompute" is a forward inside a backward pass (remat)
PHASES = ("forward", "backward", "recompute")
_FORWARD, _BACKWARD, _RECOMPUTE = range(3)
_NAMES = tuple(SPANS)
_CODE = {n: i for i, n in enumerate(_NAMES)}

_profiler_enabled = torch.autograd._profiler_enabled
_in_backward = torch._C._current_autograd_node
_HostRange = torch._C._profiler._RecordFunctionFast
#: spans kept on ``record_function``, a user annotation (kineto copies it to
#: the device, and ``perfbench/trace.py`` drops the copy by name): inside
#: ``fused_kernel`` no host operator is then open when the sweep kernels
#: launch through ctypes, so their launches stay unlinked, as the
#: benchmark's ``model_ms_per_client_step`` reader assumes (it finds them
#: by name).  A ``_HostRange`` would link them to the span.
_USER_RANGES = frozenset({"fused_kernel"})
_UserRange = torch.autograd.profiler.record_function
_recording = 0      # depth of open recording() contexts
_session = False    # whether tracing was on at the last check
_HALVES: dict = {}  # layer name -> its _Halves
_OPEN: list = []    # backward halves open now


def on() -> bool:
    """Whether spans and counters record now.  The first check after
    tracing turns on starts a new session: the store is emptied."""
    global _session
    now = _recording > 0 or _profiler_enabled()
    if now is not _session:
        _session = now
        if now:
            STORE.reset()
    return now


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block without a profiler
    (none of its per-operator cost), with device times on a card; yields
    :data:`STORE`.  Entered with tracing off, it starts a new session."""
    global _recording, _session
    if not _recording and not _profiler_enabled():
        _session = False        # a new session starts at the first check
    _recording += 1
    try:
        yield STORE
    finally:
        _recording -= 1


class Span(NamedTuple):
    """One recorded span, as :meth:`SpanStore.spans` gives it: ``parent``
    is the index of its parent span or None; ``t0`` / ``t1`` are host
    ``perf_counter_ns`` (``t1`` None while open)."""

    name: str
    phase: str
    parent: Optional[int]
    t0: int
    t1: Optional[int]


class SpanStore:
    """Spans and counters of one tracing session, in memory, read once at
    the end.  A span is a row of flat integer columns; its parent is the
    span open on the same thread (for a backward half, the span that ran
    the backward)."""

    CAPACITY = 1 << 21      # spans a session keeps; later ones are dropped

    def __init__(self):
        self._lock = threading.Lock()
        self._pool: list = []           # CUDA timing events, reused
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter (their events return to the
        pool)."""
        with self._lock:
            self._name, self._phase = array("b"), array("b")
            self._parent, self._ev = array("q"), array("q")
            self._t0, self._t1 = array("q"), array("q")
            self._used = 0              # pooled events handed out
            self._stacks: dict = {}     # thread -> [open span index]
            self._ranges: dict = {}     # thread -> [their host ranges]
            self.counters: collections.Counter = collections.Counter()
            self.dropped = 0
            for halves in _HALVES.values():
                halves.clear()
            _OPEN.clear()

    def __len__(self) -> int:
        return len(self._name)

    def _thread(self):
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if stack is None:
            stack = self._stacks[tid] = []
            self._ranges[tid] = []
        return stack, self._ranges[tid]

    def top(self) -> int:
        """The innermost span open on this thread, or -1."""
        stack = self._stacks.get(threading.get_ident())
        return stack[-1] if stack else -1

    def parent(self, i: int) -> int:
        return self._parent[i] if i >= 0 else -1

    def open(self, name: str, phase: int = -1, parent: int = -1) -> int:
        """Open ``name`` on this thread; returns its index (-1 when the
        session is full).  Its parent is the span open on this thread,
        else ``parent``; its phase ``phase``, else "recompute" inside a
        backward pass and "forward" outside one."""
        code = _CODE[name]
        stack, ranges = self._thread()
        if stack and stack[-1] >= 0:
            parent = stack[-1]
        if phase < 0:
            phase = _RECOMPUTE if _in_backward() is not None else _FORWARD
        rng = (_UserRange if name in _USER_RANGES else _HostRange)(name)
        rng.__enter__()
        with self._lock:
            i = len(self._name)
            if i >= self.CAPACITY:
                self.dropped += 1
                i = -1
            else:
                ev = -1
                if _recording and torch.cuda.is_initialized():
                    ev = self._events()
                self._name.append(code)
                self._phase.append(phase)
                self._parent.append(parent)
                self._ev.append(ev)
                self._t1.append(0)
                self._t0.append(time.perf_counter_ns())
                if ev >= 0:
                    self._pool[ev].record()
        stack.append(i)
        ranges.append(rng)
        return i

    def _events(self) -> int:
        """Index of a free pair of pooled timing events."""
        e = self._used
        self._used += 2
        while len(self._pool) < self._used:
            self._pool.append(torch.cuda.Event(enable_timing=True))
        return e

    def close(self, i: int) -> None:
        """Close span ``i`` and any span still open above it on the
        thread that opened it."""
        tid = threading.get_ident()
        stack = self._stacks.get(tid)
        if not stack or i not in stack:
            for tid, stack in list(self._stacks.items()):
                if i in stack:
                    break
            else:
                return
        ranges = self._ranges[tid]
        while stack:
            j = stack.pop()
            if j >= 0:
                self._end(j)
            ranges.pop().__exit__(None, None, None)
            if j == i:
                break

    def close_top(self, name: str) -> None:
        """Close the innermost span ``name`` open on this thread."""
        stack = self._stacks.get(threading.get_ident())
        code = _CODE[name]
        for j in reversed(stack or ()):
            if j < 0 or self._name[j] == code:
                self.close(j)
                return

    def _end(self, i: int) -> None:
        ev = self._ev[i]
        if ev >= 0:
            self._pool[ev + 1].record()
        self._t1[i] = time.perf_counter_ns()

    def count(self, name: str, n: int) -> None:
        if name not in COUNTERS:
            raise KeyError(f"counter {name!r} is not in the counter table")
        with self._lock:
            self.counters[name] += n

    def spans(self) -> list[Span]:
        """Every recorded span, in the order they opened."""
        return [Span(_NAMES[c], PHASES[p], q if q >= 0 else None, a,
                     b or None)
                for c, p, q, a, b in zip(self._name, self._phase,
                                         self._parent, self._t0, self._t1)]

    def _resolve(self) -> list:
        """Each span's device (start, end) in ms from the session's first
        event, or None."""
        n = len(self._name)
        out = [None] * n
        timed = [i for i in range(n) if self._ev[i] >= 0 and self._t1[i]]
        if timed:
            torch.cuda.synchronize()
            base = self._pool[self._ev[timed[0]]]
            for i in timed:
                e = self._ev[i]
                out[i] = (base.elapsed_time(self._pool[e]),
                          base.elapsed_time(self._pool[e + 1]))
        return out

    def summary(self, by_phase: bool = False) -> dict:
        """Span name (``name:phase`` with ``by_phase``) -> ``count``,
        ``host_s`` and ``self_host_s`` (inclusive host seconds, and less
        what its child spans cover, so no interval counts in two spans),
        and ``device_s`` and ``self_device_s`` the same on the stream's
        clock: the time between the span's events, its work and any idle
        time inside it.  Device times are 0 for spans recorded without
        events (no card, or a profiler without :func:`recording`).  Open
        spans are left out."""
        dev = self._resolve()
        n = len(self._name)
        host_kids = collections.defaultdict(list)
        dev_kids = collections.defaultdict(list)
        for i in range(n):
            q = self._parent[i]
            if q >= 0 and self._t1[i]:
                host_kids[q].append((self._t0[i], self._t1[i]))
                if dev[i] is not None:
                    dev_kids[q].append(dev[i])
        out: dict = {}
        for i in range(n):
            if not self._t1[i]:
                continue
            name = _NAMES[self._name[i]]
            key = f"{name}:{PHASES[self._phase[i]]}" if by_phase else name
            row = out.setdefault(key, {"count": 0, "host_s": 0.0,
                                       "self_host_s": 0.0, "device_s": 0.0,
                                       "self_device_s": 0.0})
            s, e = self._t0[i], self._t1[i]
            row["count"] += 1
            row["host_s"] += (e - s) * 1e-9
            row["self_host_s"] += (e - s - _covered(host_kids.get(i, ()),
                                                    s, e)) * 1e-9
            if dev[i] is not None:
                s, e = dev[i]
                row["device_s"] += (e - s) * 1e-3
                row["self_device_s"] += (e - s - _covered(
                    dev_kids.get(i, ()), s, e)) * 1e-3
        return out


def _covered(intervals, s: float, e: float) -> float:
    """Length of the union of ``intervals`` clipped to [s, e]."""
    total, end = 0.0, s
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, e)
        if b > a:
            total += b - a
            end = b
    return total


#: the process's span store
STORE = SpanStore()


class _Scope:
    """The context manager of one span name (one object a name: a span's
    index lives on the store's per-thread stack)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        STORE.open(self.name)

    def __exit__(self, *exc):
        STORE.close_top(self.name)


_SCOPES = {name: _Scope(name) for name in SPANS}
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A span around a block: ``with annotate("gossip"): ...``."""
    if not on():
        return _OFF
    return _SCOPES[name]


def recomputed(fn: Callable) -> Callable:
    """``fn`` whose calls inside a backward pass (a remat checkpoint's
    recompute) run in span ``remat``; other calls are ``fn``'s own."""
    def wrapped(*args, **kwargs):
        if not on() or _in_backward() is None:
            return fn(*args, **kwargs)
        with _SCOPES["remat"]:
            return fn(*args, **kwargs)

    return wrapped


class _Halves:
    """The backward halves of one :func:`layer` name.  A forward call
    pushes its span and input count; a half opens when the gradient
    reaches the output (a pre-hook of the output's autograd node), taking
    the latest pushed call (a backward pass meets them in reverse), and
    closes when its inputs' gradients are done (tensor hooks).  Its parent
    is the span open on the autograd thread, else the forward span's
    parent.  A half whose inputs' gradients never come (``autograd.grad``
    pruned them) closes when the next half under the same parent opens,
    or when the backward pass ends.  One object a name, so a call adds
    two hook registrations and no closure; the halves of backward passes
    that run at once (the threaded async runtime's clients) mix."""

    __slots__ = ("name", "calls", "inputs", "half", "waiting",
                 "begin_hook", "end_hook")

    def __init__(self, name: str):
        self.name = name
        self.calls: list = []           # forward span indexes, pushed
        self.inputs: list = []          # their tensor input counts
        self.half, self.waiting = -1, 0
        self.begin_hook, self.end_hook = self.begin, self.end

    def clear(self) -> None:
        self.calls.clear()
        self.inputs.clear()
        self.half, self.waiting = -1, 0

    def push(self, fwd: int, inputs: int) -> None:
        self.calls.append(fwd)
        self.inputs.append(inputs)

    def begin(self, grad) -> None:
        if not self.calls:
            return
        fwd, self.waiting = self.calls.pop(), self.inputs.pop()
        parent = STORE.top()
        if parent < 0:
            parent = STORE.parent(fwd)
        for h in _OPEN:
            if STORE.parent(h) == parent:
                _close_half(h)
                break
        self.half = STORE.open(self.name, _BACKWARD, parent)
        _OPEN.append(self.half)
        torch.autograd.Variable._execution_engine.queue_callback(
            _end_of_backward)

    def end(self, grad) -> None:
        self.waiting -= 1
        if self.waiting == 0 and self.half in _OPEN:
            _close_half(self.half)


def _close_half(h: int) -> None:
    try:
        _OPEN.remove(h)
    except ValueError:          # closed already, by a pass on another thread
        return
    STORE.close(h)
    for halves in _HALVES.values():
        if halves.half == h:
            halves.half = -1


def _end_of_backward() -> None:
    """Close the halves a backward pass left open."""
    while _OPEN:
        _close_half(_OPEN[-1])


def layer(name: str, fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` in span ``name``.  While tracing is on and
    grad is enabled, outside a recompute, gradient hooks on the tensor
    arguments that require grad and on the tensor output (the first of a
    tuple) record the span's backward half; they leave the gradients as
    they are."""
    if not on():
        return fn(*args, **kwargs)
    i = STORE.open(name)
    try:
        out = fn(*args, **kwargs)
        y = out[0] if isinstance(out, tuple) and out else out
        if (torch.is_grad_enabled() and isinstance(y, torch.Tensor)
                and y.grad_fn is not None and _in_backward() is None):
            ins = [a for a in args
                   if isinstance(a, torch.Tensor) and a.requires_grad]
            if ins:
                halves = _HALVES.get(name)
                if halves is None:
                    halves = _HALVES[name] = _Halves(name)
                halves.push(i, len(ins))
                y.grad_fn.register_prehook(halves.begin_hook)
                for a in ins:
                    a.register_hook(halves.end_hook)
        return out
    finally:
        STORE.close(i)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if on():
        STORE.count(name, n)


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
