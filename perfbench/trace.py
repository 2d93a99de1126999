"""A ``torch.profiler`` window reduced to what the per-layer metrics read.

Device activity is every kernel, copy and set on the card; the program's
spans are its ``record_function`` ranges (``gossip`` around each mix,
``fused_kernel`` around each sweep launch).  A device operation belongs to
the span open on the host thread when the operator it links to ran.  A
kernel with no such operator (a library's own launches, such as the sweep
kernels' ctypes calls) is "unlinked"; readers find it by name.  Busy time is the union of the
device intervals; idle gaps are labelled by the host operator open at the
gap's middle.
"""
from __future__ import annotations

import bisect
import collections
import time

import torch
from torch.profiler import ProfilerActivity, profile

SPANS = ("gossip", "fused_kernel", "local_step")
GAPS_LABELLED = 400


def _kind(e) -> str | None:
    """"kernel" | "copy" | "set" for device activity, None otherwise (the
    device's copy of a span is the span's name: not an operation)."""
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return None
    name = e.name()
    if name.startswith("Memcpy"):
        return "copy"
    if name.startswith("Memset"):
        return "set"
    return None if name in SPANS else "kernel"


def capture(advance, n: int, cuda: bool = True) -> dict:
    """Profile ``advance()`` called ``n`` times (the window ends in a
    device synchronise); returns the reduced window.  ``cuda=False`` (the
    CPU tests) traces the host alone."""
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            advance()
        sync()
        wall = time.perf_counter() - t0
    return reduce(prof.profiler.kineto_results.events(), wall)


def reduce(events, wall_s: float) -> dict:
    spans = collections.defaultdict(list)    # thread -> [(start, end, name)]
    ops = {}                                 # operator id -> (t, thread)
    host = []                                # (start, end, name) cpu ops
    dev = []                                 # (start, end, name, kind, link)
    for e in events:
        kind = _kind(e)
        if kind is not None:
            s = e.start_ns()
            dev.append((s, s + e.duration_ns(), e.name(), kind,
                        e.linked_correlation_id()))
            continue
        if e.device_type() != torch.autograd.DeviceType.CPU:
            continue
        s, d, th = e.start_ns(), e.duration_ns(), e.start_thread_id()
        if e.name() in SPANS:
            spans[th].append((s, s + d, e.name()))
        ops[e.correlation_id()] = (s, th)
        host.append((s, s + d, e.name()))
    for th in spans:
        spans[th].sort()
    starts = {th: [s[0] for s in v] for th, v in spans.items()}

    def span_of(link) -> str:
        op = ops.get(link)
        if op is None:
            return "unlinked"
        t, th = op
        v = spans.get(th, [])
        i = bisect.bisect_right(starts.get(th, []), t)
        inner = "model"
        # spans do not nest across the program's names; the latest open wins
        for s, e, name in reversed(v[max(0, i - 8):i]):
            if s <= t <= e:
                inner = name
                break
        return inner

    by_layer = collections.Counter()
    by_name = collections.Counter()
    counts = collections.Counter()
    for s, e, name, kind, link in dev:
        layer = span_of(link)
        by_layer[layer] += (e - s) * 1e-9
        by_layer[f"{layer}.{kind}"] += (e - s) * 1e-9
        by_name[name] += (e - s) * 1e-9
        counts[kind] += 1
        counts[f"{layer}.{kind}"] += 1
    busy, gaps = _union([(s, e) for s, e, *_ in dev])
    return {
        "wall_s": wall_s,
        "busy_s": busy,
        "device_s": dict(by_layer),
        "by_name": dict(by_name),
        "counts": dict(counts),
        "device_ops": [[n[:120], v] for n, v in by_name.most_common(10)],
        "idle_gaps": _label_gaps(gaps, host),
    }


def _union(intervals):
    """(seconds covered, gaps [(start, end)] between covered runs)."""
    busy, gaps, cur = 0, [], None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            busy += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy * 1e-9, gaps


def _label_gaps(gaps, host):
    """[[host operator, idle seconds]] of the longest gaps, summed by the
    innermost host operator open at each gap's middle, top 10."""
    host.sort()
    starts = [h[0] for h in host]
    total = collections.Counter()
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_LABELLED]:
        mid = (s + e) // 2
        i = bisect.bisect_right(starts, mid)
        label = "no host operator"
        for hs, he, name in reversed(host[max(0, i - 4000):i]):
            if hs <= mid <= he:
                label = name
                break
        total[label[:120]] += (e - s) * 1e-9
    return [[k, v] for k, v in total.most_common(10)]
