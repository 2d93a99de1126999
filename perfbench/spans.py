"""The program's own spans and counters over the traced rounds
(``repro_torch.obs.trace.STORE``): it holds one tracing session, so in a
benchmark run the ``--trace 1`` capture alone.

:func:`span` and :func:`counter` give None without a trace or from a
program that keeps no store, and a reader then reports nothing; otherwise
the sum over what was recorded (0 where nothing was), a client-step.
"""
from __future__ import annotations


def _store():
    """The program's store, or None from a program without one (a traced
    run reads the benchmark's newest readers on a parent checkout too)."""
    try:
        from repro_torch.obs.trace import STORE
    except ImportError:
        return None
    return STORE


def _per_client_step(ctx, total) -> float | None:
    t = ctx.get("trace")
    if not t or not t.get("client_steps"):
        return None
    store = _store()
    if store is None:
        return None
    return total(store) / t["client_steps"]


def span(ctx, name: str, key: str) -> float | None:
    """``key`` (a column of ``STORE.summary()``, such as "host_s") summed
    over the spans ``name``, a client-step of the traced rounds."""
    return _per_client_step(
        ctx, lambda store: store.summary().get(name, {}).get(key, 0.0))


def counter(ctx, name: str) -> float | None:
    """The counter ``name``, a client-step of the traced rounds."""
    return _per_client_step(ctx, lambda store: store.counters.get(name, 0))
