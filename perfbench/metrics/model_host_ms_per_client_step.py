"""Host time inside the program's ``model_step`` spans: the time to issue
one client's forward and backward (under the profiler's per-operator
cost), a client-step, in ms."""

from perfbench import spans


def read(ctx):
    v = spans.span(ctx, "model_step", "host_s")
    return None if v is None else 1e3 * v
