"""Host time inside the program's ``moe`` spans (the routed half of each
DeepSeekMoE layer: route, dispatch, the held experts' grouped products,
combine; forward, recompute and backward halves), a client-step, in ms.
Nothing where the model holds no experts."""

from perfbench import spans


def read(ctx):
    m = ctx.get("model")
    if not m or not m.get("experts_held"):
        return None
    v = spans.span(ctx, "moe", "host_s")
    return None if v is None else 1e3 * v
