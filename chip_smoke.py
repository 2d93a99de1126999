#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
final line):

1. build the CUDA kernels of the training path from
   ``src/repro_torch/kernels/prox/csrc`` with ``nvcc`` (into ``build/``);
2. hold each kernel against its plain PyTorch version on the card: all
   three prox kinds, gated and ungated, S = 3 configs x C = 10 clients, an
   odd d (scalar loads) and a d that is a multiple of 4 (float4 loads), plus
   bf16 storage; frozen rows must match bit for bit, live rows within
   ``ATOL`` / ``RTOL``;
3. run the main path — ``ROUNDS`` DEPOSITUM rounds of the paper's Fig. 4
   MLP (123 -> 64 -> 32 -> 10, 10 clients on a ring, T0 = 10, MCP prox)
   through ``repro_torch.quickstart.run_depositum`` with ``fused="require"``
   — and check that each kernel launched exactly rounds x T0 x 6 leaves
   times, that stationarity fell from round 1, and that the run matches
   the same run with ``fused="off"``: one round within ``STEP_ATOL`` /
   ``STEP_RTOL``, all rounds within ``STATE_REL`` (model, relative norm)
   and ``LOSS_RTOL`` / ``STAT_RTOL``;
4. time each kernel (CUDA events) against its plain version and its byte
   bound, at the main path's shapes and at one bandwidth-bound shape, and
   the round wall time fused and unfused.

Prints JSON lines per phase, then the card's name and power limit (from
``nvidia-smi``), then one ``{"kernels": [...]}`` line, then as the last
line ``{"ok": true, "device": {...}}``.  Exits non-zero with no result
when CUDA is unavailable or the port's sources are not beside the script.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

ROUNDS = 30
LEAVES = 6                     # l0.w l0.b l1.w l1.b l2.w l2.b
ATOL, RTOL = 1e-6, 1e-6        # kernel vs plain, fp32: same ops, same order
BF16_ATOL, BF16_RTOL = 1e-2, 1e-2   # one bf16 rounding of an fp32 result
# Fused vs unfused on the card.  Per step the two differ by about an ulp:
# PyTorch's CUDA division by a CPU scalar (the unfused MCP prox) multiplies
# by the reciprocal, the kernel divides.  Over one round that stays at the
# ulp scale; over 300 steps of a non-convex problem the difference grows,
# so the long run is held by the model's relative norm and the metrics.
STEP_ATOL, STEP_RTOL = 1e-6, 1e-5   # one round (10 steps)
STATE_REL = 5e-2               # 300 steps: ||x_fused - x_unfused|| / ||x||
LOSS_RTOL, STAT_RTOL = 1e-3, 1e-2   # 300 steps: final loss, stationarity
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32, outside the tensor cores
# flops per element: update = momentum (3) + shift (2) + prox chain (<= 8)
UPDATE_FLOPS, TRACKING_FLOPS = 13, 3
KERNEL_SOURCE = "src/repro_torch/kernels/prox/csrc/prox_sweep.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_build() -> dict:
    from repro_torch.kernels.prox import kernel
    t0 = time.perf_counter()
    path = kernel.build_library()
    kernel._lib()
    return {"phase": "build", "library": str(path.relative_to(ROOT)),
            "seconds": time.perf_counter() - t0}


def _operands(S, C, d, dtype, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = lambda: (torch.randn((S, C, d), generator=g, device="cuda")
                  * 0.1).to(dtype)
    return mk(), mk(), mk()


def _table(S):
    from repro_torch.kernels.prox.kernel import sweep_params_table
    import torch
    return sweep_params_table(
        lam=torch.tensor([1e-3, 5e-3, 1e-2])[:S], theta=4.0,
        alpha=torch.tensor([0.05, 0.1, 0.2])[:S],
        gamma=torch.tensor([0.0, 0.5, 0.9])[:S],
        beta=torch.tensor([1.0, 0.5, 1.5])[:S], device="cuda")


def phase_check() -> dict:
    """Each kernel against its plain version; returns the worst errors."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    S, C = 3, 10
    params = _table(S)
    mask = (torch.rand((S, C), generator=torch.Generator().manual_seed(5))
            > 0.4).to(torch.float32)
    mask[1] = 0.0                      # one all-frozen config
    mask = mask.cuda()
    worst = {"fused_update_sweep": 0.0, "fused_tracking_sweep": 0.0}
    cases = 0

    def close(name, out, ref, dtype):
        atol, rtol = ((ATOL, RTOL) if dtype == torch.float32
                      else (BF16_ATOL, BF16_RTOL))
        torch.testing.assert_close(out, ref, atol=atol, rtol=rtol,
                                   msg=lambda m: f"{name}: {m}")
        if dtype == torch.float32:
            err = float((out - ref).abs().max()) if out.numel() else 0.0
            worst[name] = max(worst[name], err)

    for dtype, ds in ((torch.float32, (1001, 1024, 1)),
                      (torch.bfloat16, (333,))):
        for d in ds:
            for gated in (False, True):
                m = mask if gated else None
                x, y, nu = _operands(S, C, d, dtype, seed=d)
                for kind in ("l1", "mcp", "scad"):
                    xo, nuo = K.fused_update_sweep_cuda(x, y, nu, params, m,
                                                        kind=kind)
                    xr, nur = K.fused_update_sweep_plain(x, y, nu, params, m,
                                                         kind=kind)
                    torch.cuda.synchronize()
                    close("fused_update_sweep", xo, xr, dtype)
                    close("fused_update_sweep", nuo, nur, dtype)
                    if gated:
                        frozen = mask <= 0
                        assert bits_equal(xo[frozen], x[frozen]), kind
                        assert bits_equal(nuo[frozen], nu[frozen]), kind
                    cases += 1
                yo, gk = K.fused_tracking_sweep_cuda(y, nu, x, params, m)
                yr, gr = K.fused_tracking_sweep_plain(y, nu, x, params, m)
                torch.cuda.synchronize()
                close("fused_tracking_sweep", yo, yr, dtype)
                assert bits_equal(gk, gr)
                if gated:
                    frozen = mask <= 0
                    assert bits_equal(yo[frozen], y[frozen])
                    assert bits_equal(gk[frozen], x[frozen])
                cases += 1
    return {"phase": "check", "cases": cases,
            "max_abs_err": worst, "atol": ATOL, "rtol": RTOL,
            "bf16_atol": BF16_ATOL, "bf16_rtol": BF16_RTOL}


def phase_main_path() -> tuple[dict, dict]:
    import torch
    from repro_torch.convert import state_to_numpy
    from repro_torch.kernels.prox.kernel import (LAUNCH_COUNTS,
                                                 reset_launch_counts)
    from repro_torch.quickstart import mlp_config, run_depositum

    cfg = mlp_config(ROUNDS, fused="require")
    reset_launch_counts()
    state, curves = run_depositum(cfg, metrics_every=ROUNDS, device="cuda")
    torch.cuda.synchronize()
    launches = {"fused_update_sweep": LAUNCH_COUNTS["fused_sweep"],
                "fused_tracking_sweep": LAUNCH_COUNTS["tracking_sweep"]}
    want = ROUNDS * cfg.depositum.comm_period * LEAVES
    for name, n in launches.items():
        if n != want:
            raise AssertionError(f"{name} launched {n} times, want {want}")

    off_cfg = mlp_config(ROUNDS, fused="off")
    reset_launch_counts()
    ref_state, ref_curves = run_depositum(off_cfg, metrics_every=ROUNDS,
                                          device="cuda")
    torch.cuda.synchronize()
    if sum(LAUNCH_COUNTS.values()) != 0:
        raise AssertionError("fused='off' launched a kernel")
    for f in ("x", "y", "nu", "g"):
        for k, v in getattr(state, f).items():
            if v.shape != getattr(ref_state, f)[k].shape \
                    or not torch.isfinite(v).all():
                raise AssertionError(f"state.{f}[{k}] bad shape or values")
    # one round: the two paths do the same fp32 operations per step
    one = {m: run_depositum(mlp_config(1, fused=m), collect_metrics=False,
                            device="cuda")[0] for m in ("require", "off")}
    one_diff = _state_diff(one["require"], one["off"])
    _assert_states_close(one["require"], one["off"], STEP_ATOL, STEP_RTOL)
    # ROUNDS rounds: the model by relative norm, the metrics relatively
    rel = _rel_l2(state, ref_state)
    if max(rel["x"].values()) > STATE_REL:
        raise AssertionError(f"fused vs unfused x drifted: {rel['x']}")
    for key, tol in (("loss", LOSS_RTOL), ("stationarity", STAT_RTOL)):
        a, b = curves[key][-1], ref_curves[key][-1]
        if not abs(a - b) <= tol * abs(b):
            raise AssertionError(f"fused vs unfused {key}: {a} vs {b}")
    again, _ = run_depositum(cfg, collect_metrics=False, device="cuda")
    drift = {"fused_vs_unfused_max_abs": _state_diff(state, ref_state),
             "fused_vs_unfused_rel_l2": rel,
             "fused_rerun_max_abs": _state_diff(state, again),
             "one_round_fused_vs_unfused_max_abs": one_diff}
    s = curves["stationarity"]
    if not (s[-1] < s[0]):
        raise AssertionError(f"stationarity did not fall: {s}")
    n_params = sum(v[0].numel() for v in state.x.values())
    assert state_to_numpy(state)["t"] == ROUNDS * cfg.depositum.comm_period
    return launches, {
        "phase": "main_path", "rounds": ROUNDS,
        "clients": cfg.n_clients, "params_per_client": n_params,
        "launches": launches, "want_launches": want,
        "stationarity_round1": s[0], "stationarity_last": s[-1],
        "accuracy_last": curves["accuracy"][-1],
        "loss_last": curves["loss"][-1],
        "ref_stationarity_last": ref_curves["stationarity"][-1],
        "loss_last_unfused": ref_curves["loss"][-1],
        **drift, "step_atol": STEP_ATOL, "step_rtol": STEP_RTOL,
        "state_rel": STATE_REL, "loss_rtol": LOSS_RTOL,
        "stationarity_rtol": STAT_RTOL}


def _state_diff(a, b) -> dict:
    """Max |a - b| per state variable (0.0 means bit-equal values)."""
    return {f: max(float((v - getattr(b, f)[k]).abs().max())
                   for k, v in getattr(a, f).items())
            for f in ("x", "y", "nu", "g")}


def _rel_l2(a, b) -> dict:
    """||a - b|| / ||b|| per leaf and state variable."""
    import torch
    return {f: {k: float(torch.linalg.vector_norm(v - getattr(b, f)[k])
                         / torch.linalg.vector_norm(getattr(b, f)[k]))
                for k, v in getattr(a, f).items()}
            for f in ("x", "y", "nu", "g")}


def _assert_states_close(a, b, atol, rtol) -> None:
    import torch
    for f in ("x", "y", "nu", "g"):
        for k, v in getattr(a, f).items():
            torch.testing.assert_close(v, getattr(b, f)[k], atol=atol,
                                       rtol=rtol, msg=lambda m: f"{f}.{k}: {m}")


def _bound_ms(n_elem: int, bytes_per_elem: int, flops_per_elem: int):
    t_bytes = n_elem * bytes_per_elem / HBM_BYTES_PER_S * 1e3
    t_ops = n_elem * flops_per_elem / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _time_pair(fn_kernel, fn_plain, outs_equal):
    """Kernel and plain times in turns (plain, kernel, kernel, plain)."""
    p1 = time_ms(fn_plain)
    k1 = time_ms(fn_kernel)
    k2 = time_ms(fn_kernel)
    p2 = time_ms(fn_plain)
    return min(k1, k2), min(p1, p2), outs_equal()


def phase_timing() -> dict:
    """Kernel vs plain times at the main path's shapes (one step: the six
    leaves, S = 1, C = 10) and at a bandwidth-bound shape."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.models.classifier import MLP

    out = {}
    shapes = {"main_path_step": [(1, 10, p.numel()) for _, p in
                                 sorted(MLP(123, 10).named_parameters())],
              "bandwidth": [(4, 16, 1 << 20)]}
    for label, leaf_shapes in shapes.items():
        S = leaf_shapes[0][0]
        params = _table(S) if S <= 3 else K.sweep_params_table(
            1e-4, 4.0, 0.05, 0.8, 0.5, device="cuda").expand(S, 5).contiguous()
        leaves = [_operands(*s, torch.float32, seed=i)
                  for i, s in enumerate(leaf_shapes)]
        n_elem = sum(s[0] * s[1] * s[2] for s in leaf_shapes)

        def run(fn):
            return [fn(x, y, nu) for x, y, nu in leaves]

        upd_k = lambda: run(lambda x, y, nu: K.fused_update_sweep_cuda(
            x, y, nu, params, kind="mcp"))
        upd_p = lambda: run(lambda x, y, nu: K.fused_update_sweep_plain(
            x, y, nu, params, kind="mcp"))
        trk_k = lambda: run(lambda x, y, nu: K.fused_tracking_sweep_cuda(
            x, y, nu, params))
        trk_p = lambda: run(lambda x, y, nu: K.fused_tracking_sweep_plain(
            x, y, nu, params))

        def max_err(fk, fp):
            """Worst |kernel - plain| at these shapes, held to ATOL / RTOL."""
            def err():
                a, b = fk(), fp()
                for pa, pb in zip(a, b):
                    for u, v in zip(pa, pb):
                        torch.testing.assert_close(
                            u, v, atol=ATOL, rtol=RTOL,
                            msg=lambda m: f"{label} timing shapes: {m}")
                return max(float((u - v).abs().max())
                           for pa, pb in zip(a, b) for u, v in zip(pa, pb))
            return err

        uk, up, ue = _time_pair(upd_k, upd_p, max_err(upd_k, upd_p))
        tk, tp, te = _time_pair(trk_k, trk_p, max_err(trk_k, trk_p))
        ub, uby = _bound_ms(n_elem, 5 * 4, UPDATE_FLOPS)
        tb, tby = _bound_ms(n_elem, 4 * 4, TRACKING_FLOPS)
        out[label] = {
            "leaf_shapes": leaf_shapes, "launches_per_call": len(leaf_shapes),
            "fused_update_sweep": {"ms": uk, "plain_ms": up, "bound_ms": ub,
                                   "bound_by": uby, "max_abs_err": ue},
            "fused_tracking_sweep": {"ms": tk, "plain_ms": tp,
                                     "bound_ms": tb, "bound_by": tby,
                                     "max_abs_err": te}}
    return {"phase": "timing", **out}


def phase_round_time() -> dict:
    """Round wall time (host clock, synchronised), fused and unfused, in
    turns (fused, off, off, fused); no metrics inside the timed loop."""
    from repro_torch.quickstart import mlp_config, run_depositum
    walls = {"require": [], "off": []}
    for mode in ("require", "off", "off", "require"):
        _, curves = run_depositum(mlp_config(ROUNDS, fused=mode),
                                  collect_metrics=False, device="cuda")
        walls[mode].append(curves["wall_s"] / ROUNDS * 1e3)
    return {"phase": "round_time", "rounds": ROUNDS,
            "round_ms_fused": walls["require"],
            "round_ms_unfused": walls["off"]}


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found beside the "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = time.perf_counter()
    emit(phase_build())
    check = phase_check()
    emit(check)
    launches, main_path = phase_main_path()
    emit(main_path)
    timing = phase_timing()
    emit(timing)
    emit(phase_round_time())

    step = timing["main_path_step"]
    replaces = {"fused_update_sweep": "src/repro/kernels/prox/kernel.py:267",
                "fused_tracking_sweep": "src/repro/kernels/prox/kernel.py:296"}
    kernels = []
    for name, where in replaces.items():
        t = step[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": where, "launches": launches[name],
            "max_abs_err": max(check["max_abs_err"][name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
