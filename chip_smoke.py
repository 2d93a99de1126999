#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
final line):

1. build the CUDA kernels from the repo's sources with ``nvcc`` (into
   each kernel's ``build/``): ``kernels/prox/csrc/prox_sweep.cu`` and
   ``kernels/flash_attention/csrc/flash_fwd.cu``, both ``nvcc`` runs started
   together;
2. hold each kernel against its plain PyTorch version on the card:
   * the sweep-major pair: all three prox kinds, gated and ungated, S = 3
     configs x C = 10 clients, an odd d (scalar loads) and a d that is a
     multiple of 4 (float4 loads), plus bf16 storage; frozen rows bit for
     bit, live rows within ``ATOL`` / ``RTOL``;
   * ``prox_cuda`` and ``fused_update_cuda``: three kinds, odd, float4 and
     0-d leaves, fp32 within ``ATOL`` / ``RTOL`` and bf16;
   * ``flash_attention_cuda``: fp32 and bf16, D = 64 / 128 / 256, GQA
     groups 1 / 2 / 8, causal with window 0 and 128 and non-causal,
     L = 1 / 17 / 200 / 1024, within ``FLASH_TOL``;
3. the DEPOSITUM path: ``ROUNDS`` rounds of the paper's Fig. 4 MLP (123 ->
   64 -> 32 -> 10, 10 clients on a ring, T0 = 10, MCP prox) through
   ``repro_torch.quickstart.run_depositum`` with ``fused="require"``; each
   sweep kernel launches exactly rounds x T0 x 6 leaves times, stationarity
   falls from round 1, and the run matches the same run with
   ``fused="off"``: one round within ``STEP_ATOL`` / ``STEP_RTOL``, all
   rounds within ``STATE_REL`` (model, relative norm) and ``LOSS_RTOL`` /
   ``STAT_RTOL``;
4. the prox tree path: ``ops.prox_tree`` and ``ops.fused_update_tree`` over
   that run's final model (six leaves), one launch a leaf each, against the
   plain versions;
5. the served path at full width: ``qwen3-1.7b`` (28 layers, d 2048, 16/8
   heads of 128, d_ff 6144, vocab 151936, bf16, untied; random weights from
   a seeded generator on the card) through ``BatchedServer`` with B = 4,
   a 1024-token prompt, 32 greedy tokens and a 2048-slot cache: flash
   launches exactly once per layer, every logit is finite, and the prefill
   logits match the same prefill with ``flash_attention_plain`` swapped in
   within ``SERVE_LOGIT_ATOL`` / ``SERVE_LOGIT_RTOL``; prints prefill ms,
   decode ms a token, tokens/s and the peak memory of the ``generate``
   call (``torch.cuda.max_memory_allocated``);
6. card against CPU: reduced ``qwen3-1.7b`` and reduced ``starcoder2-7b``,
   fp32, identical weights, served on the card and on the CPU (plain
   versions there): identical greedy tokens, logits within 1e-4;
7. time each kernel (CUDA events) against its plain version, its bound and
   (flash) ``scaled_dot_product_attention``, at its path's shapes and at a
   larger one, and the DEPOSITUM round wall time fused and unfused.

Before each path (phases 3, 4, 5) every launch count is set to 0; it is
read just after.  Prints JSON lines per phase, then the card's name and
power limit (from ``nvidia-smi``), then one ``{"kernels": [...]}`` line,
then as the last line ``{"ok": true, "device": {...}}``.  Exits non-zero
with no result when CUDA is unavailable or the port's sources are not
beside the script.
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
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
BF16_FLOPS_PER_S = 989e12      # H100 SXM bf16 dense, tensor cores
# flash kernel vs plain: blockwise online softmax sums in another order
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# full-width prefill, flash vs plain attention: both compute the attention
# in fp32 and round it to bf16, so an element may differ by one bf16 ulp
# (2^-8 relative); 28 bf16 layers carry that into the logits (std ~1)
SERVE_LOGIT_ATOL, SERVE_LOGIT_RTOL = 0.1, 0.05
CPU_ATOL = CPU_RTOL = 1e-4     # card vs CPU, fp32 reduced models
SERVE = {"arch": "qwen3-1.7b", "batch": 4, "prompt": 1024, "new": 32,
         "cache": 2048}


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
    """Both nvcc runs started together (one thread each), then loaded."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.prox import kernel as prox
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        paths = list(pool.map(lambda m: m.build_library(), (prox, flash)))
    prox._lib()
    flash._lib()
    ptxas = [ln.split(":", 1)[-1].strip()
             for ln in paths[1].with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    return {"phase": "build",
            "libraries": [str(p.relative_to(ROOT)) for p in paths],
            "seconds": time.perf_counter() - t0, "flash_ptxas": ptxas}


def _modules():
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.prox import kernel as prox
    return prox, flash


def reset_counts() -> None:
    for m in _modules():
        m.reset_launch_counts()


def read_counts() -> dict:
    """Every kernel's launch count, under the names of the kernels line."""
    prox, flash = _modules()
    return {"fused_update_sweep": prox.LAUNCH_COUNTS["fused_sweep"],
            "fused_tracking_sweep": prox.LAUNCH_COUNTS["tracking_sweep"],
            "prox": prox.LAUNCH_COUNTS["prox"],
            "fused_update": prox.LAUNCH_COUNTS["fused_update"],
            "flash_attention": flash.LAUNCH_COUNTS["flash_fwd"]}


def expect_counts(path: str, counts: dict, want: dict) -> None:
    """Each kernel launched exactly ``want[name]`` times (0 if absent)."""
    for name, n in counts.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, want "
                                 f"{want.get(name, 0)}")


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


def phase_check_prox() -> dict:
    """prox_cuda and fused_update_cuda against their plain versions."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    g = torch.Generator(device="cuda").manual_seed(17)
    hp = dict(lam=1e-3, theta=4.0, alpha=0.1)
    worst = {"prox": 0.0, "fused_update": 0.0}
    cases = 0
    for shape, dtype in (((1001,), torch.float32), ((64, 130), torch.float32),
                         ((), torch.float32), ((3, 333), torch.bfloat16)):
        x, y, nu = ((torch.randn(shape, generator=g, device="cuda") * 0.01)
                    .to(dtype) for _ in range(3))
        for kind in ("l1", "mcp", "scad"):
            pairs = {"prox": ((K.prox_cuda(x, kind=kind, **hp),),
                              (K.prox_plain(x, kind=kind, **hp),)),
                     "fused_update": (
                         K.fused_update_cuda(x, y, nu, kind=kind, gamma=0.8,
                                             **hp),
                         K.fused_update_plain(x, y, nu, kind=kind, gamma=0.8,
                                              **hp))}
            torch.cuda.synchronize()
            for name, (outs, refs) in pairs.items():
                for out, ref in zip(outs, refs):
                    atol, rtol = ((ATOL, RTOL) if dtype == torch.float32
                                  else (BF16_ATOL, BF16_RTOL))
                    torch.testing.assert_close(
                        out, ref, atol=atol, rtol=rtol,
                        msg=lambda m: f"{name} {kind} {shape}: {m}")
                    if dtype == torch.float32:
                        worst[name] = max(worst[name], float(
                            (out - ref).abs().max()))
            cases += 1
    return {"phase": "check_prox", "cases": cases, "max_abs_err": worst,
            "atol": ATOL, "rtol": RTOL}


def phase_check_flash() -> dict:
    """flash_attention_cuda against flash_attention_plain over dtypes, head
    dims, GQA groups, masks and lengths (B = 2, 8 query heads)."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as F
    g = torch.Generator(device="cuda").manual_seed(23)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    cases = 0
    H = 8
    for D in (64, 128, 256):
        for group in (1, 2, 8):
            for L in (1, 17, 200, 1024):
                q32 = torch.randn((2, L, H, D), generator=g, device="cuda")
                k32, v32 = (torch.randn((2, L, H // group, D), generator=g,
                                        device="cuda") for _ in range(2))
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = (t.to(dtype) for t in (q32, k32, v32))
                    name = str(dtype).split(".")[-1]
                    for causal, window in ((True, 0), (True, 128),
                                           (False, 0)):
                        out = F.flash_attention_cuda(q, k, v, causal=causal,
                                                     window=window)
                        ref = F.flash_attention_plain(q, k, v, causal=causal,
                                                      window=window)
                        torch.cuda.synchronize()
                        tol = FLASH_TOL[name]
                        torch.testing.assert_close(
                            out, ref, atol=tol, rtol=tol,
                            msg=lambda m: (f"flash D={D} group={group} L={L} "
                                           f"{name} causal={causal} "
                                           f"window={window}: {m}"))
                        worst[name] = max(worst[name], float(
                            (out.float() - ref.float()).abs().max()))
                        cases += 1
    return {"phase": "check_flash", "cases": cases, "max_abs_err": worst,
            "tol": FLASH_TOL}


def phase_main_path():
    import torch
    from repro_torch.convert import state_to_numpy
    from repro_torch.quickstart import mlp_config, run_depositum

    cfg = mlp_config(ROUNDS, fused="require")
    reset_counts()
    state, curves = run_depositum(cfg, metrics_every=ROUNDS, device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    want = ROUNDS * cfg.depositum.comm_period * LEAVES
    expect_counts("depositum path", launches, {"fused_update_sweep": want,
                                               "fused_tracking_sweep": want})

    off_cfg = mlp_config(ROUNDS, fused="off")
    reset_counts()
    ref_state, ref_curves = run_depositum(off_cfg, metrics_every=ROUNDS,
                                          device="cuda")
    torch.cuda.synchronize()
    expect_counts("fused='off'", read_counts(), {})
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
    return state, launches, {
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


def phase_tree_path(state) -> tuple[dict, dict]:
    """ops.prox_tree / ops.fused_update_tree over the DEPOSITUM run's final
    model (six (10, ...) leaves) with the Fig. 4 hyperparameters."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    from repro_torch.kernels.prox import ops
    hp = dict(kind="mcp", lam=1e-4, alpha=0.05, theta=4.0)
    reset_counts()
    px = ops.prox_tree(state.x, **hp)
    ux, unu = ops.fused_update_tree(state.x, state.y, state.nu, gamma=0.8,
                                    **hp)
    torch.cuda.synchronize()
    launches = read_counts()
    expect_counts("prox tree path", launches,
                  {"prox": LEAVES, "fused_update": LEAVES})
    worst = {"prox": 0.0, "fused_update": 0.0}
    for k in state.x:
        rp = K.prox_plain(state.x[k], **hp)
        rx, rn = K.fused_update_plain(state.x[k], state.y[k], state.nu[k],
                                      gamma=0.8, **hp)
        for name, out, ref in (("prox", px[k], rp),
                               ("fused_update", ux[k], rx),
                               ("fused_update", unu[k], rn)):
            torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL,
                                       msg=lambda m: f"{name} {k}: {m}")
            worst[name] = max(worst[name], float((out - ref).abs().max()))
    shapes = {k: list(v.shape) for k, v in state.x.items()}
    return launches, {"phase": "tree_path", "leaf_shapes": shapes,
                      "launches": launches, "max_abs_err": worst}


def phase_serve() -> tuple[dict, dict]:
    """Full-width qwen3-1.7b through BatchedServer (prefill + greedy decode)."""
    import torch
    import repro_torch.models.attention as attention_mod
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as F
    from repro_torch.models import build_model
    from repro_torch.models.common import pad_vocab
    from repro_torch.serving import BatchedServer, ServeConfig

    cfg = get_config(SERVE["arch"])
    B, Lp, new = SERVE["batch"], SERVE["prompt"], SERVE["new"]
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params, _ = model.init(seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (B, Lp), generator=gen,
                            device="cuda")
    srv = BatchedServer(model, params, ServeConfig(
        max_new_tokens=new, cache_capacity=SERVE["cache"]))
    with torch.inference_mode():
        srv.prefill(prompts)               # warm-up: cuBLAS, allocator
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks = srv.generate(prompts)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expect_counts("served path", launches, {"flash_attention": cfg.n_layers})
    if toks.shape != (B, new) or not bool(
            ((toks >= 0) & (toks < pad_vocab(cfg.vocab_size))).all()):
        raise AssertionError(f"served tokens bad: {tuple(toks.shape)}")

    with torch.inference_mode():
        logits, cache = srv.prefill(prompts)
        prefill_ms = time_ms(lambda: srv.prefill(prompts), iters=5, warmup=1)
        step_logits, step_toks = [], []

        # decode writes its keys in place at slots Lp.. of the prefill's
        # cache; a repeat writes the same values, and slots past a step's
        # position are masked, so each repeat decodes the same tokens
        def decode_all():
            lg, c = logits, cache
            step_logits.clear()
            step_toks.clear()
            for _ in range(new - 1):
                nxt = torch.argmax(lg[:, -1].float(), dim=-1)
                lg, c = model.forward_decode(params, {"tokens": nxt[:, None]},
                                             c)
                step_logits.append(lg)
                step_toks.append(nxt)
        decode_ms = time_ms(decode_all, iters=3, warmup=1) / (new - 1)
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(lg).all()) for lg in step_logits)
        if not finite:
            raise AssertionError("served logits are not all finite")
        if not torch.equal(torch.stack(step_toks, 1), toks[:, :new - 1]):
            raise AssertionError("the timed decode loop and generate() chose "
                                 "different tokens")
        # the same prefill with the plain attention swapped in
        swapped = attention_mod.flash_attention
        attention_mod.flash_attention = F.flash_attention_plain
        try:
            plain_logits, _ = srv.prefill(prompts)
        finally:
            attention_mod.flash_attention = swapped
        torch.cuda.synchronize()
    diff = (logits.float() - plain_logits.float()).abs()
    torch.testing.assert_close(logits.float(), plain_logits.float(),
                               atol=SERVE_LOGIT_ATOL, rtol=SERVE_LOGIT_RTOL,
                               msg=lambda m: f"prefill flash vs plain: {m}")
    top1 = float((logits.argmax(-1) == plain_logits.argmax(-1))
                 .float().mean())
    return launches, {
        "phase": "serve", "arch": cfg.name, "layers": cfg.n_layers,
        "params": n_params, "dtype": cfg.dtype, "batch": B,
        "prompt_len": Lp, "new_tokens": new, "cache": SERVE["cache"],
        "init_s": init_s, "launches": launches,
        "generate_s": generate_s, "tokens_per_s": B * new / generate_s,
        "prefill_ms": prefill_ms, "decode_ms_per_token": decode_ms,
        "max_memory_allocated_gb": peak_gb,
        "prefill_flash_vs_plain_max_abs": float(diff.max()),
        "prefill_logits_max_abs": float(logits.float().abs().max()),
        "prefill_top1_agreement": top1,
        "logit_atol": SERVE_LOGIT_ATOL, "logit_rtol": SERVE_LOGIT_RTOL,
        "sample": toks[0, :8].tolist()}


def _teacher_forced_logits(model, params, prompts, toks, cap):
    """Prefill logits, then the decode logits fed ``toks`` one at a time."""
    import torch
    with torch.inference_mode():
        lg, cache = model.forward_prefill(params, {"tokens": prompts}, cap)
        out = [lg]
        for t in range(toks.shape[1] - 1):
            lg, cache = model.forward_decode(
                params, {"tokens": toks[:, t:t + 1]}, cache)
            out.append(lg)
    return torch.cat(out, dim=1)


def phase_card_vs_cpu() -> dict:
    """Reduced qwen3 and starcoder2 in fp32, the same weights on the card
    and on the CPU: identical greedy tokens, logits within 1e-4."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import BatchedServer, ServeConfig
    out = {}
    for arch, cap in (("qwen3-1.7b", 128), ("starcoder2-7b", 64)):
        cfg = get_config(arch, reduced=True)
        prompts = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (2, 80)))
        params, _ = build_model(cfg, device="cpu").init(seed=3)
        toks, logits = {}, {}
        reset_counts()
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            p = params.to(dev)
            toks[dev] = BatchedServer(model, p, ServeConfig(
                max_new_tokens=8, cache_capacity=cap)).generate(prompts).cpu()
            logits[dev] = _teacher_forced_logits(
                model, p, prompts.to(dev), toks[dev].to(dev), cap).cpu()
        expect_counts(f"{arch} card vs cpu", read_counts(),
                      {"flash_attention": 2 * cfg.n_layers})
        if not torch.equal(toks["cpu"], toks["cuda"]):
            raise AssertionError(f"{arch}: greedy tokens differ card vs cpu: "
                                 f"{toks['cuda'].tolist()} vs "
                                 f"{toks['cpu'].tolist()}")
        torch.testing.assert_close(logits["cuda"], logits["cpu"],
                                   atol=CPU_ATOL, rtol=CPU_RTOL,
                                   msg=lambda m: f"{arch} logits: {m}")
        out[arch] = {"prompt": list(prompts.shape), "cache": cap,
                     "window": cfg.sliding_window,
                     "tokens": toks["cuda"][0].tolist(),
                     "max_abs_logit_diff": float(
                         (logits["cuda"] - logits["cpu"]).abs().max())}
    return {"phase": "card_vs_cpu", "atol": CPU_ATOL, "rtol": CPU_RTOL, **out}


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


def phase_timing_prox(state) -> dict:
    """prox_cuda / fused_update_cuda vs plain at the tree path's shapes (the
    six leaves, one call each) and at one bandwidth-bound leaf."""
    import torch
    from repro_torch.kernels.prox import kernel as K
    hp = dict(kind="mcp", lam=1e-4, alpha=0.05, theta=4.0)
    g = torch.Generator(device="cuda").manual_seed(29)
    big = [torch.randn(1 << 26, generator=g, device="cuda") * 0.01
           for _ in range(3)]
    out = {}
    for label, leaves in (
            ("tree_path", [(state.x[k], state.y[k], state.nu[k])
                           for k in state.x]),
            ("bandwidth", [tuple(big)])):
        n_elem = sum(x.numel() for x, _, _ in leaves)

        def run(fn):
            return [fn(x, y, nu) for x, y, nu in leaves]

        fns = {"prox": (
            lambda: run(lambda x, y, nu: (K.prox_cuda(x, **hp),)),
            lambda: run(lambda x, y, nu: (K.prox_plain(x, **hp),))),
            "fused_update": (
            lambda: run(lambda x, y, nu: K.fused_update_cuda(
                x, y, nu, gamma=0.8, **hp)),
            lambda: run(lambda x, y, nu: K.fused_update_plain(
                x, y, nu, gamma=0.8, **hp)))}

        def max_err(fk, fp):
            def err():
                a, b = fk(), fp()
                pairs = [(u, v) for pa, pb in zip(a, b)
                         for u, v in zip(pa, pb)]
                for u, v in pairs:
                    torch.testing.assert_close(
                        u, v, atol=ATOL, rtol=RTOL,
                        msg=lambda m: f"{label} timing shapes: {m}")
                return max(float((u - v).abs().max()) for u, v in pairs)
            return err

        entry = {"leaf_shapes": [list(x.shape) for x, _, _ in leaves],
                 "launches_per_call": len(leaves)}
        for name, (fk, fp) in fns.items():
            k, p_, e = _time_pair(fk, fp, max_err(fk, fp))
            bpe = 8 if name == "prox" else 5 * 4
            fpe = (UPDATE_FLOPS - 5) if name == "prox" else UPDATE_FLOPS
            b, by = _bound_ms(n_elem, bpe, fpe)
            entry[name] = {"ms": k, "plain_ms": p_, "bound_ms": b,
                           "bound_by": by, "max_abs_err": e}
        out[label] = entry
    del big
    return {"phase": "timing_prox", **out}


def _flash_bound_ms(B, L, H, KV, D, bytes_per_elem):
    """Causal, no window: 4 D flops a visible (i, j) pair and head (QK^T
    and PV), L (L + 1) / 2 pairs; q, k, v read once and o written once."""
    flops = 4.0 * B * H * D * L * (L + 1) / 2
    nbytes = (2 * B * L * H * D + 2 * B * L * KV * D) * bytes_per_elem
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), flops


def phase_timing_flash() -> dict:
    """Flash kernel vs its plain version vs scaled_dot_product_attention
    (enable_gqa), bf16 causal, at the served shape and at L = 8192."""
    import torch
    import torch.nn.functional as TF
    from repro_torch.kernels.flash_attention import kernel as F
    out = {}
    g = torch.Generator(device="cuda").manual_seed(31)
    for label, (B, L, H, KV, D), iters in (
            ("served", (SERVE["batch"], SERVE["prompt"], 16, 8, 128), 20),
            ("long", (1, 8192, 16, 8, 128), 5)):
        q = torch.randn((B, L, H, D), generator=g, device="cuda").bfloat16()
        k, v = (torch.randn((B, L, KV, D), generator=g, device="cuda")
                .bfloat16() for _ in range(2))
        kern = lambda: F.flash_attention_cuda(q, k, v, causal=True)
        plain = lambda: F.flash_attention_plain(q, k, v, causal=True)
        sdpa = lambda: TF.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
        a, b, c = kern(), plain(), sdpa()
        torch.cuda.synchronize()
        tol = FLASH_TOL["bfloat16"]
        for name, o in (("plain", b), ("sdpa", c)):
            torch.testing.assert_close(
                a, o, atol=tol, rtol=tol,
                msg=lambda m: f"flash {label} kernel vs {name}: {m}")
        err = float((a.float() - b.float()).abs().max())
        del a, b, c
        times = {"ms": [], "plain_ms": [], "library_ms": []}
        for name, fn in (("plain_ms", plain), ("ms", kern),
                         ("library_ms", sdpa), ("library_ms", sdpa),
                         ("ms", kern), ("plain_ms", plain)):
            times[name].append(time_ms(fn, iters=iters, warmup=2))
        bound, by, flops = _flash_bound_ms(B, L, H, KV, D, 2)
        out[label] = {"shape": {"B": B, "L": L, "H": H, "KV": KV, "D": D,
                                "dtype": "bfloat16", "causal": True},
                      "ms": min(times["ms"]),
                      "plain_ms": min(times["plain_ms"]),
                      "library_ms": min(times["library_ms"]),
                      "all_ms": times, "bound_ms": bound, "bound_by": by,
                      "tflops_per_s": flops / min(times["ms"]) / 1e9,
                      "max_abs_err": err}
        del q, k, v
        torch.cuda.empty_cache()
    return {"phase": "timing_flash", **out}


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
    check_prox = phase_check_prox()
    emit(check_prox)
    check_flash = phase_check_flash()
    emit(check_flash)
    state, launches, main_path = phase_main_path()
    emit(main_path)
    tree_launches, tree = phase_tree_path(state)
    emit(tree)
    serve_launches, serve = phase_serve()
    emit(serve)
    torch.cuda.empty_cache()
    emit(phase_card_vs_cpu())
    timing = phase_timing()
    emit(timing)
    timing_prox = phase_timing_prox(state)
    emit(timing_prox)
    timing_flash = phase_timing_flash()
    emit(timing_flash)
    emit(phase_round_time())

    step = timing["main_path_step"]
    prox_src = "src/repro/kernels/prox/kernel.py"
    kernels = []
    for name, line in (("fused_update_sweep", 267),
                       ("fused_tracking_sweep", 296)):
        t = step[name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{prox_src}:{line}", "launches": launches[name],
            "max_abs_err": max(check["max_abs_err"][name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    for name, line in (("prox", 123), ("fused_update", 157)):
        t = timing_prox["tree_path"][name]
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"{prox_src}:{line}",
            "launches": tree_launches[name],
            "max_abs_err": max(check_prox["max_abs_err"][name],
                               tree["max_abs_err"][name], t["max_abs_err"]),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None})
    t = timing_flash["served"]
    kernels.append({
        "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
        "launches": serve_launches["flash_attention"],
        "max_abs_err": max(max(check_flash["max_abs_err"].values()),
                           t["max_abs_err"]),
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"]})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
