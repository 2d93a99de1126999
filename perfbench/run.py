"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell names a configuration
(``perfbench/configs/<config>.json``) and a traffic mix
(``perfbench/traffic/<traffic>.json``); its limits are
``perfbench/limits/<cell>.json`` and each metric is read by
``perfbench/metrics/<metric>.py``; the traffic's ``kind`` picks the module
in ``perfbench/kinds/``.  With ``--trace 0`` the line carries the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics (and a
breakdown of the traced rounds).  The last line of standard output is one
JSON object; the numbers compared for ``correct`` close standard error and
the line.  A run without the cards the cell asks for, or whose process
holds JAX or the JAX package once the window has closed, prints no result
and exits non-zero.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the harness's modules are imported as ``perfbench.*``; its folder on the
# path would shadow the standard library's ``trace``
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402

#: top-level module names the process may not hold (compared whole: the
#: program's own package is ``repro_torch``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """The run cannot give a result here (exit code 2); any other failure
    raises (exit code 1)."""


def load_cell(name: str) -> dict:
    """The cell's entry, configuration, traffic, limits and metric names
    from ``BENCHMARK.json`` and the files named after them."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise Refused(f"no workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return {"cell": cell, "cfg": cfg, "traffic": traffic,
            "limits": limits["limits"],
            "end_to_end": bench["end_to_end"], "per_layer": bench["per_layer"]}


def read_metrics(specs: list, ctx: dict) -> dict:
    """name -> {"value", "unit"} for each metric whose reader finds
    something to read."""
    out = {}
    for m in specs:
        reader = importlib.import_module(f"perfbench.metrics.{m['name']}")
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def prepare_environment():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def context(cfg: dict, traffic: dict, out: dict) -> dict:
    """What a metric reader reads: the run's window, trace, counts
    (``kinds.train.work_counts``), set-up time and peak, and the cell's
    ``model`` block and traffic."""
    ctx = {k: out[k] for k in ("window", "trace", "counts", "setup_s", "peak_bytes")}
    return {**ctx, "model": cfg["model"], "traffic": traffic}


def result_line(cell: dict, out: dict, traced: bool, device: dict) -> dict:
    ctx = context(cell["cfg"], cell["traffic"], out)
    metrics = read_metrics(cell["per_layer"] if traced else cell["end_to_end"], ctx)
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    if traced and out["trace"]:
        t = out["trace"]
        line["device"] = {**device, "busy_s": t["busy_s"], "window_s": t["wall_s"]}
        line["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    line["checks"] = {k: {"value": out["numbers"][k][0], "limit": lim,
                          "at": out["numbers"][k][1]}
                      for k, lim in cell["limits"].items() if k in out["numbers"]}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()
    try:
        cell = load_cell(args.workload)
        import torch

        chips = cell["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise Refused(f"the cell needs {chips} CUDA device(s); "
                          f"{torch.cuda.device_count()} visible")
        torch.set_num_threads(2)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        kind = importlib.import_module(f"perfbench.kinds.{cell['traffic']['kind']}")
        out = kind.run(cell["cfg"], cell["traffic"], cell["limits"], args.seed,
                       args.seconds, bool(args.trace), "cuda", T_START)
    except Refused as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    held = forbidden_modules()
    if held:
        print(f"perfbench: the process holds {held}", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["peak_bytes"]}
    line = result_line(cell, out, bool(args.trace), device)
    print(f"rounds {out['window']['rounds']} in {out['window']['wall_s']:.3f} s; "
          f"round s {[round(w, 3) for w in out['round_s']]}; "
          f"setup {out['setup_s']:.2f} s {out['setup_parts']}; "
          f"reference {out['reference_s']:.2f} s",
          file=sys.stderr)
    for k, v in line["checks"].items():
        ok = math.isfinite(v["value"]) and v["value"] <= v["limit"]
        print(f"check {k} {v['value']:.6g} limit {v['limit']:.6g} at {v['at']} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
