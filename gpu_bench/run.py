#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 gpu_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).
The cell names a configuration (``gpu_bench/configs/<config>.json``) and
a traffic mix or training job (``gpu_bench/traffic/<traffic>.json``,
whose ``kind`` is ``serve`` or ``train``); each metric of the cell is
read by ``gpu_bench/metrics/<metric>.py``.  With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics, read from a profiled slice of the window.  The last line of
standard output is one JSON object; the last lines of standard error name
each number compared with the reference beside its limit.

``--control 1`` adds the readings of the control (the reference in
float8) and of the planted faults; it is not part of a benchmark run.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules a run must not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load(root: Path, kind: str, name: str) -> dict:
    return json.loads((root / "gpu_bench" / kind / f"{name}.json").read_text())


def reader(root: Path, name: str):
    """The metric's reader module, ``gpu_bench/metrics/<name>.py``."""
    path = root / "gpu_bench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "gpu_bench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(t0: float, msg: str) -> None:
    """One line of progress on standard error, with the seconds since
    ``t0``."""
    print(f"[gpu_bench {time.perf_counter() - t0:8.2f} s] {msg}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_metrics(spec: dict, cell: str, per_layer: bool) -> list:
    """The cell's metrics of one kind, as ``BENCHMARK.json`` lists them."""
    e2e = {m["name"]: m for m in spec["end_to_end"]}

    def in_cell(m):
        return cell in m["workloads"] if "workloads" in m else True

    if not per_layer:
        return [m for m in spec["end_to_end"] if in_cell(m)]
    return [m for m in spec["per_layer"]
            if ("workloads" in m and cell in m["workloads"])
            or ("workloads" not in m and in_cell(e2e[m["moves"]]))]


def compared(check: dict, limits: dict) -> dict:
    """Each number compared with the reference, with its limit: those the
    configuration gives a limit."""
    return {n: {"value": check[n], "limit": lim} for n, lim in limits.items()}


def execute(root: Path, workload: str, seed: int, seconds: int, trace: bool,
            device: str, control: bool = False, t0: float = T0):
    """Run the cell; returns (result line, compared numbers)."""
    import torch

    from gpu_bench import serve, train

    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    config = load(root, "configs", cell["config"])
    mix = load(root, "traffic", cell["traffic"])
    ctx = SimpleNamespace(root=root, config=config, traffic=mix, seed=seed,
                          seconds=seconds, trace=trace, device=device,
                          control=control, window_open=None,
                          scratch=os.path.join(tempfile.gettempdir(),
                                               "gpu_bench"),
                          log=lambda msg: log(t0, msg))
    kind = {"serve": serve, "train": train}[mix["kind"]]
    rec = kind.run(ctx)
    rec["setup_s"] = ctx.window_open - t0
    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        val = reader(root, m["name"]).read(rec)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    check = rec["check"]
    cmp = compared(check, config["check"][mix["kind"]])
    ok = all(c["value"] <= c["limit"] for c in cmp.values())
    if mix["kind"] == "serve":
        w0, w1 = rec["window"]
        due = [r for r in rec["requests"] if w0 <= r["due"] < w1]
        attempted, failed = len(due), sum(r["state"] == "failed" for r in due)
        # a request the engine gave up on is lost, not late
        ok = ok and check["tokens"] > 0 and failed == 0
    else:
        attempted, failed = len(rec["step_ends"]), 0
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": 1, "memory_peak_bytes": int(rec["peak_bytes"])}
    out = {"correct": bool(ok), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if trace and rec.get("trace"):
        from gpu_bench.trace import breakdown

        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = breakdown(rec["trace"])
    if control:
        out["control"] = {k: v for k, v in check.items()
                          if k.startswith(("control", "fault"))}
        out["control"]["program"] = {k: v for k, v in check.items()
                                     if isinstance(v, float)}
        out["readings"] = {k: v for k, v in check.items()
                           if k in ("program", "reference")}
    out["compared"] = cmp
    return out, cmp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every kernel and build cache of the program inside the checkout
    cache = ROOT / "build" / "gpu_bench"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload),
                None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out, cmp = execute(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), "cuda", bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in cmp.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
