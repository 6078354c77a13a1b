"""Run one cell of the benchmark of eitx_torch and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (imports, the CUDA context, inputs from the seed, warm-up) is timed
from this module's first line to the first timed call. ``--trace 0``
measures the cell's end-to-end metrics over ``--seconds``; ``--trace 1``
runs the cell's ``trace_steps`` calls under torch.profiler with the
benchmark's spans around the program's layers and reports the per-layer
metrics, the device's busy time and the longest operations and idle gaps.
Either way the answers of the timed calls are then compared with the
plain reference, each number beside its limit, as the last lines of
standard error and under ``checks``, the last key of the result, which is
the last line of standard output.

Exits 3 without a result when the card or cards the cell needs are not
there, and 4 when a module of JAX, jaxlib, flax or the JAX package was
loaded (compared by whole top-level names).
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """Build and kernel caches at fixed paths inside the checkout, and no
    JAX pulled in by a library."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark.lib.guard import keep_jax_out

    keep_jax_out(os.environ)


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             variant: str = "sound", t0: float = None) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window (or the traced
    steps), then the comparison. Returns the result without printing it;
    ``variant`` plants a control or a fault (see the drivers)."""
    import torch

    from benchmark.lib import peaks as peak_table
    from benchmark.lib.spans import Spans
    from benchmark.lib.trace import Trace, profile

    t0 = time.perf_counter() if t0 is None else t0
    drv = cell.driver().Driver(cell, seed, device, variant, trace)
    _sync(device)
    setup_s = time.perf_counter() - t0
    work = 0
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
                "count": cell.chips}
    result = {}
    if trace:
        spans = Spans(drv.span_targets(), device)
        with spans, profile(cell.spec["trace_host_ops"]) as prof:
            _sync(device)
            t = time.perf_counter()
            for _ in range(int(cell.spec["trace_steps"])):
                work += drv.step()
            _sync(device)
            window_s = time.perf_counter() - t
        tr = Trace(prof)
        ctx = {"trace": tr, "spans": spans, "window_s": window_s,
               "steps": int(cell.spec["trace_steps"]), "work": work,
               "peaks": peak_table.card_peaks(dev_info["kind"]),
               "layer": drv.layer_context()}
        metrics = {}
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        dev_info["busy_s"] = tr.busy_us() / 1e6
        dev_info["window_s"] = window_s
        result["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    else:
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            work += drv.step()
        _sync(device)
        window_s = time.perf_counter() - t
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        rate = cell.spec["rate_metric"]
        metrics = {"setup_s": {"value": setup_s, "unit": units["setup_s"]},
                   rate: {"value": work / window_s, "unit": units[rate]}}
    dev_info["memory_peak_bytes"] = int(
        torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else 0)
    drv.release()
    numbers = drv.check()
    limits = cell.spec["limits"]
    checks = {k: {"value": numbers.get(k), "limit": limits[k]}
              for k in limits}
    correct = set(numbers) == set(limits) and all(
        numbers[k] <= limits[k] for k in limits)
    return {"correct": bool(correct), "attempted": int(work), "failed": 0,
            "metrics": metrics, "device": dev_info, **result,
            "card": peak_table.card_name_and_limit(), "checks": checks}


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from benchmark.lib.manifest import Cell, manifest

    cell = Cell(args.workload, manifest())
    import torch

    from benchmark.lib.guard import forbidden_modules

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {count}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), t0=_T0)
    bad = forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
